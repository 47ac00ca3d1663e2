"""LiDAR-inertial odometry (counterpart of the JAX package's
`models/lio.py`): IMU static initialization, then per scan an EKF predict
over the scan's IMU packet, IMU motion compensation, registration seeded
by the EKF pose, and the EKF pose update with ZUPT and trail augmentation.

    state', out = step(state, scan, packet, cfg)

Registration goes the way the JAX step picks it (lio.py:138), through the
lidar-only step's trunk: `kiss_icp.register_core_fast` (kernels K2, K1 per
ICP round, K3) when gn_backend="pallas" without a batch unroll, the
classic f64 `kiss_icp.register_core` otherwise. While the static
initialization is open the scan is deskewed at constant velocity (the K2
row's twist on the fast path); after it, by the IMU trail.

Host reads per scan: one of `imu_init.done`, which picks the IMU or the
constant-velocity branch (the JAX `lax.cond`, lio.py:220) and skips the
initialization recursion once it is a no-op; plus those of the
registration (one per ICP round on the fast path, one per GN iteration on
the classic one). The EKF update, the seed on `just_done` and the EKF's
own branches compute both sides and select on the device.

`step_streams` is the same step over a leading stream axis S (the
batched path of `parallel/streams.py`: the classic `register_core` with
the fixed ICP unroll) with no host read: while any stream may still be
initializing it runs both branches on every stream and selects per
stream; once the caller knows from its own count of IMU samples that
every stream is initialized, the IMU branch alone, which gives the same
bits. Spans: `lio.step` holding `imu.init`, `ekf.predict`, `ekf.deskew`,
`kiss_icp.deskew` (the constant-velocity deskew while initializing), the
registration's and `ekf.update`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import imu as imu_ops
from ..ops import lie
from ..ops.preprocess import Scan, to_device
from ..utils.profiling import annotate
from . import ekf as ekf_mod
from . import kiss_icp

F64 = torch.float64
VEL_RING = 8  # CV-phase finite-difference velocity history (accel seed)


class LioState(NamedTuple):
    odo: kiss_icp.KissState  # map + pose history + adaptive threshold
    ekf: ekf_mod.EkfState
    imu_init: imu_ops.ImuInitState
    last_imu: torch.Tensor  # (7,) f64: [t, gyro(3), acc(3)] of previous packet tail
    scan_count: torch.Tensor  # () i32
    vel_ring: torch.Tensor  # (VEL_RING, 3) f64 recent odometry velocities
    vel_ring_n: torch.Tensor  # () i32 valid entries (newest at row -1)
    init_v0: torch.Tensor  # (3,) f64 odometry velocity at init-window start
    init_t0: torch.Tensor  # () f64 its timestamp; -1 = not latched yet


class LioOutput(NamedTuple):
    pose: torch.Tensor  # (4, 4) f64 world-from-lidar at scan end
    ekf_pose: torch.Tensor  # (4, 4) f64 world-from-imu
    velocity: torch.Tensor  # (3,) f64
    keypoints: torch.Tensor  # (S, 3) f32 ICP source (world frame @ guess)
    keypoints_mask: torch.Tensor
    deskewed: torch.Tensor  # (M, 3) f32 map-insert downsample
    deskewed_mask: torch.Tensor
    icp_iterations: torch.Tensor
    num_correspondences: torch.Tensor
    residual_rms: torch.Tensor
    sigma: torch.Tensor
    map_voxels: torch.Tensor  # () i32
    icp_converged: torch.Tensor  # () bool
    window_drops: torch.Tensor  # () i32 downsample-window invalidations
    imu_initialized: torch.Tensor  # () bool
    used_imu: torch.Tensor  # () bool — IMU deskew active this scan
    streams_initialized: torch.Tensor  # () i32 streams whose static init is done
    streams_imu: torch.Tensor  # () i32 streams that took the IMU branch
    guess: torch.Tensor  # (4, 4) f64 the registration's initial guess
    scan_deskewed: torch.Tensor  # (N, 3) f32 the scan's points as registered


def init_state(cfg: PipelineConfig, device: torch.device | str = "cuda",
               streams: int | None = None) -> LioState:
    """A fresh state; with `streams`, S fresh states on a leading axis."""
    lead = () if streams is None else (streams,)
    return LioState(
        odo=kiss_icp.init_state(cfg, device, streams),
        ekf=ekf_mod.init(cfg.ekf, device, streams),
        imu_init=imu_ops.init_state(device, streams),
        last_imu=torch.zeros(lead + (7,), dtype=F64, device=device),
        scan_count=torch.zeros(lead, dtype=torch.int32, device=device),
        vel_ring=torch.zeros(lead + (VEL_RING, 3), dtype=F64, device=device),
        vel_ring_n=torch.zeros(lead, dtype=torch.int32, device=device),
        init_v0=torch.zeros(lead + (3,), dtype=F64, device=device),
        init_t0=torch.full(lead, -1.0, dtype=F64, device=device),
    )


def _ring_accel(ring, n, dt):
    """Least-squares world acceleration from the velocity ring (JAX
    lio.py:88): the slope over the last n (<= VEL_RING) dt-spaced velocities,
    zero until 3 exist. ring (..., VEL_RING, 3), n and dt (...)."""
    m = torch.clamp(n, max=VEL_RING)
    idx = torch.arange(VEL_RING, dtype=F64, device=ring.device)
    w = (idx >= (VEL_RING - m)[..., None]).to(F64)
    t = idx * torch.as_tensor(dt, dtype=F64, device=ring.device)[..., None]
    wsum = torch.clamp(torch.sum(w, -1), min=1.0)
    tbar = torch.sum(w * t, -1) / wsum
    ct = w * (t - tbar[..., None])
    denom = torch.sum(ct * t, -1)
    slope = torch.sum(ct[..., None] * ring, dim=-2) / torch.where(denom > 0, denom, 1.0)[..., None]
    return torch.where(((m >= 3) & (denom > 0))[..., None], slope, 0.0)


def _with_prev_sample(packet: ekf_mod.ImuPacket, last_imu) -> ekf_mod.ImuPacket:
    """Prepend the previous packet's tail sample (reference ekf.cpp:295)."""
    return ekf_mod.ImuPacket(
        time=torch.cat([last_imu[..., 0:1], packet.time], -1),
        gyro=torch.cat([last_imu[..., None, 1:4], packet.gyro], -2),
        acc=torch.cat([last_imu[..., None, 4:7], packet.acc], -2),
        mask=torch.cat([(last_imu[..., 0:1] > 0), packet.mask], -1),
    )


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] along a packet's sample axis, one index i (...) a stream, on
    the device (no host read)."""
    if i.dim() == 0:
        return torch.index_select(x, 0, i.reshape(1))[0]
    a = i.dim()
    idx = i.reshape(i.shape + (1,) * (x.dim() - a)).expand(i.shape + (1,) + x.shape[a + 1:])
    return torch.gather(x, a, idx).squeeze(a)


def _imu_to_lidar(e: ekf_mod.EkfState) -> torch.Tensor:
    m = e.m
    return lie.make_transform(lie.quat_to_rot(m[..., ekf_mod.RIL:ekf_mod.RIL + 4]),
                              m[..., ekf_mod.PIL:ekf_mod.PIL + 3])


def _imu_branch(state: LioState, full: ekf_mod.ImuPacket, scan: Scan, cfg: PipelineConfig):
    """EKF predict over the packet, mean-only hold to scan end, IMU deskew;
    the guess is the EKF pose composed with the imu-lidar transform."""
    e = state.ekf
    p_il = e.m[..., ekf_mod.PIL:ekf_mod.PIL + 3]
    R_il = lie.quat_to_rot(e.m[..., ekf_mod.RIL:ekf_mod.RIL + 4])
    with annotate("ekf.predict"):
        e = ekf_mod.predict_dispatch(e, full, p_il, R_il, cfg.ekf)
        # extrapolate the nominal state to SCAN END (zero-order hold on the
        # last sample, the reference's frame-end extrapolation, ekf.cpp:393-410)
        li = torch.clamp(torch.sum(full.mask, -1) - 1, min=0)
        e = ekf_mod.predict_mean(e, scan.t_end, _take(full.gyro, li), _take(full.acc, li),
                                 e.m[..., ekf_mod.GRAV_I:ekf_mod.GRAV_I + 3], p_il, R_il,
                                 cfg.ekf)
    mean_acc_norm = torch.linalg.norm(state.imu_init.mean_acc, dim=-1)
    with annotate("ekf.deskew"):
        e, deskewed, _ = ekf_mod.motion_compensation_with_imu(
            e, full, scan.xyz, scan.rel_t, scan.mask, mean_acc_norm, scan.t_begin, cfg.ekf)
    return e, deskewed, lie.compose(ekf_mod.pose_matrix(e), _imu_to_lidar(e))


@annotate("lio.step")
def _step(state: LioState, scan: Scan, packet: ekf_mod.ImuPacket, cfg: PipelineConfig,
          form: str, inplace: bool):
    """One LIO step (JAX lio.py:126) in one of three forms: "imu" (every
    stream initialized: the IMU branch alone), "cv" (the constant-velocity
    branch alone, while initializing) or "both" (both branches on every
    stream, each stream taking the IMU branch where its static
    initialization was done before this step). Reads nothing from the
    device beyond the registration's own reads."""
    fast = kiss_icp.is_fast(cfg)
    odo = state.odo
    full = _with_prev_sample(packet, state.last_imu)
    imu, cv = form != "cv", form != "imu"
    used = state.imu_init.done  # per stream: the IMU branch this scan

    # IMU static initialization; once done the recursion is a no-op
    if cv:
        with annotate("imu.init"):
            imu_init_next = imu_ops.accumulate(
                state.imu_init, full.gyro, imu_ops.remap_axes(full.acc, cfg.imu.coordinate),
                full.mask, cfg.imu)
    else:
        imu_init_next = state.imu_init
    just_done = imu_init_next.done & ~state.imu_init.done
    ekf_state = state.ekf  # seeding happens after registration (see below)

    # pre-ICP bookkeeping row (fast path): CV guess, sigma, deskew twist
    pre = kiss_icp.pose_pre_row(odo, cfg) if fast else None
    if imu:
        ekf_imu, desk_imu, guess_imu = _imu_branch(state, full, scan, cfg)
    if cv:
        desk_cv = kiss_icp.constant_velocity_deskew(odo, scan, cfg, pre)
        # on the fast path the K2 row is the guess
        guess_cv = None if fast else kiss_icp.constant_velocity_guess(odo)
    if form == "imu":
        ekf_state, deskewed_xyz, init_guess = ekf_imu, desk_imu, guess_imu
    elif form == "cv":
        deskewed_xyz, init_guess = desk_cv, guess_cv
    else:
        ekf_state = ekf_mod.select(used, ekf_imu, ekf_state)
        deskewed_xyz = torch.where(used[..., None, None], desk_imu, desk_cv)
        init_guess = lie.where_pose(used, guess_imu, guess_cv)

    # registration: the trunk shared with the lidar-only step, with the map
    # and pose bookkeeping
    if fast:
        if init_guess is None:
            guess = pre.row
            init_guess = lie.make_transform(guess[:9].reshape(3, 3), guess[9:12])
        else:
            guess = torch.cat([init_guess[:3, :3].reshape(9), init_guess[:3, 3]])
        new_odo, core = kiss_icp.register_core_fast(odo, deskewed_xyz, scan.mask, guess, cfg,
                                                    pre, tau=scan.tau, inplace=inplace)
    else:
        # the JAX LIO step hands register_core no per-point time
        new_odo, core = kiss_icp.register_core(odo, deskewed_xyz, scan.mask, init_guess, cfg,
                                               inplace=inplace)

    # EKF measurement update + trail maintenance
    if imu:
        with annotate("ekf.update"):
            T_wi = lie.compose(core.pose, lie.transform_inverse(_imu_to_lidar(ekf_state)))
            upd = ekf_mod.lidar_pose_update(ekf_state, T_wi, cfg.ekf.lidar_pos_noise,
                                            cfg.ekf.lidar_ori_noise, cfg.ekf)
            upd = ekf_mod.update_and_propagate(upd, cfg.ekf)
        ekf_state = upd if form == "imu" else ekf_mod.select(used, upd, ekf_state)

    # CV-phase velocity ring (JAX lio.py:274-299): frozen once the EKF runs
    dt_scan = torch.clamp(scan.t_end - scan.t_begin, min=1e-3)
    v_fd = (core.pose[..., :3, 3] - odo.pose[..., :3, 3]) / dt_scan[..., None]
    vel_ring, vel_ring_n = state.vel_ring, state.vel_ring_n
    init_v0, init_t0 = state.init_v0, state.init_t0
    if cv:
        track = odo.num_poses > 0
        if imu:
            track = track & ~used
        vel_ring = torch.where(track[..., None, None],
                               torch.cat([vel_ring[..., 1:, :], v_fd[..., None, :]], -2), vel_ring)
        vel_ring_n = torch.where(track, torch.clamp(vel_ring_n + 1, max=VEL_RING), vel_ring_n)
        latch = track & (init_t0 < 0)
        init_v0 = torch.where(latch[..., None], v_fd, init_v0)
        init_t0 = torch.where(latch, scan.t_end, init_t0)

        # static init completed THIS scan: seed the EKF nominal state from
        # the running odometry (JAX lio.py:301-348), selected on the device
        with annotate("ekf.update"):
            T_il = _imu_to_lidar(ekf_state)
            anchor_pose = core.pose
            if cfg.icp.deskew:
                # the CV odometry anchors at mid-scan; the EKF at scan end
                anchor_pose = anchor_pose.clone()
                anchor_pose[..., :3, 3] += 0.5 * dt_scan[..., None] * v_fd
            T_wi = lie.compose(anchor_pose, lie.transform_inverse(T_il))
            vel = torch.where((odo.num_poses > 0)[..., None], v_fd, 0.0)
            tw = scan.t_end - init_t0
            have_window = (init_t0 >= 0) & (tw > 0.25)
            accel = torch.where(have_window[..., None],
                                (v_fd - init_v0) / torch.clamp(tw, min=1e-3)[..., None],
                                _ring_accel(vel_ring, vel_ring_n, dt_scan))
            seeded = ekf_mod.initialize_from_odometry(
                ekf_state, imu_init_next.mean_acc, T_wi, vel, cfg.ekf, accel_world=accel,
                window_time=torch.clamp(tw, min=0.0))
            ekf_state = ekf_mod.select(just_done, seeded, ekf_state)

    # carry the packet's last valid sample for the next scan
    n_valid = torch.sum(full.mask, -1)
    last = torch.clamp(n_valid - 1, min=0)
    last_imu = torch.cat([_take(full.time, last)[..., None], _take(full.gyro, last),
                          _take(full.acc, last)], -1)
    last_imu = torch.where((n_valid > 0)[..., None], last_imu, state.last_imu)

    new_state = LioState(
        odo=new_odo, ekf=ekf_state, imu_init=imu_init_next, last_imu=last_imu,
        scan_count=state.scan_count + 1, vel_ring=vel_ring, vel_ring_n=vel_ring_n,
        init_v0=init_v0, init_t0=init_t0,
    )
    out = LioOutput(
        **core._asdict(),
        ekf_pose=ekf_mod.pose_matrix(ekf_state),
        velocity=ekf_mod.velocity(ekf_state),
        imu_initialized=imu_init_next.done,
        used_imu=used,
        streams_initialized=torch.sum(imu_init_next.done, dtype=torch.int32),
        streams_imu=torch.sum(used, dtype=torch.int32),
        guess=init_guess,
        scan_deskewed=deskewed_xyz,
    )
    return new_state, out


def step(state: LioState, scan: Scan, packet: ekf_mod.ImuPacket, cfg: PipelineConfig,
         inplace: bool = False):
    """One LIO step of one stream (JAX lio.py:126). Returns (state',
    LioOutput); the passed state is left unchanged unless `inplace` (see
    `step_donated`)."""
    use_imu = bool(state.imu_init.done)  # host read: the branch
    return _step(state, scan, packet, cfg, "imu" if use_imu else "cv", inplace)


def step_donated(state: LioState, scan: Scan, packet: ekf_mod.ImuPacket, cfg: PipelineConfig):
    """`step` that updates the map tables of `state` in place (the analogue
    of the JAX donated step): no copy of the map per scan. The caller must
    not reuse `state` after the call."""
    return step(state, scan, packet, cfg, inplace=True)


def step_streams(state: LioState, scan: Scan, packet: ekf_mod.ImuPacket, cfg: PipelineConfig,
                 imu_ready: bool = False, inplace: bool = False):
    """`step` over a leading stream axis (every leaf of state, scan and
    packet with a leading S), on the classic registration with the fixed
    ICP unroll (`streams.batch_config`), with no host read. `imu_ready`, a
    host-side promise that every stream's static initialization is done,
    runs the IMU branch alone; otherwise both branches run on every stream
    and each stream takes its own. Outputs carry a leading S but for the
    two stream counts."""
    if kiss_icp.is_fast(cfg) or scan.mask.dim() != 2:
        raise ValueError("step_streams takes S streams on the classic fixed-unroll "
                         "registration (streams.batch_config)")
    return _step(state, scan, packet, cfg, "imu" if imu_ready else "both", inplace)


def pack_imu_packet(times, gyros, accs, max_samples: int,
                    device: torch.device | str = "cuda") -> ekf_mod.ImuPacket:
    """Pad per-scan IMU arrays into a packet of `max_samples` on `device`
    (one copy, `preprocess.to_device`)."""
    times = np.asarray(times, np.float64)
    n = times.shape[0]
    if n > max_samples:
        raise ValueError(f"{n} IMU samples > capacity {max_samples}")

    def pad(a):
        out = np.zeros((max_samples,) + a.shape[1:], np.float64)
        out[:n] = a
        return out

    mask = np.zeros(max_samples, bool)
    mask[:n] = True
    return ekf_mod.ImuPacket(*to_device(
        [pad(times), pad(np.asarray(gyros, np.float64).reshape(n, 3)),
         pad(np.asarray(accs, np.float64).reshape(n, 3)), mask], device))

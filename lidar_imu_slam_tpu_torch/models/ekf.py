"""Quaternion error-state EKF, 30-dim inner state + pose trail (counterpart
of the JAX package's `models/ekf.py`; reference src/kalman/ekf.cpp).

State layout (reference ekf.hpp:14-54):
  [0:3] position   [3:6] velocity   [6:10] orientation quat (w, x, y, z)
  [10:13] gyro bias   [13:16] acc bias   [16:19] acc scale   [19:22] gravity
  [22:25] imu-lidar translation   [25:29] imu-lidar quat   [29] time shift
  [30:] a trail of `lidar_pose_trail` 7-dim poses (170 dims at trail 20).

Everything is f64 and runs on the state's device. What differs from the
JAX module, and why:
* `lax.cond` sites (the predict skip, the ZUPT gate, the stationary
  branch) compute both sides and select with `torch.where`: no host read,
  and a NaN on the side not taken (a Cholesky of a matrix that is not
  positive definite) cannot reach the result.
* The unrolled Cholesky (`chol_solve_unrolled`) is `cholesky_ex` with two
  triangular solves; where the matrix is not positive definite the
  solution is NaN, as the unrolled factor's sqrt of a negative pivot gives.
* `lax.associative_scan` over the 4x4 quaternion propagators and over the
  (Phi, Sigma) transition pairs is a log-depth Hillis-Steele scan: another
  order of products, so results move at ~1e-15.
* The batched deskew picks each point's trail row by a gather of its
  interval index in place of the JAX one-hot sum (exact for finite rows),
  and zeroes the masked IMU pairs before they enter the propagators (the
  JAX form relies on finite padding; 0 * inf would be NaN). On the card
  its per-point pass is one kernel (`kernels/imu_deskew`), bit-equal to
  the plain pass (`deskew_points_plain`) that the CPU runs.
* `_sincos_poly`, `matmul_nowhile` and `precise.exp_` lower f64 on a TPU:
  here torch.sin / cos / exp and plain matmuls.
Constant matrices are built once per device (`_consts`): a Python scalar
written into a CUDA tensor is a host copy that waits for the device.

Every function the LIO step reaches takes an optional leading stream axis
S (`init(cfg, device, streams=S)`: m (S, D), P (S, D, D), each scalar
(S,); a packet's leaves (S, M, ...)): indexing on the last axes, batched
products, per-stream selects. A call without the axis computes what it
computed before, op for op. With the axis, the packet's covariance
transitions are folded in sample order (`_fold_transitions`) in place of
the log-depth scan: over (S, M, 30, 30) the scan moves ~log2(M) times the
bytes of the fold (a pairwise tree measured ~9 ms slower a step at 4096
streams on an H100: its odd levels copy their strided halves).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import GRAVITY, EkfConfig
from ..ops import lie
from ..ops.kernels import imu_deskew
from ..ops.kernels._common import on_cpu

F64 = torch.float64
F32 = torch.float32

# state layout offsets (reference ekf.hpp:32-54)
POS, VEL, ORI, BGA, BAA, BAT, GRAV_I, PIL, RIL, SFT = (
    0, 3, 6, 10, 13, 16, 19, 22, 25, 29,
)
INNER = 30
POSE_DIM = 7
# process noise layout (reference ekf.hpp:56-60)
Q_ACC, Q_GYRO, Q_BGA, Q_BAA, Q_DIM = 0, 3, 6, 9, 12


class EkfState(NamedTuple):
    m: torch.Tensor  # (D,) f64 mean
    P: torch.Tensor  # (D, D) f64 covariance
    time: torch.Tensor  # () f64 — seconds since first sample
    first_sample_t: torch.Tensor  # () f64
    prev_sample_t: torch.Tensor  # () f64
    first_sample: torch.Tensor  # () bool
    zupt_time: torch.Tensor  # () f64 last ZUPT (time-origin relative)
    was_stationary: torch.Tensor  # () bool
    augment_count: torch.Tensor  # () i32
    last_lidar_end_time: torch.Tensor  # () f64
    orientation_initialized: torch.Tensor  # () bool


class ImuPacket(NamedTuple):
    """Padded per-scan IMU sub-buffer. Element 0 must be the previous
    packet's last sample (the reference prepends mc_tracker->last_imu,
    ekf.cpp:295)."""

    time: torch.Tensor  # (M,) f64 absolute seconds
    gyro: torch.Tensor  # (M, 3) f64
    acc: torch.Tensor  # (M, 3) f64
    mask: torch.Tensor  # (M,) bool


def _per_stream(cond: torch.Tensor, ndim: int) -> torch.Tensor:
    """cond (...) reshaped to broadcast over a leaf of `ndim` dims whose
    leading dims are cond's (a per-stream select)."""
    return cond.reshape(cond.shape + (1,) * (ndim - cond.dim()))


def select(cond: torch.Tensor, a, b):
    """Field-wise torch.where(cond, a, b) over two NamedTuples of tensors;
    cond (...) is one flag per stream of a leading stream axis (or 0-d)."""
    return type(a)(*(torch.where(_per_stream(cond, x.dim()), x, y) for x, y in zip(a, b)))


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x over leading axes: (..., n, k) by (..., k) -> (..., n); a 1-D x
    is the plain product."""
    return A @ x if x.dim() == 1 else (A @ x[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b) if a.dim() == 1 else torch.sum(a * b, dim=-1)


@functools.lru_cache(maxsize=None)
def _consts_cached(cfg: EkfConfig, device: str) -> dict:
    d = cfg.state_dim
    ns = cfg.noise_scale * cfg.noise_scale
    c = {}
    c["eye3"], c["eye4"] = np.eye(3), np.eye(4)
    c["up"] = np.array([0.0, 0.0, 1.0])
    c["ori_block"] = np.diag([1.0, 1.0, 1.0, 0.0])
    # d(quat)/d(gyro noise) structure at h = 1 (ekf.cpp:554-560)
    c["dS"] = np.array([
        [[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 0, 1], [0, 0, -1, 0]],
        [[0, 0, 1, 0], [0, 0, 0, -1], [-1, 0, 0, 0], [0, 1, 0, 0]],
        [[0, 0, 0, 1], [0, 0, 1, 0], [0, -1, 0, 0], [-1, 0, 0, 0]],
    ], np.float64)
    # ZUPT: H selects the velocity of m[:6]
    h = np.zeros((3, VEL + 3))
    h[:, VEL:VEL + 3] = np.eye(3)
    c["H_zupt"] = h
    c["R_zupt"] = np.eye(3) * cfg.visual_zupt_r * ns
    # trail augmentation (visAugH, ekf.cpp:161-177)
    h = np.zeros((POSE_DIM, d))
    for i in range(3):
        h[i, POS + i], h[i, INNER + i] = 1.0, -1.0
    for i in range(4):
        h[3 + i, ORI + i], h[3 + i, INNER + 3 + i] = 1.0, -1.0
    c["H_aug"] = h
    c["R_aug"] = np.eye(POSE_DIM) * 1e-9 * ns
    q = np.zeros(d)
    q[INNER:INNER + 3] = cfg.init_pos_trail_noise ** 2
    q[INNER + 3:INNER + POSE_DIM] = cfg.init_ori_trail_noise ** 2
    c["Q_aug"] = np.diag(q * ns)
    c["eye_d"] = np.eye(d)
    # lidar pose measurement: H selects POS and ORI of m[:10]
    h = np.zeros((7, ORI + 4))
    for i in range(3):
        h[i, POS + i] = 1.0
    for i in range(4):
        h[3 + i, ORI + i] = 1.0
    c["H_pose"] = h
    out = {k: torch.as_tensor(v, dtype=F64, device=device) for k, v in c.items()}
    # index maps of the trail shifts (-1: the slot is zeroed)
    aug = np.arange(d)
    for i in range(INNER, d):
        aug[i] = i - POSE_DIM if i - POSE_DIM >= INNER else -1
    aug[INNER:INNER + POSE_DIM] = -1
    unaug = np.arange(d)
    for i in range(INNER, d):
        unaug[i] = i + POSE_DIM if i + POSE_DIM < d else -1
    for name, perm in (("aug", aug), ("unaug", unaug)):
        p = torch.as_tensor(perm, device=device)
        out[f"{name}_idx"] = torch.clamp(p, min=0)
        out[f"{name}_keep"] = (p >= 0).to(F64)
    return out


def _consts(cfg: EkfConfig, device: torch.device) -> dict:
    return _consts_cached(cfg, str(torch.device(device)))


def chol_solve(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with S X = B for SPD S (n, n), B (n, k); NaN everywhere when S is
    not positive definite (the JAX unrolled factor's sqrt of a negative
    pivot). No host sync: `cholesky_ex` reports failure in a device tensor."""
    L, info = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return torch.where((info == 0)[..., None, None], x, torch.full_like(x, float("nan")))


def _process_covariance(cfg: EkfConfig, noise_scale: float, device) -> torch.Tensor:
    """Initial covariance (reference initialize_process_covariance,
    ekf.cpp:580-617)."""
    diag = np.zeros(cfg.state_dim)
    diag[POS:POS + 3] = cfg.init_pos_noise ** 2
    diag[VEL:VEL + 3] = cfg.init_vel_noise ** 2
    diag[ORI:ORI + 4] = 1.0
    diag[BGA:BGA + 3] = cfg.init_bga_noise ** 2
    diag[BAA:BAA + 3] = cfg.init_baa_noise ** 2
    diag[BAT:BAT + 3] = cfg.init_bat_noise ** 2
    # quirk preserved: the reference seeds the gravity block with the
    # lidar-imu time noise (ekf.cpp:595)
    diag[GRAV_I:GRAV_I + 3] = cfg.init_lidar_imu_time_noise ** 2
    diag[PIL:PIL + 3] = cfg.init_pos_noise ** 2
    diag[RIL:RIL + 4] = 1.0
    diag[SFT] = cfg.init_lidar_imu_time_noise ** 2
    diag[INNER:] = np.tile(
        np.concatenate([np.full(3, cfg.init_pos_trail_noise ** 2),
                        np.full(4, cfg.init_ori_trail_noise ** 2)]),
        cfg.lidar_pose_trail)
    return torch.as_tensor(np.diag(diag), dtype=F64, device=device) * noise_scale


def init(cfg: EkfConfig, device: torch.device | str = "cuda",
         streams: int | None = None) -> EkfState:
    """A fresh state; with `streams`, S fresh states on a leading axis."""
    lead = () if streams is None else (streams,)
    m = np.zeros(cfg.state_dim)
    m[ORI] = m[RIL] = 1.0
    m[BAT:BAT + 3] = 1.0
    m[GRAV_I:GRAV_I + 3] = [0.0, 0.0, -GRAVITY]
    noise_scale = cfg.noise_scale * cfg.noise_scale  # reference ekf.cpp:66

    def scalar(v, dtype=F64):  # a fill on the device, not a host copy
        return torch.full(lead, v, dtype=dtype, device=device)

    def rows(x):
        return x.expand(lead + x.shape).clone() if lead else x

    return EkfState(
        m=rows(torch.as_tensor(m, dtype=F64, device=device)),
        P=rows(_process_covariance(cfg, noise_scale, device)),
        time=scalar(0.0),
        first_sample_t=scalar(0.0),
        prev_sample_t=scalar(-1.0),
        first_sample=scalar(True, torch.bool),
        zupt_time=scalar(-1.0),
        was_stationary=scalar(False, torch.bool),
        augment_count=scalar(0, torch.int32),
        last_lidar_end_time=scalar(0.0),
        orientation_initialized=scalar(False, torch.bool),
    )


def _true_like(t: torch.Tensor) -> torch.Tensor:
    """True for each stream of a (..., D) mean."""
    return torch.ones(t.shape[:-1], dtype=torch.bool, device=t.device)


def initialize_gravity_alignment(state: EkfState, mean_acc, cfg: EkfConfig) -> EkfState:
    """Gravity-aligned orientation init (intent of reference ekf.cpp:194-211):
    R(q) maps world up onto the mean specific force, gravity along world -z
    with calc_grav's magnitude (imu/frame.cpp:114)."""
    c = _consts(cfg, state.m.device)
    calc_grav = -mean_acc / torch.linalg.norm(mean_acc, dim=-1, keepdim=True) * GRAVITY
    q = lie.quat_from_two_vectors(c["up"], mean_acc)
    m = state.m.clone()
    m[..., ORI:ORI + 4] = q
    m[..., GRAV_I:GRAV_I + 3] = -c["up"] * torch.linalg.norm(calc_grav, dim=-1, keepdim=True)
    noise_scale = cfg.noise_scale * cfg.noise_scale
    P = state.P.clone()
    P[..., ORI:ORI + 4, ORI:ORI + 4] = c["ori_block"] * (cfg.init_ori_noise ** 2) * noise_scale
    return state._replace(m=m, P=P, orientation_initialized=_true_like(m))


def initialize_from_odometry(state: EkfState, mean_acc, T_wi, vel_world, cfg: EkfConfig,
                             accel_world=None, window_time=None) -> EkfState:
    """`initialize_gravity_alignment` for an init that completes IN MOTION,
    seeded from the running lidar odometry (JAX ekf.py:149, PARITY.md #26):
    pose from `T_wi`, velocity from the odometry, gravity from the mean
    specific force (corrected by `accel_world` when given); at rest
    (|vel| <= 0.25 m/s) exactly the gravity-alignment init, position pinned
    to the odometry frame. Priors tighten when the init window was >= 1 s."""
    c = _consts(cfg, state.m.device)
    moving = torch.linalg.norm(vel_world, dim=-1) > 0.25
    mv = moving[..., None]
    R_wb = T_wi[..., :3, :3]
    mean_dir = mean_acc / torch.linalg.norm(mean_acc, dim=-1, keepdim=True)
    q_align = lie.quat_from_two_vectors(c["up"], mean_acc)
    q = torch.where(mv, lie.rot_to_quat(R_wb.transpose(-1, -2)), q_align)
    g_world = torch.where(mv, -_mv(R_wb, mean_dir) * GRAVITY, -c["up"] * GRAVITY)
    if accel_world is not None:
        g_est = accel_world - _mv(R_wb, mean_acc)
        g_norm = torch.linalg.norm(g_est, dim=-1, keepdim=True)
        g_world = torch.where(mv & (g_norm > 0.5 * GRAVITY),
                              g_est / torch.clamp(g_norm, min=1e-9) * GRAVITY, g_world)
    m = state.m.clone()
    m[..., ORI:ORI + 4] = q
    m[..., POS:POS + 3] = T_wi[..., :3, 3]
    m[..., VEL:VEL + 3] = torch.where(mv, vel_world, state.m[..., VEL:VEL + 3])
    m[..., GRAV_I:GRAV_I + 3] = g_world
    noise_scale = cfg.noise_scale * cfg.noise_scale
    trusted = moving if window_time is None else moving & (window_time >= 1.0)

    def f64(v):  # a where of two Python floats would be float32
        return torch.full((), v, dtype=F64, device=m.device)

    ori_var = torch.where(trusted, 0.02 ** 2,
                          torch.where(moving, 0.2 ** 2, f64(cfg.init_ori_noise ** 2)))
    P = state.P.clone()
    P[..., ORI:ORI + 4, ORI:ORI + 4] = c["ori_block"] * ori_var[..., None, None] * noise_scale
    vidx = torch.arange(VEL, VEL + 3, device=m.device)
    gidx = torch.arange(GRAV_I, GRAV_I + 3, device=m.device)
    tr = trusted[..., None]
    P[..., vidx, vidx] = (torch.where(mv, torch.where(tr, 0.3 ** 2, f64(1.0)),
                                      state.P[..., vidx, vidx])
                          * torch.where(mv, noise_scale, f64(1.0)))
    P[..., gidx, gidx] = torch.where(mv, torch.where(tr, 1.0, f64(9.0)) * noise_scale,
                                     state.P[..., gidx, gidx])
    return state._replace(m=m, P=P, orientation_initialized=_true_like(m))


def _ou_q(cfg: EkfConfig, dt: torch.Tensor, noise_scale: float) -> torch.Tensor:
    """Process noise with Ornstein-Uhlenbeck bias scaling (reference
    ekf.cpp:112-116, 244-263); dt (...) -> (..., 12, 12)."""
    return torch.diag_embed(_ou_q_diag(cfg, dt, noise_scale))


def _ou_q_diag(cfg: EkfConfig, dt: torch.Tensor, noise_scale: float) -> torch.Tensor:
    """The diagonal (..., 12) of `_ou_q`."""

    def ou(qc, theta):
        if theta > 0.0:
            return qc * (1.0 - torch.exp(-2.0 * dt * theta)) / (2.0 * theta)
        return torch.full_like(dt, qc)

    def full(v):
        return torch.full_like(dt, v)

    zero = torch.zeros_like(dt)
    gyro2, acc2 = cfg.gyro_process_noise ** 2, cfg.acc_process_noise ** 2
    bga = ou(gyro2, cfg.gyro_process_noise_rev) if cfg.gyro_process_noise > 0.0 else zero
    baa = ou(acc2, cfg.acc_process_noise_rev) if cfg.acc_process_noise > 0.0 else zero
    q = torch.stack([full(acc2)] * 3 + [full(gyro2)] * 3 + [bga] * 3 + [baa] * 3, dim=-1)
    return q * noise_scale


def _bias_decay(dt, rate: float):
    return torch.exp(-dt * rate) if rate > 0.0 else torch.ones_like(dt)


def _propagate_mean(m, A, R, rot_li, trans_li, dt, calc_grav, xa, cfg: EkfConfig):
    """Mean propagation (reference propagate_state, ekf.cpp:486-519)."""
    T_ab = m[..., BAT:BAT + 3] * xa - m[..., BAA:BAA + 3]
    prev_quat = m[..., ORI:ORI + 4]
    dtv = dt[..., None]
    m2 = torch.cat([
        m[..., POS:POS + 3] + m[..., VEL:VEL + 3] * dtv,
        m[..., VEL:VEL + 3] + (_mv(R.transpose(-1, -2), T_ab) + m[..., GRAV_I:GRAV_I + 3]) * dtv,
        _mv(A, prev_quat),
        m[..., BGA:BGA + 3] * _bias_decay(dtv, cfg.gyro_process_noise),
        m[..., BAA:BAA + 3] * _bias_decay(dtv, cfg.acc_process_noise_rev),
        m[..., BAT:BAT + 3],
        calc_grav,
        trans_li,
        lie.rot_to_quat(rot_li),
        m[..., SFT:],
    ], dim=-1)
    return m2, T_ab, prev_quat


def _state_jacobians(T_ab, prev_quat, A, R, dR, xa, dt, dS):
    """Fx (..., 30, 30) and Fw (..., 30, 12) (reference
    initialize_state_jacobians, ekf.cpp:521-578), over leading batch dims;
    with the d(vel)/d(grav) = dt I coupling the reference omits (PARITY.md
    #27). `dS` is the (3, 4, 4) gyro-noise structure at h = 1."""
    lead = T_ab.shape[:-1]
    dev = T_ab.device
    dtm = dt[..., None, None]
    eye3 = torch.eye(3, dtype=F64, device=dev)
    Fx = torch.zeros(lead + (INNER, INNER), dtype=F64, device=dev)
    Fw = torch.zeros(lead + (INNER, Q_DIM), dtype=F64, device=dev)
    for blk in (POS, VEL, BGA, BAA, BAT, GRAV_I, PIL):
        Fx[..., blk:blk + 3, blk:blk + 3] = eye3
    Fx[..., RIL:RIL + 4, RIL:RIL + 4] = torch.eye(4, dtype=F64, device=dev)
    Fx[..., SFT, SFT].fill_(1.0)  # a fill: a scalar written to a 0-d view is a host copy
    Fx[..., POS:POS + 3, VEL:VEL + 3] = eye3 * dtm
    Fx[..., VEL:VEL + 3, GRAV_I:GRAV_I + 3] = eye3 * dtm

    RT = R.transpose(-1, -2)
    dv_dq = torch.einsum("...qji,...j->...iq", dR, T_ab) * dtm  # (..., 3, 4)
    dv_dq = dv_dq @ A
    Fx[..., VEL:VEL + 3, ORI:ORI + 4] = dv_dq
    Fx[..., ORI:ORI + 4, ORI:ORI + 4] = A
    Fw[..., VEL:VEL + 3, Q_ACC:Q_ACC + 3] = RT * dtm

    h = (dt / 2.0)[..., None, None, None]
    dq_dw = torch.einsum("...ab,...gbc,...c->...ag", A, dS * h, prev_quat)  # (..., 4, 3)
    Fw[..., ORI:ORI + 4, Q_GYRO:Q_GYRO + 3] = dq_dw
    Fw[..., BGA:BGA + 3, Q_BGA:Q_BGA + 3] = eye3
    Fw[..., BAA:BAA + 3, Q_BAA:Q_BAA + 3] = eye3

    dv_dw = dv_dq @ dq_dw
    Fw[..., VEL:VEL + 3, Q_GYRO:Q_GYRO + 3] = dv_dw
    Fx[..., VEL:VEL + 3, BGA:BGA + 3] = -dv_dw
    Fx[..., ORI:ORI + 4, BGA:BGA + 3] = -dq_dw
    Fx[..., VEL:VEL + 3, BAA:BAA + 3] = -RT * dtm
    Fx[..., VEL:VEL + 3, BAT:BAT + 3] = RT * xa[..., None, :] * dtm
    return Fx, Fw


def _block_cov_propagate(P, Fx, FwQFw):
    """P update exploiting the trail's sparsity (reference ekf.cpp:284-289):
    only the 30x30 block and the 30-wide cross strips change."""
    P2 = P.clone()
    FxT = Fx.transpose(-1, -2)
    P2[..., :INNER, :INNER] = Fx @ P[..., :INNER, :INNER] @ FxT + FwQFw
    P2[..., INNER:, :INNER] = P[..., INNER:, :INNER] @ FxT
    P2[..., :INNER, INNER:] = Fx @ P[..., :INNER, INNER:]
    return P2


def _time_update(state: EkfState, t):
    dt = torch.where(state.first_sample, 0.0, t - state.prev_sample_t)
    new_time = torch.where(state.first_sample, state.time, t - state.first_sample_t)
    first_sample_t = torch.where(state.first_sample, t, state.first_sample_t)
    return dt, dict(time=new_time, first_sample_t=first_sample_t, prev_sample_t=t,
                    first_sample=torch.zeros_like(state.first_sample))


def predict(state: EkfState, t, xg, xa, calc_grav, trans_lidar_imu, rot_lidar_imu,
            cfg: EkfConfig) -> EkfState:
    """Forward propagation over one IMU sample (reference EKF::predict,
    ekf.cpp:214-290); skipped (m, P unchanged) when dt <= 0."""
    noise_scale = cfg.noise_scale * cfg.noise_scale
    dt, times = _time_update(state, t)
    m = state.m
    Q = _ou_q(cfg, dt, noise_scale)
    A = lie.quat_propagator(xg - m[..., BGA:BGA + 3], dt)
    q_next = _mv(A, m[..., ORI:ORI + 4])
    R = lie.quat_to_rot(q_next)
    dR = lie.dquat_to_rot(q_next)
    m2, T_ab, prev_quat = _propagate_mean(m, A, R, rot_lidar_imu, trans_lidar_imu, dt,
                                          calc_grav, xa, cfg)
    Fx, Fw = _state_jacobians(T_ab, prev_quat, A, R, dR, xa, dt,
                              _consts(cfg, m.device)["dS"])
    P2 = _block_cov_propagate(state.P, Fx, Fw @ Q @ Fw.transpose(-1, -2))
    skip = dt <= 0.0  # reference ekf.cpp:235-240
    return state._replace(m=torch.where(_per_stream(skip, m.dim()), m, m2),
                          P=torch.where(_per_stream(skip, P2.dim()), state.P, P2), **times)


def predict_mean(state: EkfState, t, xg, xa, calc_grav, trans_lidar_imu, rot_lidar_imu,
                 cfg: EkfConfig) -> EkfState:
    """Mean-only forward extrapolation: `predict` without the covariance (the
    reference's frame-end extrapolation semantics, ekf.cpp:393-410)."""
    dt, times = _time_update(state, t)
    m = state.m
    A = lie.quat_propagator(xg - m[..., BGA:BGA + 3], dt)
    R = lie.quat_to_rot(_mv(A, m[..., ORI:ORI + 4]))
    m2, _, _ = _propagate_mean(m, A, R, rot_lidar_imu, trans_lidar_imu, dt, calc_grav, xa, cfg)
    return state._replace(m=torch.where(_per_stream(dt <= 0.0, m.dim()), m, m2), **times)


def normalize_quaternions(state: EkfState, cfg: EkfConfig, only_current: bool = False) -> EkfState:
    """Reference ekf.cpp:619-634."""
    m = state.m.clone()
    m[..., ORI:ORI + 4] = lie.quat_normalize(state.m[..., ORI:ORI + 4])
    m[..., RIL:RIL + 4] = lie.quat_normalize(state.m[..., RIL:RIL + 4])
    if not only_current:
        trail = m[..., INNER:].view(m.shape[:-1] + (cfg.lidar_pose_trail, POSE_DIM))
        quats = trail[..., 3:7]
        norms = torch.linalg.norm(quats, dim=-1, keepdim=True)
        big = norms > 1e-12
        trail[..., 3:7] = torch.where(
            big, quats / torch.where(big, norms, torch.ones_like(norms)), quats)
    return state._replace(m=m)


def maintain_positive_semi_definite(state: EkfState) -> EkfState:
    """Symmetry projection (reference ekf.cpp:758-764)."""
    return state._replace(P=0.5 * (state.P + state.P.transpose(-1, -2)))


def kalman_update(m, P, y, H, Rn):
    """m, P <- Kalman update with measurement y = H m[:l] + noise, H (n, l)
    with l <= D (reference update, ekf.cpp:36-60): Cholesky innovation
    solve, P -= K H P. NaN throughout when the innovation covariance is not
    positive definite."""
    l = H.shape[-1]
    HP = H @ P[..., :l, :]  # (..., n, D)
    S = Rn + HP[..., :l] @ H.transpose(-1, -2)
    K = chol_solve(S, HP).transpose(-1, -2)  # (..., D, n)
    v = y - _mv(H, m[..., :l])
    return m + _mv(K, v), P - K @ HP


def _joseph_update(P, H_full, Rn, K, eye):
    """Joseph form (reference update_common_joseph_form, ekf.cpp:20-34)."""
    IKH = eye - K @ H_full
    return IKH @ P @ IKH.transpose(-1, -2) + K @ Rn @ K.transpose(-1, -2)


def zero_vel_update(state: EkfState, cfg: EkfConfig) -> EkfState:
    """ZUPT, rate-limited to 4 Hz (reference ekf.cpp:657-678)."""
    c = _consts(cfg, state.m.device)
    gate = (state.time - state.zupt_time) >= cfg.zupt_min_interval
    m2, P2 = kalman_update(state.m, state.P, torch.zeros_like(state.m[..., :3]), c["H_zupt"],
                           c["R_zupt"])
    state = state._replace(
        m=torch.where(gate[..., None], m2, state.m),
        P=torch.where(gate[..., None, None], P2, state.P),
        zupt_time=torch.where(gate, state.time, state.zupt_time),
        was_stationary=state.was_stationary | gate,
    )
    return normalize_quaternions(state, cfg, only_current=True)


def _apply_perm(m, P, idx, keep):
    """m' = A m, P' = A P A^T for a 0/1 selection matrix A given as an index
    map (`keep` zeroes the slots whose source is -1)."""
    P2 = torch.index_select(torch.index_select(P, -2, idx), -1, idx)
    return torch.index_select(m, -1, idx) * keep, P2 * (keep[:, None] * keep[None, :])


def update_visual_pose_aug(state: EkfState, cfg: EkfConfig) -> EkfState:
    """Augment the trail with the current pose (reference ekf.cpp:700-734):
    shift the trail (dropping the oldest pose), add trail noise on slot 0,
    then a tight Kalman update pinning slot 0 to the current pos / ori."""
    c = _consts(cfg, state.m.device)
    m, P = _apply_perm(state.m, state.P, c["aug_idx"], c["aug_keep"])
    P = P + c["Q_aug"]
    H, Rn = c["H_aug"], c["R_aug"]
    HP = H @ P
    K = chol_solve(Rn + HP @ H.T, HP).transpose(-1, -2)
    m = m + _mv(K, -_mv(H, m))
    P = _joseph_update(P, H, Rn, K, c["eye_d"])
    state = state._replace(m=m, P=P, augment_count=torch.clamp(
        state.augment_count + 1, max=cfg.lidar_pose_trail))
    return normalize_quaternions(maintain_positive_semi_definite(state), cfg)


def update_undo_augmentation(state: EkfState, cfg: EkfConfig) -> EkfState:
    """Drop the newest trail pose (reference ekf.cpp:736-756)."""
    c = _consts(cfg, state.m.device)
    m, P = _apply_perm(state.m, state.P, c["unaug_idx"], c["unaug_keep"])
    state = state._replace(m=m, P=P, augment_count=torch.clamp(state.augment_count - 1, min=0))
    return normalize_quaternions(maintain_positive_semi_definite(state), cfg)


def update_and_propagate(state: EkfState, cfg: EkfConfig) -> EkfState:
    """ZUPT when stationary, then trail augmentation (reference
    ekf.cpp:680-698). Both sides of the stationary branch are computed and
    selected (no host read)."""
    stationary = (torch.abs(torch.linalg.norm(state.m[..., VEL:VEL + 3], dim=-1))
                  < cfg.zupt_speed_threshold)
    still = update_undo_augmentation(zero_vel_update(state, cfg), cfg)
    return update_visual_pose_aug(select(stationary, still, state), cfg)


def predict_over_packet(state: EkfState, packet: ImuPacket, trans_lidar_imu, rot_lidar_imu,
                        cfg: EkfConfig) -> EkfState:
    """`predict` for every sample of the packet in turn, each followed by the
    current-quaternion renormalization; masked samples leave the state as
    it is (the reference's per-sample semantics)."""
    calc_grav = state.m[..., GRAV_I:GRAV_I + 3]
    for i in range(packet.mask.shape[-1]):
        s2 = predict(state, packet.time[..., i], packet.gyro[..., i, :], packet.acc[..., i, :],
                     calc_grav, trans_lidar_imu, rot_lidar_imu, cfg)
        s2 = normalize_quaternions(s2, cfg, only_current=True)
        state = select(packet.mask[..., i], s2, state)
    return state


def _prefix_products(A: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """out[k] = A[k] @ ... @ A[0] for A (..., N, n, n), by a log-depth
    Hillis-Steele scan (the JAX associative_scan's order differs); `mm`
    multiplies two stacks of matrices."""
    d = 1
    while d < A.shape[-3]:
        A = torch.cat([A[..., :d, :, :], mm(A[..., d:, :, :], A[..., :-d, :, :])], dim=-3)
        d *= 2
    return A


def _small_mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for stacks of small matrices, as a broadcast product summed
    over the shared axis. cuBLAS runs a batched f64 product of 4 x 4
    matrices on a 32 x 32 tile each: over the IMU trail's (4096, 64) stack
    a call took ~0.44 ms on an H100, against ~0.13 ms this way."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], -2)


def _small_mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x over leading axes, (..., n, k) by (..., k) -> (..., n), as
    `_small_mm` computes it; a 1-D x is the plain product, as in `_mv`."""
    return A @ x if x.dim() == 1 else torch.sum(A * x[..., None, :], -1)


def _apply_chain(A: torch.Tensor, q0: torch.Tensor) -> torch.Tensor:
    """A[k] q0 for every k: A (..., N, 4, 4), q0 (..., 4) -> (..., N, 4)."""
    return A @ q0 if q0.dim() == 1 else (A @ q0[..., None, :, None])[..., 0]


def _compose_transitions(Phi: torch.Tensor, Sig: torch.Tensor):
    """The composition of N covariance transitions (Phi_k, Sigma_k) (N, n,
    n), applied in order: (Phi_N ... Phi_1, the accumulated noise).
    Log-depth scan of (b o a) = (Pb Pa, Pb Sa Pb^T + Sb)."""
    d = 1
    while d < Phi.shape[0]:
        Pa, Sa, Pb, Sb = Phi[:-d], Sig[:-d], Phi[d:], Sig[d:]
        Phi = torch.cat([Phi[:d], Pb @ Pa])
        Sig = torch.cat([Sig[:d], Pb @ Sa @ Pb.transpose(-1, -2) + Sb])
        d *= 2
    return Phi[-1], Sig[-1]


def _fold_transitions(Phi: torch.Tensor, Sig: torch.Tensor):
    """`_compose_transitions` over a leading stream axis, (S, N, n, n), as a
    fold in sample order: the same composition, other rounding."""
    P, S = Phi[:, 0], Sig[:, 0]
    for k in range(1, Phi.shape[1]):
        Pk = Phi[:, k]
        P = Pk @ P
        S = Pk @ S @ Pk.transpose(-1, -2) + Sig[:, k]
    return P, S


def predict_over_packet_batched(state: EkfState, packet: ImuPacket, trans_lidar_imu,
                                rot_lidar_imu, cfg: EkfConfig) -> EkfState:
    """Batched `predict_over_packet` (JAX ekf.py:970): closed-form bias
    decay, one batched propagator build and a log-depth product chain for
    the orientation, prefix sums for velocity / position, batched Fx / Fw
    and ONE application of the composed covariance transition. Masked
    samples and duplicate timestamps are exact identity transitions (their
    samples are zeroed first); dt < 0 clamps to 0."""
    m, P = state.m, state.P
    t, ok = packet.time, packet.mask
    calc_grav = m[..., GRAV_I:GRAV_I + 3]
    noise_scale = cfg.noise_scale * cfg.noise_scale
    c = _consts(cfg, m.device)

    # per-sample dt (masked samples and duplicates -> dt = 0)
    NEG = -1e30
    tv = torch.where(ok, t, NEG)
    prev_valid = torch.cummax(torch.cat([torch.full_like(tv[..., :1], NEG), tv[..., :-1]], -1),
                              -1).values
    start_prev = torch.where(state.first_sample, NEG, state.prev_sample_t)
    prev_t = torch.maximum(prev_valid, start_prev[..., None])
    dt = torch.where(ok & (prev_t > 0.5 * NEG), t - prev_t, 0.0)
    dt = torch.clamp(dt, min=0.0)
    cumdt = torch.cumsum(dt, -1)
    cd_prev = cumdt - dt

    # closed-form bias decay (pre-sample values)
    g_rate = cfg.gyro_process_noise if cfg.gyro_process_noise > 0.0 else 0.0
    a_rate = cfg.acc_process_noise_rev if cfg.acc_process_noise_rev > 0.0 else 0.0
    bga_pre = m[..., None, BGA:BGA + 3] * torch.exp(-g_rate * cd_prev)[..., None]
    baa_pre = m[..., None, BAA:BAA + 3] * torch.exp(-a_rate * cd_prev)[..., None]
    gyro = torch.where(ok[..., None], packet.gyro, 0.0)
    acc = torch.where(ok[..., None], packet.acc, 0.0)

    # orientation chain
    A = lie.quat_propagator(gyro - bga_pre, dt)  # (..., N, 4, 4), orthogonal
    q0 = m[..., ORI:ORI + 4]
    q_raw = _apply_chain(_prefix_products(A), q0)
    q = q_raw / torch.linalg.norm(q_raw, dim=-1, keepdim=True)
    prev_q = torch.cat([q0[..., None, :], q[..., :-1, :]], -2)
    R = lie.quat_to_rot(q)
    dR = lie.dquat_to_rot(q)

    # velocity / position prefix sums
    T_ab = m[..., None, BAT:BAT + 3] * acc - baa_pre
    RtT = (R.transpose(-1, -2) @ T_ab[..., None])[..., 0]
    vel0 = m[..., None, VEL:VEL + 3]
    vel = vel0 + torch.cumsum((RtT + calc_grav[..., None, :]) * dt[..., None], -2)
    vel_prev = torch.cat([vel0, vel[..., :-1, :]], -2)
    pos = m[..., None, POS:POS + 3] + torch.cumsum(vel_prev * dt[..., None], -2)

    # batched Jacobians, one composed covariance transition
    Fx, Fw = _state_jacobians(T_ab, prev_q, A, R, dR, acc, dt, c["dS"])
    # Fw Q with Q diagonal: the same products, no (N, 12, 12) matrix
    FwQFw = (Fw * _ou_q_diag(cfg, dt, noise_scale)[..., None, :]) @ Fw.transpose(-1, -2)
    # dt = 0 is an exact identity transition (no phantom OU noise)
    FwQFw = torch.where((dt > 0.0)[..., None, None], FwQFw, 0.0)
    compose = _compose_transitions if m.dim() == 1 else _fold_transitions
    PhiN, SigN = compose(Fx, FwQFw)
    P2 = _block_cov_propagate(P, PhiN, SigN)

    m2 = torch.cat([
        pos[..., -1, :], vel[..., -1, :], q[..., -1, :],
        m[..., BGA:BGA + 3] * torch.exp(-g_rate * cumdt[..., -1:]),
        m[..., BAA:BAA + 3] * torch.exp(-a_rate * cumdt[..., -1:]),
        m[..., BAT:BAT + 3], calc_grav, trans_lidar_imu, lie.rot_to_quat(rot_lidar_imu),
        m[..., SFT:],
    ], -1)

    # bookkeeping
    any_valid = torch.any(ok, -1)
    n_valid = torch.sum(ok, -1)
    last_t = torch.amax(tv, -1)
    first_valid_t = torch.gather(t, -1, torch.argmax(ok.to(torch.int32), -1, keepdim=True))[..., 0]
    fst = torch.where(state.first_sample & any_valid, first_valid_t, state.first_sample_t)
    keep_old_time = (~any_valid) | (state.first_sample & (n_valid < 2))
    new = state._replace(
        m=m2, P=P2,
        time=torch.where(keep_old_time, state.time, last_t - fst),
        first_sample_t=fst,
        prev_sample_t=torch.where(any_valid, last_t, state.prev_sample_t),
        first_sample=state.first_sample & ~any_valid,
    )
    # an all-masked packet leaves the state untouched
    return select(any_valid, new, state)


def predict_dispatch(state: EkfState, packet: ImuPacket, trans_lidar_imu, rot_lidar_imu,
                     cfg: EkfConfig) -> EkfState:
    """Config-selected predict: batched (default) or the sequential
    per-sample walk."""
    fn = predict_over_packet_batched if cfg.batched_predict else predict_over_packet
    return fn(state, packet, trans_lidar_imu, rot_lidar_imu, cfg)


def lidar_pose_update(state: EkfState, pose, pos_noise, ori_noise, cfg: EkfConfig) -> EkfState:
    """Absolute pose measurement update from scan registration (JAX
    ekf.py:1114): y = [t; q], H selecting POS and ORI, Cholesky innovation
    solve, quaternion renormalization."""
    c = _consts(cfg, state.m.device)
    # state quaternion is world->body; the pose's rotation is body->world
    q_meas = lie.rot_to_quat(pose[..., :3, :3].transpose(-1, -2))
    q_cur = state.m[..., ORI:ORI + 4]
    q_meas = torch.where((_dot(q_meas, q_cur) < 0)[..., None], -q_meas, q_meas)
    y = torch.cat([pose[..., :3, 3], q_meas], -1)
    noise_scale = cfg.noise_scale * cfg.noise_scale
    Rn = torch.diag_embed(torch.cat([torch.full_like(y[..., :3], pos_noise ** 2),
                                     torch.full_like(y[..., 3:], ori_noise ** 2)], -1))
    Rn = Rn * noise_scale
    m, P = kalman_update(state.m, state.P, y, c["H_pose"], Rn)
    state = maintain_positive_semi_definite(state._replace(m=m, P=P))
    return normalize_quaternions(state, cfg, only_current=True)


# accessors (reference ekf.cpp:766-795)


def position(state: EkfState) -> torch.Tensor:
    return state.m[..., POS:POS + 3]


def velocity(state: EkfState) -> torch.Tensor:
    return state.m[..., VEL:VEL + 3]


def orientation(state: EkfState) -> torch.Tensor:
    return state.m[..., ORI:ORI + 4]


def speed(state: EkfState) -> torch.Tensor:
    return torch.linalg.norm(state.m[..., VEL:VEL + 3], dim=-1)


def pose_matrix(state: EkfState) -> torch.Tensor:
    """Current (..., 4, 4) world-from-imu transform (the filter quaternion is
    world->body, so the rotation is transposed)."""
    return lie.make_transform(lie.quat_to_rot(orientation(state)).transpose(-1, -2),
                              position(state))


# ---------------------------------------------------------------------------
# IMU motion compensation (reference motion_compensation_with_imu,
# ekf.cpp:292-469)
# ---------------------------------------------------------------------------


def _trail_sequential(q0, vel0, pos0, head_t, tail_t, g_mid, a_mid, valid_pair, lle, bga, bat,
                      baa, grav, mean_acc_norm, pcl_beg_time):
    """The reference's pair walk (ekf.cpp:315-391), one IMU pair at a time."""
    quat, vel, pos = q0, vel0, pos0
    rec = {k: [] for k in ("offset", "acc", "gyr", "vel", "pos", "rot")}
    for i in range(valid_pair.shape[-1]):
        vp, h, tt = valid_pair[..., i], head_t[..., i], tail_t[..., i]
        ok = vp & (tt >= lle)  # ekf.cpp:322-323
        dt = torch.where(h < lle, tt - lle, tt - h)
        dt = torch.where(ok, dt, 0.0)
        # the sign-flipped propagator runs the trail body->world
        # (ekf.cpp:372-375); the velocity update uses rot directly
        quat_n = lie.quat_normalize(_mv(lie.quat_propagator(g_mid[..., i, :] - bga, -dt), quat))
        rot = lie.quat_to_rot(quat_n)
        xa = a_mid[..., i, :] / mean_acc_norm[..., None] * GRAVITY  # unit-gravity scaling
        vel_n = vel + (_mv(rot, bat * xa - baa) + grav) * dt[..., None]
        pos_n = pos + vel_n * dt[..., None]
        okv = ok[..., None]
        quat = torch.where(okv, quat_n, quat)
        vel = torch.where(okv, vel_n, vel)
        pos = torch.where(okv, pos_n, pos)
        rec["offset"].append(torch.where(
            vp, torch.where(ok, torch.clamp(tt - pcl_beg_time, min=0.0), 0.0), float("inf")))
        rec["acc"].append(xa)
        rec["gyr"].append(g_mid[..., i, :])
        rec["vel"].append(vel)
        rec["pos"].append(pos)
        rec["rot"].append(lie.quat_to_rot(quat))
    axis = {"offset": -1, "acc": -2, "gyr": -2, "vel": -2, "pos": -2, "rot": -3}
    return quat, vel, pos, {k: torch.stack(v, axis[k]) for k, v in rec.items()}


def _trail_batched(q0, vel0, pos0, head_t, tail_t, g_mid, a_mid, valid_pair, lle, bga, bat,
                   baa, grav, mean_acc_norm, pcl_beg_time):
    """The same trail as one product chain plus prefix sums (JAX
    batched_deskew): skipped pairs are dt = 0 identity transitions, and the
    masked pairs' samples are zeroed before they enter. Its small products
    are broadcast sums (`_small_mm`), not batched GEMMs."""
    lle_p = lle[..., None]
    ok = valid_pair & (tail_t >= lle_p)
    dt = torch.where(head_t < lle_p, tail_t - lle_p, tail_t - head_t)
    dt = torch.where(ok, dt, 0.0)
    g = torch.where(valid_pair[..., None], g_mid, 0.0)
    a = torch.where(valid_pair[..., None], a_mid, 0.0)
    A = _prefix_products(lie.quat_propagator(g - bga[..., None, :], -dt), _small_mm)
    q_raw = _small_mv(A, q0 if q0.dim() == 1 else q0[..., None, :])
    quat = q_raw / torch.linalg.norm(q_raw, dim=-1, keepdim=True)
    rot = lie.quat_to_rot(quat)
    xa = a / mean_acc_norm[..., None, None] * GRAVITY
    dv = _small_mv(rot, bat[..., None, :] * xa - baa[..., None, :]) + grav[..., None, :]
    vel = vel0[..., None, :] + torch.cumsum(dv * dt[..., None], -2)
    pos = pos0[..., None, :] + torch.cumsum(vel * dt[..., None], -2)
    offset = torch.where(valid_pair,
                         torch.where(ok, torch.clamp(tail_t - pcl_beg_time[..., None], min=0.0),
                                     0.0),
                         float("inf"))
    trail = dict(offset=offset, acc=xa, gyr=g_mid, vel=vel, pos=pos, rot=rot)
    return quat[..., -1, :], vel[..., -1, :], pos[..., -1, :], trail


def _rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i, :] for one index a stream: x (..., M, k), i (...)."""
    return torch.gather(x, -2, i[..., None, None].expand(i.shape + (1, x.shape[-1])))[..., 0, :]


def imu_trail(state: EkfState, packet: ImuPacket, rel_t, pts_mask, mean_acc_norm,
              pcl_beg_time, cfg: EkfConfig):
    """The per-stream half of `motion_compensation_with_imu`: the IMU pose
    trail (the sequential pair walk, or with `cfg.batched_deskew` the
    product chain) and its extrapolation to the scan end (ekf.cpp:393-410).
    Returns (pcl_end_time, diagnostics, the per-point pass's per-stream
    terms (offsets, table, t_il, pos_lidar_end, rot_end), all f32: see
    `deskew_points`)."""
    m = state.m
    lead = m.shape[:-1]
    bga, bat, baa = m[..., BGA:BGA + 3], m[..., BAT:BAT + 3], m[..., BAA:BAA + 3]
    grav, t_il = m[..., GRAV_I:GRAV_I + 3], m[..., PIL:PIL + 3]
    lle = state.last_lidar_end_time

    last_rel = torch.amax(torch.where(pts_mask, rel_t.to(F32), 0.0), -1).to(F64)
    pcl_end_time = pcl_beg_time + last_rel
    imu_t = packet.time
    valid_pair = packet.mask[..., :-1] & packet.mask[..., 1:]
    imu_end_time = torch.amax(torch.where(packet.mask, imu_t, float("-inf")), -1)

    # the filter quaternion is world->body; the trail runs body->world
    q0 = lie.quat_conj(m[..., ORI:ORI + 4])
    vel0, pos0 = m[..., VEL:VEL + 3], m[..., POS:POS + 3]
    g_mid = 0.5 * (packet.gyro[..., :-1, :] + packet.gyro[..., 1:, :])
    a_mid = 0.5 * (packet.acc[..., :-1, :] + packet.acc[..., 1:, :])
    walk = _trail_batched if cfg.batched_deskew else _trail_sequential
    quat_f, vel_f, pos_f, trail = walk(q0, vel0, pos0, imu_t[..., :-1], imu_t[..., 1:], g_mid,
                                       a_mid, valid_pair, lle, bga, bat, baa, grav,
                                       mean_acc_norm, pcl_beg_time)

    # frame-end extrapolation (ekf.cpp:393-410; |pcl_end - imu_end| as in
    # the reference)
    n_pairs = torch.clamp(torch.sum(valid_pair, -1), min=1)
    last_g = _rows(g_mid, n_pairs - 1)
    last_a = _rows(a_mid, n_pairs - 1) / mean_acc_norm[..., None] * GRAVITY
    dt_end = torch.abs(pcl_end_time - imu_end_time)
    A_end = lie.quat_propagator(last_g - bga, -dt_end)
    rot_end = lie.quat_to_rot(lie.quat_normalize(_small_mv(A_end, quat_f)))
    vel_end = vel_f + (_small_mv(rot_end, bat * last_a - baa) + grav) * dt_end[..., None]
    pos_end = pos_f + vel_end * dt_end[..., None]
    pos_lidar_end = _small_mv(rot_end, t_il) + pos_end

    # the head entry 0 is the state at scan begin (populate_imu_pose(0.0),
    # ekf.cpp:307)
    zero3 = torch.zeros_like(vel0)
    offsets = torch.cat([torch.zeros_like(trail["offset"][..., :1]), trail["offset"]],
                        -1).to(F32)
    table = torch.cat([
        torch.cat([lie.quat_to_rot(q0).reshape(lead + (1, 9)),
                   trail["rot"].reshape(lead + (-1, 9))], -2),
        torch.cat([zero3[..., None, :], trail["gyr"]], -2),
        torch.cat([pos0[..., None, :], trail["pos"]], -2),
        torch.cat([vel0[..., None, :], trail["vel"]], -2),
        torch.cat([zero3[..., None, :], trail["acc"]], -2),
    ], dim=-1).to(F32)  # (..., M, 21)
    diag = dict(vel_end=vel_end, pos_end=pos_end, rot_end=rot_end, n_pairs=n_pairs)
    terms = (offsets, table, t_il.to(F32), pos_lidar_end.to(F32), rot_end.to(F32))
    return pcl_end_time, diag, terms


def deskew_points_plain(points, rel_t, pts_mask, offsets, table, t_il, pos_lidar_end, rot_end):
    """Plain PyTorch version of `deskew_points` (any device; the CPU path,
    and the card's tests' yardstick)."""
    # interval search and the in-interval offset in f32 (a scan period
    # resolves to ~6 ns)
    lead = points.shape[:-2]
    rel32 = rel_t.to(F32)
    k = torch.clamp(torch.searchsorted(offsets, rel32, side="left") - 1, 0,
                    offsets.shape[-1] - 1)
    off0 = torch.where(torch.isfinite(offsets), offsets, 0.0)
    if lead:  # (21, ..., N), each column contiguous: one trail row per point
        rows = table.movedim(-1, 0).contiguous()
        cols = torch.gather(rows, -1, k.expand((rows.shape[0],) + k.shape))
        dtp = rel32 - torch.gather(off0, -1, k)
    else:
        cols = torch.index_select(table, 0, k).T
        dtp = rel32 - torch.index_select(off0, 0, k)
    R00, R01, R02, R10, R11, R12, R20, R21, R22, gx, gy, gz = cols[:12]

    wx, wy, wz = gx * dtp, gy * dtp, gz * dtp
    sq = wx * wx + wy * wy + wz * wz  # |w| <= |gyr| * scan period << 1
    small = sq < 1e-12
    th = torch.sqrt(torch.where(small, 1.0, sq))
    sinc = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
    cos_t = torch.where(small, 1.0 - 0.5 * sq, torch.cos(th))
    # (1 - cos th) / th^2 = sinc(th / 2)^2 / 2, free of f32 cancellation
    half = torch.where(small, 1.0, torch.sin(0.5 * th) / (0.5 * th))
    b = 0.5 * half * half

    def exp_apply(vx, vy, vz):
        # exp(w) v = v cos + (w x v) sinc + w (w . v) (1 - cos) / |w|^2
        dot = wx * vx + wy * vy + wz * vz
        return (vx * cos_t + (wy * vz - wz * vy) * sinc + wx * dot * b,
                vy * cos_t + (wz * vx - wx * vz) * sinc + wy * dot * b,
                vz * cos_t + (wx * vy - wy * vx) * sinc + wz * dot * b)

    def head_apply(ax, ay, az):  # R_head v, per-point coefficients
        return (R00 * ax + R01 * ay + R02 * az,
                R10 * ax + R11 * ay + R12 * az,
                R20 * ax + R21 * ay + R22 * az)

    def per_stream(v):  # (..., 3) -> three (..., 1) columns against (..., N)
        return v[..., 0, None], v[..., 1, None], v[..., 2, None]

    rx, ry, rz = head_apply(*exp_apply(points[..., 0], points[..., 1], points[..., 2]))  # R_i p
    ix, iy, iz = head_apply(*exp_apply(*per_stream(t_il)))  # R_i t_il
    p0, p1, p2 = per_stream(pos_lidar_end)
    h2 = 0.5 * dtp * dtp
    cx = rx + (cols[12] + cols[15] * dtp + cols[18] * h2 + ix - p0)
    cy = ry + (cols[13] + cols[16] * dtp + cols[19] * h2 + iy - p1)
    cz = rz + (cols[14] + cols[17] * dtp + cols[20] * h2 + iz - p2)
    re = rot_end[..., None]  # (..., 3, 3, 1) against (..., N)
    deskewed = torch.stack([  # R_end^T p
        re[..., 0, 0, :] * cx + re[..., 1, 0, :] * cy + re[..., 2, 0, :] * cz,
        re[..., 0, 1, :] * cx + re[..., 1, 1, :] * cy + re[..., 2, 1, :] * cz,
        re[..., 0, 2, :] * cx + re[..., 1, 2, :] * cy + re[..., 2, 2, :] * cz,
    ], dim=-1).to(points.dtype)
    return torch.where(pts_mask[..., None], deskewed, points)


def deskew_points(points, rel_t, pts_mask, offsets, table, t_il, pos_lidar_end, rot_end):
    """Every point moved to the scan-end frame in f32 (ekf.cpp:420-456):
    P' = R_end^T (R_i exp(w dt) P + T_i), the interval i being the last
    trail entry whose offset is below the point's time (`searchsorted`,
    side "left"), dt the point's time past that offset; a point whose mask
    is off passes through as it is.

    points (..., N, 3) f32, rel_t (..., N) f64 (seconds past scan begin),
    pts_mask (..., N) bool; per stream, in f32: offsets (..., M) (the trail
    entries' times past scan begin, 0 first, +inf after the last valid
    one), table (..., M, 21) (each entry's R row-major, gyro, position,
    velocity, acceleration), t_il, pos_lidar_end (..., 3) and rot_end (...,
    3, 3). CPU tensors: the plain version; else the IMU deskew kernel
    (`kernels/imu_deskew`), bit-equal to it on the card."""
    args = (points, rel_t, pts_mask, offsets, table, t_il, pos_lidar_end, rot_end)
    if on_cpu(*args):
        return deskew_points_plain(*args)
    return imu_deskew.imu_deskew(*(t.contiguous() for t in args))


def motion_compensation_with_imu(state: EkfState, packet: ImuPacket, points, rel_t, pts_mask,
                                 mean_acc_norm, pcl_beg_time, cfg: EkfConfig):
    """IMU-trajectory undistortion to the scan-end frame (JAX ekf.py:682).

    Builds the per-interval IMU pose trail and its extrapolation to the
    scan end (`imu_trail`), then moves every point in f32
    (`deskew_points`). points (..., N, 3) f32, rel_t (..., N) f64, pts_mask
    (..., N) bool, mean_acc_norm and pcl_beg_time (...). Returns (state',
    deskewed (..., N, 3) f32, diagnostics)."""
    pcl_end_time, diag, terms = imu_trail(state, packet, rel_t, pts_mask, mean_acc_norm,
                                          pcl_beg_time, cfg)
    deskewed = deskew_points(points, rel_t, pts_mask, *terms)
    return state._replace(last_lidar_end_time=pcl_end_time), deskewed, diag

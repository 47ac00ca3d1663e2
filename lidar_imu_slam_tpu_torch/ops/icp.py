"""Robust point-to-point ICP against the voxel map (counterpart of
the JAX package's `ops/icp.py`: the fused-kernel loops and the adaptive
threshold). The classic f64 loops (gn_backend="xla") wait for their own
slice.

Two fused-kernel schedules:
* `icp_registration_fused_pair` — the fast path's loop, kernel K1 per
  round, stopping on the device's answer (one host read per round);
* `icp_registration_fused_unrolled` — the batched schedule: a fixed
  `n_outer` fetches x `n_inner` GN iterations with early-exit masking, no
  host read. Inputs may carry a leading stream axis (S, ...): one kernel
  K5 launch per round serves every stream; without it kernel K4 runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IcpConfig, MapConfig
from . import lie, voxel_map
from .kernels import icp_gn

F32 = torch.float32
F64 = torch.float64


class ThresholdState(NamedTuple):
    """Adaptive-threshold accumulators (reference threshold.cpp)."""

    model_error_sq: torch.Tensor  # () f64 running sum
    num_samples: torch.Tensor  # () i32
    model_deviation: torch.Tensor  # (4, 4) f64


def threshold_init(device: torch.device | str = "cpu", lead: tuple = ()) -> ThresholdState:
    return ThresholdState(
        torch.zeros(lead, dtype=F64, device=device),
        torch.zeros(lead, dtype=torch.int32, device=device),
        torch.eye(4, dtype=F64, device=device).expand(lead + (4, 4)).clone(),
    )


def compute_model_error(model_dev, max_range):
    """2 * max_range * sin(theta/2) + ||t|| (reference threshold.cpp:5-12)."""
    theta = torch.linalg.norm(lie.so3_log(model_dev[..., :3, :3]), dim=-1)
    return (2.0 * max_range * torch.sin(theta / 2.0)
            + torch.linalg.norm(model_dev[..., :3, 3], dim=-1))


def compute_threshold(state: ThresholdState, has_moved, initial_threshold: float,
                      min_motion_th: float, max_range: float):
    """Functional get_adaptive_threshold (reference icp.cpp:138-144 +
    threshold.cpp:16-29): accumulates the previous frame's model deviation
    and returns (state', sigma); before the first motion sigma is the
    initial threshold and the stats stay untouched."""
    err = compute_model_error(state.model_deviation, max_range)
    accumulate = has_moved & (err > min_motion_th)
    new_sum = torch.where(accumulate, state.model_error_sq + err * err, state.model_error_sq)
    new_n = torch.where(accumulate, state.num_samples + 1, state.num_samples)
    sigma_adaptive = torch.sqrt(new_sum / torch.clamp(new_n, min=1))
    sigma = torch.where(has_moved & (new_n >= 1), sigma_adaptive,
                        torch.full_like(sigma_adaptive, initial_threshold))
    return ThresholdState(new_sum, new_n, state.model_deviation), sigma


def update_model_deviation(state: ThresholdState, deviation) -> ThresholdState:
    return ThresholdState(state.model_error_sq, state.num_samples, deviation)


class IcpResult(NamedTuple):
    pose: torch.Tensor  # (..., 4, 4) f64
    iterations: torch.Tensor  # (...) i32
    num_correspondences: torch.Tensor  # (...) i32, from the last active round
    residual_rms: torch.Tensor  # (...) f64
    converged: torch.Tensor  # (...) bool


class FusedIcpResult(NamedTuple):
    pose: torch.Tensor  # (12,) f64 final world pose [R 9 row-major | t 3]
    iterations: int  # GN iterations run (host int: the loop read it)
    num_correspondences: torch.Tensor  # () i32
    residual_rms: torch.Tensor  # () f64
    converged: torch.Tensor  # () bool


def icp_registration_fused_pair(
    m: voxel_map.VoxelMap,
    points: torch.Tensor,  # (N, 3) f32 source, N % 128 == 0
    mask: torch.Tensor,  # (N,) bool
    guess_R9: torch.Tensor,  # (9,) f64 row-major rotation of the initial guess
    guess_t: torch.Tensor,  # (3,) f64 guess translation
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    max_iterations: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
    n_inner: int = 6,
) -> FusedIcpResult:
    """The fused-kernel ICP loop: each round transforms the source by the
    current pose, centres it on its masked centroid, fetches candidates
    from the packed slab and runs one `fused_gn_carry` (up to `n_inner` GN
    iterations, then de-centring and composition in f64).

    Same outer semantics as the JAX `lax.while_loop`
    (the JAX package's ops/icp.py:630-683): a round runs while
    r < max_iterations, iters < max_iterations and not converged; `iters`
    sums the kernel's active iterations, so it can pass max_iterations by
    up to n_inner - 1; an empty map returns the guess, not converged. The
    loop is a Python loop that reads ONE small device tensor per round
    (iterations, flags) — the one host sync per ICP round.
    `max_corresp_dist` / `kernel_th` may be 0-d device tensors (no sync)."""
    if points.shape[0] % 128 != 0:
        raise ValueError(
            f"gn_backend='pallas' needs max_source_points % 128 == 0 "
            f"(got {points.shape[0]})"
        )
    if max_iterations < 1:
        raise ValueError("max_iterations must be >= 1")
    dev = points.device
    px, py, pz = (points[:, i].to(F32) for i in range(3))
    qmask = mask.to(F32).contiguous()
    kth = torch.as_tensor(kernel_th, dtype=F64, device=dev)
    max_d = torch.as_tensor(max_corresp_dist, dtype=F64, device=dev)
    scal = torch.cat([
        torch.stack([kth, max_d * max_d]),
        torch.tensor([estimation_threshold, min_correspondences, max_step_norm,
                      (0.5 * map_cfg.voxel_size) ** 2, 0.0, 0.0], dtype=F64, device=dev),
    ])
    nq = torch.clamp(torch.sum(mask), min=1).to(F32)
    guess = torch.cat([guess_R9.to(F64), guess_t.to(F64)])
    pose = guess  # (12,) [R 9 | t 3]
    r = iters = 0
    converged = False
    while r < max_iterations and iters < max_iterations and not converged:
        R = pose[:9].to(F32)
        t = pose[9:12].to(F32)
        wx = R[0] * px + R[1] * py + R[2] * pz + t[0]
        wy = R[3] * px + R[4] * py + R[5] * pz + t[1]
        wz = R[6] * px + R[7] * py + R[8] * pz + t[2]
        # anchor = masked centroid: near the DATA, which f32 centring needs
        anchor = torch.stack([torch.sum(torch.where(mask, c, torch.zeros_like(c)))
                              for c in (wx, wy, wz)]) / nq
        q = torch.stack([wx - anchor[0], wy - anchor[1], wz - anchor[2]])
        cand = voxel_map.gather_candidate_planes_packed(
            m, torch.stack([wx, wy, wz], dim=-1), mask, map_cfg, anchor)
        row = icp_gn.fused_gn_carry(q, qmask, cand.contiguous(), scal,
                                    torch.cat([pose, anchor.to(F64)]), n_inner)
        pose = row[:12]
        it, flags = row[14:16].tolist()  # the one host sync per round
        iters += int(it)
        converged = flags % 2.0 >= 1.0
        r += 1

    empty = voxel_map.num_voxels(m) == 0
    pose = torch.where(empty, guess, pose)
    conv = torch.tensor(converged, device=dev) & ~empty
    return FusedIcpResult(pose, iters, row[12].to(torch.int32), row[13], conv)


def _transform_soa(T, px, py, pz):
    """(..., 4, 4) f64 T applied to SoA (..., N) f64 points."""
    R, t = T[..., None, :3, :3], T[..., None, :3, 3]
    wx = R[..., 0, 0] * px + R[..., 0, 1] * py + R[..., 0, 2] * pz + t[..., 0]
    wy = R[..., 1, 0] * px + R[..., 1, 1] * py + R[..., 1, 2] * pz + t[..., 1]
    wz = R[..., 2, 0] * px + R[..., 2, 1] * py + R[..., 2, 2] * pz + t[..., 2]
    return wx, wy, wz


def _fused_round(m, px, py, pz, mask, qmask, T, map_cfg: MapConfig, scal, n_inner: int):
    """One fetch + `n_inner` fused GN iterations at pose T (JAX
    ops/icp.py:462): the source is transformed in f64, centred on its
    masked centroid rounded to f32, and the kernel's centred correction is
    de-centred in f64 here, outside the kernel.

    Returns (T_delta (..., 4, 4) f64 world-frame correction, n_corr i32,
    rms f64, iters i32, converged, stale)."""
    wx, wy, wz = _transform_soa(T, px, py, pz)
    nq = torch.clamp(torch.sum(mask, dim=-1), min=1).to(F64)
    anchor = torch.stack([torch.sum(torch.where(mask, c, torch.zeros_like(c)), dim=-1) / nq
                          for c in (wx, wy, wz)], dim=-1)
    anchor = anchor.to(F32).to(F64)
    q = torch.stack([(c - anchor[..., i, None]).to(F32)
                     for i, c in enumerate((wx, wy, wz))], dim=-2)
    world_f = torch.stack([wx.to(F32), wy.to(F32), wz.to(F32)], dim=-1)
    cand = voxel_map.gather_candidate_planes_packed(m, world_f, mask, map_cfg, anchor)
    gn = icp_gn.fused_gn if q.dim() == 2 else icp_gn.fused_gn_batched
    row = gn(q, qmask, cand.contiguous(), scal, n_inner)
    Rd = row[..., :9].reshape(row.shape[:-1] + (3, 3))
    td = row[..., 9:12] + anchor - torch.sum(Rd * anchor[..., None, :], dim=-1)
    flags = row[..., 15]
    return (lie.make_transform(Rd, td), row[..., 12].to(torch.int32), row[..., 13],
            row[..., 14].to(torch.int32), torch.remainder(flags, 2.0) >= 1.0, flags >= 2.0)


def icp_registration_fused_unrolled(
    m: voxel_map.VoxelMap,
    points: torch.Tensor,  # (..., N, 3) f32 world-frame source, N % 128 == 0
    mask: torch.Tensor,  # (..., N) bool
    init_guess: torch.Tensor,  # (..., 4, 4) f64
    max_corresp_dist,  # (...) f64
    kernel_th,  # (...) f64
    map_cfg: MapConfig,
    n_outer: int,
    n_inner: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
) -> IcpResult:
    """Fixed-unroll fused-kernel ICP for batched streams (JAX
    ops/icp.py:686): `n_outer` fetches x `n_inner` kernel iterations with
    early-exit masking and no host read. A round's correction applies only
    while the stream is `active` (not yet converged when the round began);
    `iters` counts active rounds' iterations; a stale stream refetches in
    the next round; an empty map returns the guess, not converged."""
    if points.shape[-2] % 128 != 0:
        raise ValueError(
            f"gn_backend='pallas' needs max_source_points % 128 == 0 "
            f"(got {points.shape[-2]})"
        )
    dev = points.device
    batch = mask.shape[:-1]
    px, py, pz = (points[..., i].to(F64) for i in range(3))
    qmask = mask.to(F32).contiguous()
    max_d = torch.as_tensor(max_corresp_dist, dtype=F64, device=dev).expand(batch)
    kth = torch.as_tensor(kernel_th, dtype=F64, device=dev).expand(batch)
    # the constant scalars are filled on the device: a host-to-device copy
    # would sync
    consts = [torch.full(batch, v, dtype=F64, device=dev)
              for v in (estimation_threshold, min_correspondences, max_step_norm,
                        (0.5 * map_cfg.voxel_size) ** 2, 0.0, 0.0)]
    scal = torch.stack([kth, max_d * max_d] + consts, dim=-1)

    eye = torch.eye(4, dtype=F64, device=dev).expand(batch + (4, 4))
    T_icp = eye
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    n_corr = torch.zeros(batch, dtype=torch.int32, device=dev)
    rms = torch.zeros(batch, dtype=F64, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(n_outer):
        T = lie.compose(T_icp, init_guess)
        T_delta, nc, rms2, it, conv, _stale = _fused_round(
            m, px, py, pz, mask, qmask, T, map_cfg, scal, n_inner)
        active = ~converged
        T_icp = torch.where(active[..., None, None], lie.compose(T_delta, T_icp), T_icp)
        n_corr = torch.where(active, nc, n_corr)
        rms = torch.where(active, rms2, rms)
        iters = iters + torch.where(active, it, torch.zeros_like(it))
        converged = converged | conv

    empty = voxel_map.num_voxels(m) == 0
    pose = torch.where(empty[..., None, None], init_guess, lie.compose(T_icp, init_guess))
    return IcpResult(pose, iters, n_corr, rms, converged & ~empty)


def registration_dispatch(m, source, source_mask, init_guess, sigma,
                          map_cfg: MapConfig, icp_cfg: IcpConfig) -> IcpResult:
    """The registration variant the config selects (JAX ops/icp.py:744):
    max_corr = 3 sigma, kernel = sigma / 3 (reference icp.cpp:74-76). The
    pallas backend runs the fixed unroll when `batch_unroll_outer > 0` and
    the fused loop otherwise; the f64 XLA loops wait for their slice."""
    if icp_cfg.gn_backend != "pallas":
        raise NotImplementedError(
            "gn_backend='xla' is the classic f64 path, which comes with a later "
            "slice of the port"
        )
    max_corr = 3.0 * sigma
    kth = sigma / 3.0
    if icp_cfg.batch_unroll_outer > 0:
        return icp_registration_fused_unrolled(
            m, source, source_mask, init_guess, max_corr, kth, map_cfg,
            icp_cfg.batch_unroll_outer,
            icp_cfg.batch_unroll_inner or icp_cfg.fused_inner,
            icp_cfg.estimation_threshold,
            icp_cfg.min_correspondences, icp_cfg.max_step_norm,
        )
    if source_mask.dim() != 1:
        raise ValueError("the fused while loop registers one stream; batched streams "
                         "need batch_unroll_outer > 0 (parallel.streams.batch_config)")
    res = icp_registration_fused_pair(
        m, source, source_mask, init_guess[:3, :3].reshape(9), init_guess[:3, 3],
        max_corr, kth, map_cfg, icp_cfg.max_iterations, icp_cfg.estimation_threshold,
        icp_cfg.min_correspondences, icp_cfg.max_step_norm, icp_cfg.fused_inner,
    )
    pose = lie.make_transform(res.pose[:9].reshape(3, 3), res.pose[9:12])
    iters = torch.tensor(res.iterations, dtype=torch.int32, device=source.device)
    return IcpResult(pose, iters, res.num_correspondences, res.residual_rms, res.converged)

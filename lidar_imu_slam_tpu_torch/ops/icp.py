"""Robust point-to-point ICP against the voxel map (counterpart of
the JAX package's `ops/icp.py`): the classic f64 loops, the fused-kernel
loops and the adaptive threshold.

The classic f64 backend (gn_backend="xla") in plain tensor code:
* `icp_registration` — candidates fetched from the f32 slab once per outer
  round, f64 GN iterations (`gn_step` on the nearest candidates, the step
  the map-sharded ICP also takes) until converged or stale. The
  loops are Python loops with ONE host read per inner iteration (the
  converged / stale flags);
* `icp_registration_unrolled` — its batched schedule: `n_outer` fetches x
  `n_inner` iterations with early-exit masking and no host read; inputs
  may carry a leading stream axis (S, ...).

Two fused-kernel schedules (gn_backend="pallas"):
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
from ..utils.profiling import annotate
from . import lie, voxel_map
from .kernels import icp_gn

F32 = torch.float32
F64 = torch.float64


class ThresholdState(NamedTuple):
    """Adaptive-threshold accumulators (reference threshold.cpp)."""

    model_error_sq: torch.Tensor  # () f64 running sum
    num_samples: torch.Tensor  # () i32
    model_deviation: torch.Tensor  # (4, 4) f64


def threshold_init(device: torch.device | str = "cuda", lead: tuple = ()) -> ThresholdState:
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


# ---------------------------------------------------------------------------
# the classic f64 GN step (gn_backend="xla")
# ---------------------------------------------------------------------------


def robust_weight(res_sq, th):
    """KISS-ICP kernel th^2 / (th + r^2)^2 (reference registration.cpp:57-58)."""
    den = th + res_sq
    return (th * th) / (den * den)


def chol6_solve(A, b):
    """Solve the SPD system A x = b, A (..., 6, 6), b (..., 6), in f64 by a
    Cholesky factor and two triangular solves. Where A is not positive
    definite x is NaN, as the JAX package's unrolled factor gives (sqrt of
    a negative pivot); callers zero it through their isfinite guard. No
    host sync: `cholesky_ex` reports failure in a device tensor."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))


def _solve_step(JtWJ, JtWr, sw):
    """Ridge, Cholesky solve and guards of one GN step (JAX ops/icp.py:
    114-118): returns (exp(x) (..., 4, 4), x (..., 6))."""
    diag = torch.diagonal(JtWJ, dim1=-2, dim2=-1)
    ridge = 1e-9 * (1.0 + torch.amax(torch.abs(diag), dim=-1))
    eye6 = torch.eye(6, dtype=F64, device=JtWJ.device)
    x = chol6_solve(JtWJ + ridge[..., None, None] * eye6, -JtWr)
    x = torch.where(sw[..., None] > 0, x, torch.zeros_like(x))
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return lie.se3_exp(x), x


def _normal_matrix(sw, S, sxx, syy, szz, sxy, sxz, syz):
    """[[sw I, -hat(S)], [-hat(S)^T, tr(ss) I - ss]] (..., 6, 6), in the
    JAX package's operation order."""
    eye3 = torch.eye(3, dtype=F64, device=sw.device)
    A = sw[..., None, None] * eye3
    B = -lie.hat(S)
    ss = torch.stack([torch.stack([sxx, sxy, sxz], -1), torch.stack([sxy, syy, syz], -1),
                      torch.stack([sxz, syz, szz], -1)], -2)
    D = (sxx + syy + szz)[..., None, None] * eye3 - ss
    return torch.cat([torch.cat([A, B], -1), torch.cat([B.transpose(-1, -2), D], -1)], -2)


def align_clouds(src, tgt, corr_mask, kernel_th):
    """One weighted point-to-point GN step (JAX ops/icp.py:63; reference
    registration.cpp:43-92). src / tgt (..., N, 3), corr_mask (..., N),
    kernel_th broadcastable to (..., N). All f64. Returns (T (..., 4, 4),
    xi (..., 6)): exp of the solved twist, and the twist."""
    s = src.to(F64)
    r = s - tgt.to(F64)
    r = torch.where(corr_mask[..., None], r, torch.zeros_like(r))
    res_sq = torch.sum(r * r, dim=-1)
    w = torch.where(corr_mask, robust_weight(res_sq, kernel_th), torch.zeros_like(res_sq))
    ws = w[..., None] * s
    wr = w[..., None] * r
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    sums = [torch.sum(v, dim=-1) for v in (w, w * sx * sx, w * sy * sy, w * sz * sz,
                                             w * sx * sy, w * sx * sz, w * sy * sz)]
    JtWJ = _normal_matrix(sums[0], torch.sum(ws, dim=-2), *sums[1:])
    JtWr = torch.cat([torch.sum(wr, dim=-2), torch.sum(lie.cross(ws, r), dim=-2)], dim=-1)
    return _solve_step(JtWJ, JtWr, sums[0])


def _align_soa(sx, sy, sz, tx, ty, tz, corr_mask, kernel_th):
    """`align_clouds` on structure-of-arrays f64 operands (..., N) (JAX
    ops/icp.py:121): the 16 normal-equation sums as one reduction."""
    zero = torch.zeros_like(sx)
    rx = torch.where(corr_mask, sx - tx, zero)
    ry = torch.where(corr_mask, sy - ty, zero)
    rz = torch.where(corr_mask, sz - tz, zero)
    res_sq = rx * rx + ry * ry + rz * rz
    w = torch.where(corr_mask, robust_weight(res_sq, kernel_th), zero)
    wsx, wsy, wsz = w * sx, w * sy, w * sz
    sums = torch.stack([
        w, wsx, wsy, wsz, wsx * sx, wsy * sy, wsz * sz, wsx * sy, wsx * sz, wsy * sz,
        w * rx, w * ry, w * rz, wsy * rz - wsz * ry, wsz * rx - wsx * rz, wsx * ry - wsy * rx,
    ], dim=-2).sum(dim=-1)
    sw = sums[..., 0]
    sxx, syy, szz, sxy, sxz, syz = (sums[..., i] for i in range(4, 10))
    JtWJ = _normal_matrix(sw, sums[..., 1:4], sxx, syy, szz, sxy, sxz, syz)
    return _solve_step(JtWJ, sums[..., 10:16], sw)


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
    from the packed slab (the f32 point slab under packed_nn=False, as in
    the JAX package) and runs one `fused_gn_carry` (up to `n_inner` GN
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
        with annotate("icp.fetch"):
            fetch = (voxel_map.gather_candidate_planes_packed if map_cfg.packed_nn
                     else voxel_map.gather_candidate_planes)
            cand = fetch(m, torch.stack([wx, wy, wz], dim=-1), mask, map_cfg,
                         anchor).contiguous()
        with annotate("icp.gn"):
            row = icp_gn.fused_gn_carry(q, qmask, cand, scal,
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


def transform_soa(T, px, py, pz):
    """(..., 4, 4) f64 T applied to SoA (..., N) f64 points."""
    R, t = T[..., None, :3, :3], T[..., None, :3, 3]
    wx = R[..., 0, 0] * px + R[..., 0, 1] * py + R[..., 0, 2] * pz + t[..., 0]
    wy = R[..., 1, 0] * px + R[..., 1, 1] * py + R[..., 1, 2] * pz + t[..., 1]
    wz = R[..., 2, 0] * px + R[..., 2, 1] * py + R[..., 2, 2] * pz + t[..., 2]
    return wx, wy, wz


def _fetch(m, T, px, py, pz, mask, map_cfg: MapConfig):
    """Candidates of the source at pose T from the f32 slab, de-interleaved."""
    with annotate("icp.fetch"):
        wx, wy, wz = transform_soa(T, px, py, pz)
        world_f = torch.stack([wx.to(F32), wy.to(F32), wz.to(F32)], dim=-1)
        cand, cand_valid = voxel_map.gather_candidates(m, world_f, mask, map_cfg)
        return (*voxel_map.deinterleave_candidates(cand), cand_valid)


def _gn_iteration(T_icp, init_guess, px, py, pz, cand, mask, max_d2, kth,
                  min_correspondences: int, max_step_norm: float,
                  estimation_threshold: float):
    """One f64 GN iteration against fixed candidates (the body shared by
    JAX ops/icp.py:253-289 and :374-408): the source at T_icp init_guess,
    its nearest candidates, then `gn_step`."""
    T = lie.compose(T_icp, init_guess)
    wx, wy, wz = transform_soa(T, px, py, pz)
    tx, ty, tz, d2, found = voxel_map.nn_from_candidates_soa(
        *cand[:3], cand[3], wx.to(F32), wy.to(F32), wz.to(F32), mask)
    return gn_step(wx, wy, wz, tx, ty, tz, d2, found, max_d2, kth, min_correspondences,
                   max_step_norm, estimation_threshold)


def gn_step(wx, wy, wz, tx, ty, tz, d2, found, max_d2, kth, min_correspondences: int,
            max_step_norm: float, estimation_threshold: float):
    """One f64 GN step from matches: the source (..., N) f64 SoA, its
    nearest neighbours (..., N) f32 SoA with their f32 d^2 and `found`
    flags; max_d2 / kth (...) f64. Returns (estimate (..., 4, 4), n_corr
    i32, rms f64, converged)."""
    # compared in f64, as JAX promotes the f32 d2 against the f64 bound
    corr = found & (d2.to(F64) < max_d2[..., None])
    estimate, xi = _align_soa(wx, wy, wz, tx.to(F64), ty.to(F64), tz.to(F64), corr,
                              kth[..., None])
    nc = torch.sum(corr, dim=-1).to(torch.int32)
    # degraded-mode guards: freeze on starved correspondences, clamp runaway steps
    step = torch.linalg.norm(xi, dim=-1)
    scale = torch.where(step > max_step_norm, max_step_norm / step, torch.ones_like(step))
    ok = nc >= min_correspondences
    eye = torch.eye(4, dtype=F64, device=wx.device)
    clamped = lie.se3_exp(xi * scale[..., None])
    estimate = torch.where(ok[..., None, None],
                           torch.where((scale < 1.0)[..., None, None], clamped, estimate), eye)
    d2_in = torch.where(corr, d2, torch.zeros_like(d2))
    rms = torch.sqrt(torch.sum(d2_in, dim=-1) / torch.clamp(nc, min=1)).to(F64)
    converged = ~ok | (torch.clamp(step, max=max_step_norm) < estimation_threshold)
    return estimate, nc, rms, converged


def icp_registration(
    m: voxel_map.VoxelMap,
    points: torch.Tensor,  # (N, 3) f32 source
    mask: torch.Tensor,  # (N,) bool
    init_guess: torch.Tensor,  # (4, 4) f64
    max_corresp_dist,
    kernel_th,
    map_cfg: MapConfig,
    max_iterations: int,
    estimation_threshold: float,
    min_correspondences: int = 20,
    max_step_norm: float = 2.0,
) -> IcpResult:
    """The classic f64 ICP loop (JAX ops/icp.py:187; reference
    registration.cpp:94-130): each outer round fetches candidates at the
    current pose; inner GN iterations run against them until converged,
    stale (the pose drifted more than half a voxel from the fetch) or out
    of budget. Python loops, one host read per inner iteration (the
    converged / stale flags). `max_corresp_dist` / `kernel_th` may be 0-d
    device tensors. An empty map returns the guess, not converged."""
    if mask.dim() != 1:
        raise ValueError("the classic while loop registers one stream; batched streams "
                         "need batch_unroll_outer > 0 (parallel.streams.batch_config)")
    dev = points.device
    px, py, pz = (points[:, i].to(F64) for i in range(3))
    max_d = torch.as_tensor(max_corresp_dist, dtype=F64, device=dev)
    max_d2 = max_d * max_d
    kth = torch.as_tensor(kernel_th, dtype=F64, device=dev)
    refetch_d2 = (0.5 * map_cfg.voxel_size) ** 2
    T_icp = torch.eye(4, dtype=F64, device=dev)
    conv_t = torch.zeros((), dtype=torch.bool, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    rms = torch.zeros((), dtype=F64, device=dev)
    r = j = 0
    converged = False
    # every outer round runs >= 1 inner iteration, so max_iterations rounds
    # suffice for the iteration budget to bind
    while r < max_iterations and j < max_iterations and not converged:
        T = lie.compose(T_icp, init_guess)
        cand = _fetch(m, T, px, py, pz, mask, map_cfg)
        anchor_t = T[:3, 3]
        stale = False
        while j < max_iterations and not converged and not stale:
            estimate, n_corr, rms, conv_t = _gn_iteration(
                T_icp, init_guess, px, py, pz, cand, mask, max_d2, kth,
                min_correspondences, max_step_norm, estimation_threshold)
            T_icp = lie.compose(estimate, T_icp)
            drift = torch.sum((lie.compose(T_icp, init_guess)[:3, 3] - anchor_t) ** 2)
            stale_t = ~conv_t & (drift > refetch_d2)
            converged, stale = torch.stack([conv_t, stale_t]).tolist()  # the one host read
            j += 1
        r += 1

    empty = voxel_map.num_voxels(m) == 0
    pose = torch.where(empty, init_guess, lie.compose(T_icp, init_guess))
    iters = torch.full((), j, dtype=torch.int32, device=dev)
    return IcpResult(pose, iters, n_corr, rms, conv_t & ~empty)


def icp_registration_unrolled(
    m: voxel_map.VoxelMap,
    points: torch.Tensor,  # (..., N, 3) f32 source
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
    """Fixed-unroll classic ICP for batched streams (JAX ops/icp.py:327):
    `n_outer` fetches x `n_inner` GN iterations, the same math per
    iteration as `icp_registration`; a converged stream freezes its pose by
    masking. No host read. Inputs may carry a leading stream axis."""
    dev = points.device
    batch = mask.shape[:-1]
    px, py, pz = (points[..., i].to(F64) for i in range(3))
    max_d = torch.as_tensor(max_corresp_dist, dtype=F64, device=dev).expand(batch)
    max_d2 = max_d * max_d
    kth = torch.as_tensor(kernel_th, dtype=F64, device=dev).expand(batch)
    T_icp = torch.eye(4, dtype=F64, device=dev).expand(batch + (4, 4))
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    n_corr = torch.zeros(batch, dtype=torch.int32, device=dev)
    rms = torch.zeros(batch, dtype=F64, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(n_outer):
        cand = _fetch(m, lie.compose(T_icp, init_guess), px, py, pz, mask, map_cfg)
        for _ in range(n_inner):
            estimate, nc, rms_i, conv = _gn_iteration(
                T_icp, init_guess, px, py, pz, cand, mask, max_d2, kth,
                min_correspondences, max_step_norm, estimation_threshold)
            active = ~converged
            T_icp = torch.where(active[..., None, None], lie.compose(estimate, T_icp), T_icp)
            n_corr = torch.where(active, nc, n_corr)
            rms = torch.where(active, rms_i, rms)
            iters = iters + active.to(torch.int32)
            converged = converged | conv

    empty = voxel_map.num_voxels(m) == 0
    pose = torch.where(empty[..., None, None], init_guess, lie.compose(T_icp, init_guess))
    return IcpResult(pose, iters, n_corr, rms, converged & ~empty)


def _fused_round(m, px, py, pz, mask, qmask, T, map_cfg: MapConfig, scal, n_inner: int):
    """One fetch + `n_inner` fused GN iterations at pose T (JAX
    ops/icp.py:462): the source is transformed in f64, centred on its
    masked centroid rounded to f32, and the kernel's centred correction is
    de-centred in f64 here, outside the kernel.

    Returns (T_delta (..., 4, 4) f64 world-frame correction, n_corr i32,
    rms f64, iters i32, converged, stale)."""
    wx, wy, wz = transform_soa(T, px, py, pz)
    nq = torch.clamp(torch.sum(mask, dim=-1), min=1).to(F64)
    anchor = torch.stack([torch.sum(torch.where(mask, c, torch.zeros_like(c)), dim=-1) / nq
                          for c in (wx, wy, wz)], dim=-1)
    anchor = anchor.to(F32).to(F64)
    q = torch.stack([(c - anchor[..., i, None]).to(F32)
                     for i, c in enumerate((wx, wy, wz))], dim=-2)
    with annotate("icp.fetch"):
        world_f = torch.stack([wx.to(F32), wy.to(F32), wz.to(F32)], dim=-1)
        fetch = (voxel_map.gather_candidate_planes_packed if map_cfg.packed_nn
                 else voxel_map.gather_candidate_planes)
        cand = fetch(m, world_f, mask, map_cfg, anchor).contiguous()
    with annotate("icp.gn"):
        gn = icp_gn.fused_gn if q.dim() == 2 else icp_gn.fused_gn_batched
        row = gn(q, qmask, cand, scal, n_inner)
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


@annotate("icp.register")
def registration_dispatch(m, source, source_mask, init_guess, sigma,
                          map_cfg: MapConfig, icp_cfg: IcpConfig) -> IcpResult:
    """The registration variant the config selects (JAX ops/icp.py:744):
    gn_backend ("pallas" fused kernels, "xla" f64 loops) x schedule (the
    while loop, or the fixed unroll when `batch_unroll_outer > 0`).
    max_corr = 3 sigma, kernel = sigma / 3 (reference icp.cpp:74-76)."""
    max_corr = 3.0 * sigma
    kth = sigma / 3.0
    if icp_cfg.gn_backend == "xla":
        if icp_cfg.batch_unroll_outer > 0:
            return icp_registration_unrolled(
                m, source, source_mask, init_guess, max_corr, kth, map_cfg,
                icp_cfg.batch_unroll_outer, icp_cfg.batch_unroll_inner,
                icp_cfg.estimation_threshold,
                icp_cfg.min_correspondences, icp_cfg.max_step_norm,
            )
        return icp_registration(
            m, source, source_mask, init_guess, max_corr, kth, map_cfg,
            icp_cfg.max_iterations, icp_cfg.estimation_threshold,
            icp_cfg.min_correspondences, icp_cfg.max_step_norm,
        )
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

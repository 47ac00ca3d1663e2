"""Robust point-to-point ICP against the voxel map (counterpart of
the JAX package's `ops/icp.py`: the fused-kernel loop and the adaptive
threshold state). The classic f64 loops wait for their own slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig
from . import voxel_map
from .kernels import icp_gn

F32 = torch.float32
F64 = torch.float64


class ThresholdState(NamedTuple):
    """Adaptive-threshold accumulators (reference threshold.cpp)."""

    model_error_sq: torch.Tensor  # () f64 running sum
    num_samples: torch.Tensor  # () i32
    model_deviation: torch.Tensor  # (4, 4) f64


def threshold_init(device: torch.device | str = "cpu") -> ThresholdState:
    return ThresholdState(
        torch.zeros((), dtype=F64, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.eye(4, dtype=F64, device=device),
    )


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

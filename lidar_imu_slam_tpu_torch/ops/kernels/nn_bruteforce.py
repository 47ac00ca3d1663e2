"""Exact global nearest neighbour by brute force: kernel K6 (`nn_bruteforce`).

Counterpart of the JAX package's `ops/pallas/nn_bruteforce.py`: each
query's nearest entry of a (3, M) point pool — coordinate-major, +inf for
dead or padding entries — as (d2 (N,) f32, idx (N,) i32). d^2 is the f32
(dx*dx + dy*dy) + dz*dz with d = p - q, and the smallest index attaining
the minimum wins (JAX's tile argmin and its strict `<` merge across tiles).
A superset of the voxel map's hash fetch (`voxel_map.nearest_neighbors`),
which searches only the query's voxel neighbourhood.

`pool_from_map` builds the pool from a map's f32 point slab
(store_points=True) in the JAX package's shape, so the two pools compare
element for element. The kernel takes any N and M; the TPU tile
divisibility is not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from .. import voxel_map
from . import _build
from ._common import LAUNCHES, expect, expect_cuda, on_cpu, stream_handle

F32 = torch.float32
MT = 8192  # pool padding granule of the JAX package's pool (its pool tile)
SLICE = 8192  # pool entries per thread block (a multiple of the kernel's 2048-point stage)
PLAIN_CHUNK = 32768  # pool columns per step of the plain version

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load().lis_nn_bruteforce
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, i, i, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pool_from_map(m: voxel_map.VoxelMap, cfg) -> torch.Tensor:
    """The (3, M) pool of a map's live points (JAX nn_bruteforce.py:117):
    slab row-major order, +inf for dead rows of live voxels, for evicted or
    empty voxels and for the padding up to M = capacity * K rounded up to a
    multiple of MT. `cfg` is the MapConfig."""
    if not m.points.numel():
        raise ValueError("pool_from_map reads the f32 point slab (store_points=True)")
    k, c = cfg.max_points_per_voxel, cfg.capacity
    dev = m.points.device
    col = torch.arange(k, dtype=torch.int32, device=dev)
    valid = ((col < m.npts[:, None]) & (m.keys >= 0)[:, None]).reshape(-1)
    pts = m.points.reshape(c * k, 3)
    total = -(-c * k // MT) * MT
    pool = torch.full((3, total), float("inf"), dtype=F32, device=dev)
    pool[:, : c * k] = torch.where(valid[:, None], pts, torch.full_like(pts, float("inf"))).T
    return pool


def nn_bruteforce_plain(queries: torch.Tensor, pool: torch.Tensor,
                        chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of K6: the pool in `chunk`-column steps (a whole
    N x M distance matrix would not fit at the path's shape), each step's
    first minimum, merged across steps by strict `<` so the earlier index
    wins."""
    q = queries.to(F32)
    n, m = q.shape[0], pool.shape[1]
    best = torch.full((n,), float("inf"), dtype=F32, device=q.device)
    best_idx = torch.zeros(n, dtype=torch.int64, device=q.device)
    qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]
    for start in range(0, m, chunk):
        p = pool[:, start:start + chunk]
        dx = p[0][None, :] - qx
        dy = p[1][None, :] - qy
        dz = p[2][None, :] - qz
        mn, first = voxel_map.argmin_first(dx * dx + dy * dy + dz * dz)
        better = mn < best
        best = torch.where(better, mn, best)
        best_idx = torch.where(better, first + start, best_idx)
    return best, best_idx.to(torch.int32)


def nn_bruteforce(queries: torch.Tensor, pool: torch.Tensor):
    """Each query's global nearest pool entry: queries (N, 3) f32, pool
    (3, M) f32 -> (d2 (N,) f32, idx (N,) i32). CPU tensors: the plain
    version; CUDA tensors: kernel K6 (two passes, one launch count)."""
    expect("queries", queries, F32, (None, 3))
    expect("pool", pool, F32, (3, None))
    if on_cpu(queries, pool):
        return nn_bruteforce_plain(queries, pool)
    fn = _kernel()
    expect_cuda(queries, pool)
    n, m = queries.shape[0], pool.shape[1]
    slices = max(-(-m // SLICE), 1)
    dev = queries.device
    part_d2 = torch.empty((slices, n), dtype=F32, device=dev)
    part_idx = torch.empty((slices, n), dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=F32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    status = fn(queries.data_ptr(), pool.data_ptr(), n, m, SLICE, part_d2.data_ptr(),
                part_idx.data_ptr(), d2.data_ptr(), idx.data_ptr(), stream_handle(dev))
    _build.check(status, "nn_bruteforce")
    LAUNCHES["nn_bruteforce"] += 1
    return d2, idx

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

On the card (`csrc/nn_bruteforce.cu`) most pairs go through a cheaper
filter, a = d^2 - |q|^2 up to rounding (three FMAs), and only groups whose
filter minimum reaches a query's threshold are re-computed with the exact
expression; `filter_threshold` mirrors that threshold, whose margin is
proved in the kernel's header, for the tests. A NaN pool entry (its d^2
NaN) never wins and hides nothing, in the kernel and in the plain version
alike, so the two agree bit for bit on pools with NaN entries too. The JAX
kernel skips the whole 8192-entry tile that holds one; `pool_from_map`
writes +inf, never NaN.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import voxel_map
from . import _build
from ._common import LAUNCHES, expect, lean_entry, on_cpu

F32 = torch.float32
MT = 8192  # pool padding granule of the JAX package's pool (its pool tile)
SLICE = 8192  # pool entries per thread block (a multiple of the kernel's 1024-entry stage)
PLAIN_CHUNK = 32768  # pool columns per step of the plain version
# the kernel's filter (csrc/nn_bruteforce.cu: kRange, kU, kMarginC, kMarginAbs)
FILTER_RANGE = 2.0 ** 60  # |coordinate| up to which a query or entry is filtered
FILTER_U = 2.0 ** -24
FILTER_C = 8.0
FILTER_ABS = 2.0 ** -120

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = [_vp, _vp, _i, _i, _i, _vp, _vp, _vp, _vp, _vp]
_fns: dict[str, object] = {}  # the bound C entry (`_common.bind`)


def filter_threshold(t, qq, p2):
    """The kernel's filter threshold, in f64 before its rounding up to f32:
    a group whose smallest filter value a = d^2 - |q|^2 (+ rounding) is at
    most this is re-checked exactly. t: an upper bound on the query's
    exact minimum d^2; qq = |q|^2 (f64); p2: the largest computed |p|^2 of
    the stage. Every entry with exact d^2 <= t has a <= the threshold
    (the proof is in the kernel's header). numpy arrays or floats."""
    t = np.asarray(t, np.float64)
    qq = np.asarray(qq, np.float64)
    p2 = np.asarray(p2, np.float64)
    return (t - qq) + FILTER_C * FILTER_U * (t + qq + p2 + 2.0 * np.sqrt(qq) * np.sqrt(p2)) \
        + FILTER_ABS


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
    wins. A NaN d^2 counts as +inf: it never wins and hides no entry."""
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
        d2 = dx * dx + dy * dy + dz * dz
        mn, first = voxel_map.argmin_first(torch.where(torch.isnan(d2), float("inf"), d2))
        better = mn < best
        best = torch.where(better, mn, best)
        best_idx = torch.where(better, first + start, best_idx)
    return best, best_idx.to(torch.int32)


def _launch(queries: torch.Tensor, pool: torch.Tensor, slice_len: int = SLICE):
    """K6 on CUDA tensors: seed, filter over slices of `slice_len` pool
    entries (a multiple of 1024), merge; one launch count."""
    fn, stream = lean_entry(_fns, "lis_nn_bruteforce", _ARGS, queries, pool)
    n, m = queries.shape[0], pool.shape[1]
    slices = max(-(-m // slice_len), 1)
    part_d2 = queries.new_empty((slices, n))
    part_idx = torch.empty((slices, n), dtype=torch.int32, device=queries.device)
    d2 = queries.new_empty(n)
    idx = torch.empty(n, dtype=torch.int32, device=queries.device)
    status = fn(queries.data_ptr(), pool.data_ptr(), n, m, slice_len, part_d2.data_ptr(),
                part_idx.data_ptr(), d2.data_ptr(), idx.data_ptr(), stream)
    _build.check(status, "nn_bruteforce")
    LAUNCHES["nn_bruteforce"] += 1
    return d2, idx


def nn_bruteforce(queries: torch.Tensor, pool: torch.Tensor):
    """Each query's global nearest pool entry: queries (N, 3) f32, pool
    (3, M) f32 -> (d2 (N,) f32, idx (N,) i32). CPU tensors: the plain
    version; CUDA tensors: kernel K6 (one launch count)."""
    expect("queries", queries, F32, (None, 3))
    expect("pool", pool, F32, (3, None))
    if on_cpu(queries, pool):
        return nn_bruteforce_plain(queries, pool)
    return _launch(queries, pool)

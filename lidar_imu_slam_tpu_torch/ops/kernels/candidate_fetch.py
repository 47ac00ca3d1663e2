"""The ICP candidate fetch kernel (`csrc/candidate_fetch.cu`): grid lookup,
packed-row gather and decode in one pass, writing the candidate planes that
K1 / K4 / K5 read.

It replaces no Pallas kernel: the JAX package's fetch is plain `jnp`
gathers (`ops/voxel_map.py:gather_candidate_planes_packed`). Its plain
PyTorch version is `voxel_map.gather_candidate_planes_packed_plain`, and
`voxel_map.gather_candidate_planes_packed` holds the dispatch rule: the
plain version when every tensor lies on the CPU, else this wrapper, which
launches the kernel or raises. The kernel is bound by bytes (1.39 GB a
launch at the batched deployments' shapes, 72% of it the planes it
writes). The wrapper takes `_common`'s lean launch path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._common import LAUNCHES, expect, lean_entry

F32 = torch.float32
I32 = torch.int32

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = [_vp] * 6 + [_i, _i, _ll, _i, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _vp, _vp]

_fns: dict[str, object] = {}  # bound C entries (`_common.bind`)


def candidate_fetch(grid: torch.Tensor, packed: torch.Tensor, queries: torch.Tensor,
                    qmask: torch.Tensor, av: torch.Tensor, aoff: torch.Tensor, *,
                    neighborhood: int, grid_log2: tuple, slot_bits: int,
                    decode: tuple) -> torch.Tensor:
    """Candidate planes lead + (3, Kp * NB, N) f32, candidate j = kp * NB +
    nb, +inf for absent voxels, unused lanes and masked-out queries.

    grid lead + (G,) i32 and packed lead + (C, Kp) i32 (the map's tables),
    queries lead + (N, 3) f32 world frame, qmask lead + (N,) bool, av lead +
    (3,) i32 and aoff lead + (3,) f32 (the anchor's voxel and offset);
    lead is () or (S,). `decode` = (voxel_size, half a voxel, the packed
    lane's scale, half the packed window), each already rounded to f32.
    CUDA tensors on one device only."""
    lead = queries.shape[:-2]
    n = queries.shape[-2]
    kp = packed.shape[-1]
    expect("queries", queries, F32, (*lead, n, 3))
    expect("qmask", qmask, torch.bool, (*lead, n))
    expect("grid", grid, I32, (*lead, None))
    expect("packed", packed, I32, (*lead, None, kp))
    expect("av", av, I32, (*lead, 3))
    expect("aoff", aoff, F32, (*lead, 3))
    fn, stream = lean_entry(_fns, "lis_candidate_fetch", _ARGS, grid, packed, queries, qmask,
                            av, aoff)
    out = queries.new_empty((*lead, 3, kp * neighborhood, n))
    status = fn(queries.data_ptr(), qmask.data_ptr(), grid.data_ptr(), packed.data_ptr(),
                av.data_ptr(), aoff.data_ptr(), math.prod(lead), n, grid.shape[-1],
                packed.shape[-2], kp, neighborhood, *grid_log2, slot_bits, *decode,
                out.data_ptr(), stream)
    _build.check(status, "candidate_fetch")
    LAUNCHES["candidate_fetch"] += 1
    return out

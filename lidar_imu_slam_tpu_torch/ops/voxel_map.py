"""Fixed-capacity voxel local map in device memory (counterpart of
the JAX package's `ops/voxel_map.py`).

Same tables, same bit layouts, same integer results as the JAX package
(the parity tests hold them bit-equal):

  keys   (C,)      int32  wrapped packed voxel coordinate, or EMPTY/DELETED
  points (C, K*3)  f32    per-voxel point rows, +inf pad ((0, 0) when
                          store_points=False)
  npts   (C,)      int32  live point count per voxel
  grid   (G,)      int32  dense toroidal index: wrapped voxel coord ->
                          (fingerprint << slot_bits | slot), -1 = absent
  packed (C, Kp)   int32  voxel-local packed point mirror (10 bits/axis in a
                          3-voxel window around the key voxel), -1 = invalid

Two rules that the JAX code relies on implicitly are explicit here:

* JAX drops a scatter whose index is out of range (`mode="drop"`); torch
  raises on the CPU and device-asserts on CUDA. Every dropping scatter
  writes its dropped entries into ONE spare element past the end of a flat
  buffer, which is sliced off (`_scatter`). No host sync, no boolean
  compaction.
* JAX gathers clamp out-of-range indices; every such gather clamps
  explicitly.

Candidates come from the packed slab for the fused GN kernels
(`gather_candidate_planes_packed`: on the card one kernel,
`kernels/candidate_fetch`, bit-equal to its plain version here) and from
the f32 slab for the classic
f64 path (`gather_candidates`, `nearest_neighbors`), which also needs the
slab for `evict_far(exact_boundary=True)`.

Kept scatter indices are unique per call (one write per voxel slot / grid
cell / packed lane), so `index_put_` without accumulation is deterministic.

Functional by default like the JAX package; with `inplace=True` the tables
of the map passed in are updated in place (the analogue of JAX buffer
donation) and must not be reused by the caller.

Batched streams (the multi-stream / Monte-Carlo path) use the same
functions: every table and input takes a leading stream axis (keys (S, C),
grid (S, G), packed (S, C, Kp), scalars (S,); points (S, N, 3)). A table
is then the front view of ONE flat (S*G + 1,) buffer, gathers and scatters
address it with stream-offset int64 indices s*G + i (what the JAX package's
`table_*` vmap rules do, voxel_map.py:302-465), sorts / cumsums / cummax
run along the last axis, and no step reads the device from the host.

Divisions by the voxel size are true f32 divisions by a device tensor: a
CUDA division by a host scalar multiplies by the reciprocal, which moves
points that lie on a voxel edge into the neighbouring voxel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MapConfig
from ..utils.profiling import annotate
from . import lie
from .kernels import candidate_fetch
from .kernels._common import on_cpu

EMPTY = -1
DELETED = -2
_KEY_BITS = 10
_KEY_MASK = (1 << _KEY_BITS) - 1
_PKL_BITS = 10
_PKL_MAX = (1 << _PKL_BITS) - 1  # 1023
_PKL_SPAN = 3.0
_PK_SENT32 = -1
_SENTINEL = (1 << 63) - 1
_IDX_BITS = 18
_LOCAL_BITS = 15
_DS_BITS = 9
_RANK_CAP = 255
_TAU_BITS = 12

I32 = torch.int32
I64 = torch.int64


def _f32(x: float) -> float:
    """A Python float holding exactly the f32 rounding of x."""
    return float(np.float32(x))


def _tdiv(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a true division in x's dtype (see module docstring). The
    divisor is filled on the device: a host-to-device copy would sync."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


class VoxelMap(NamedTuple):
    keys: torch.Tensor
    points: torch.Tensor
    npts: torch.Tensor
    tombstones: torch.Tensor  # () int32
    drops: torch.Tensor  # () int32
    grid: torch.Tensor
    next_slot: torch.Tensor  # () int32
    packed: torch.Tensor


class GroupedCloud(NamedTuple):
    """A compacted, map-voxel-grouped downsample (`fused_downsample`)."""

    points: torch.Tensor  # (M, 3) f32
    mask: torch.Tensor  # (M,) bool
    head: torch.Tensor  # (M,) bool
    head_pos: torch.Tensor  # (M,) i32
    rank: torch.Tensor  # (M,) i32
    n_unique: torch.Tensor  # () i32
    window_drops: torch.Tensor  # () i32


# ---------------------------------------------------------------------------
# creation / keys
# ---------------------------------------------------------------------------


def _grid_log2(cfg: MapConfig):
    gx, gy, gz = cfg.grid_dims
    return gx.bit_length() - 1, gy.bit_length() - 1, gz.bit_length() - 1


def _slot_bits(cfg: MapConfig) -> int:
    return max((cfg.capacity - 1).bit_length(), 1)


def create(cfg: MapConfig, device: torch.device | str = "cuda",
           streams: int | None = None) -> VoxelMap:
    """An empty map; with `streams`, S empty maps stacked on a leading axis.
    Every table is the front view of a flat buffer with one spare element."""
    c, k = cfg.capacity, cfg.max_points_per_voxel
    if cfg.voxel_size * (_KEY_MASK // 2 - 2) < 2.0 * cfg.max_range:
        raise ValueError(
            f"voxel_size {cfg.voxel_size} too small for max_range "
            f"{cfg.max_range}: wrapped {_KEY_BITS}-bit keys alias"
        )
    gx, gy, gz = cfg.grid_dims
    if cfg.voxel_size * (min(gx, gy) - 4) < 2.0 * cfg.max_range:
        raise ValueError(
            f"grid_xy {min(gx, gy)} too small for max_range {cfg.max_range} "
            f"at voxel_size {cfg.voxel_size}"
        )
    if cfg.nn_points % 2 != 0:
        raise ValueError("nn_points must be even")
    fp_bits = 3 * _KEY_BITS - sum(_grid_log2(cfg))
    if fp_bits + _slot_bits(cfg) > 31:
        raise ValueError("grid cell overflow: grow the grid or shrink capacity")
    if not cfg.store_points and not cfg.packed_nn:
        raise ValueError("store_points=False requires packed_nn=True")

    lead = () if streams is None else (streams,)

    def full(shape, fill, dtype):
        return _fresh(lead + shape, fill, dtype, device)

    scalar = torch.zeros(lead, dtype=I32, device=device)
    return VoxelMap(
        keys=full((c,), EMPTY, I32),
        points=(full((c, k * 3), float("inf"), torch.float32) if cfg.store_points
                else full((0, 0), 0.0, torch.float32)),
        npts=full((c,), 0, I32),
        tombstones=scalar.clone(),
        drops=scalar.clone(),
        grid=full((gx * gy * gz,), -1, I32),
        next_slot=scalar.clone(),
        packed=(full((c, cfg.packed_width), _PK_SENT32, I32) if cfg.packed_nn
                else full((0, 0), 0, I32)),
    )


def voxel_of(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Truncation-toward-zero voxel index (reference
    calculation_helpers.cpp:142-147): f32 division, then truncation."""
    return _tdiv(points.to(torch.float32), _f32(voxel_size)).to(I32)


def pack_key(vox: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 voxel -> wrapped non-negative int32 key in [0, 2^30)."""
    x = vox[..., 0] & _KEY_MASK
    y = vox[..., 1] & _KEY_MASK
    z = vox[..., 2] & _KEY_MASK
    return (x << (2 * _KEY_BITS)) | (y << _KEY_BITS) | z


def unpack_key_rel(key: torch.Tensor, origin_vox: torch.Tensor) -> torch.Tensor:
    """Wrapped signed voxel offset of `key` from `origin_vox` (..., 3)."""
    half = 1 << (_KEY_BITS - 1)
    out = []
    for axis, shift in ((0, 2 * _KEY_BITS), (1, _KEY_BITS), (2, 0)):
        v = (key >> shift) & _KEY_MASK
        d = (v - (origin_vox[..., axis] & _KEY_MASK)) & _KEY_MASK
        out.append(torch.where(d >= half, d - (_KEY_MASK + 1), d))
    return torch.stack(out, dim=-1).to(I32)


def grid_pos(keys: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Dense-grid cell of a packed key (each wrapped axis field wrapped
    again to the power-of-two grid dimension)."""
    gx, gy, gz = cfg.grid_dims
    x = (keys >> (2 * _KEY_BITS)) & (gx - 1)
    y = (keys >> _KEY_BITS) & (gy - 1)
    z = keys & (gz - 1)
    return (x * gy + y) * gz + z


def _fp_of(keys: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """Grid-cell fingerprint: exactly the key bits `grid_pos` discards, so
    a fingerprint match is full key verification."""
    lgx, lgy, lgz = _grid_log2(cfg)
    xhi = keys >> (2 * _KEY_BITS + lgx)
    yhi = (keys >> (_KEY_BITS + lgy)) & ((1 << (_KEY_BITS - lgy)) - 1)
    zhi = (keys >> lgz) & ((1 << (_KEY_BITS - lgz)) - 1)
    return (((xhi << (_KEY_BITS - lgy)) | yhi) << (_KEY_BITS - lgz)) | zhi


def _pkl_wrapped_key_voxel(keys, axis_shift: int, vox_axis):
    kf = (keys >> axis_shift) & _KEY_MASK
    half = 1 << (_KEY_BITS - 1)
    d = (kf - (vox_axis & _KEY_MASK) + half) & _KEY_MASK
    return vox_axis + (d - half)


def _pk_encode(x, y, z, keys, voxel_size: float) -> torch.Tensor:
    """World f32 coordinates + their stored keys -> packed i32 (10 bits/axis
    of position inside the 3-voxel window centred on the key voxel)."""
    inv = _f32(_PKL_MAX / (_PKL_SPAN * voxel_size))
    halfspan = _f32(0.5 * _PKL_SPAN * voxel_size)
    vs = _f32(voxel_size)

    def ch(c, shift):
        vox_axis = _tdiv(c, vs).to(I32)
        kv = _pkl_wrapped_key_voxel(keys, shift, vox_axis)
        local = c - kv.to(torch.float32) * vs
        q = torch.round((local + halfspan) * inv).to(I32)
        return torch.clamp(q, 0, _PKL_MAX)

    return (ch(x, 2 * _KEY_BITS) << (2 * _PKL_BITS)) | (ch(y, _KEY_BITS) << _PKL_BITS) | ch(z, 0)


def _pk_decode_axis(p, shift: int, kv_axis, aoff, voxel_size: float):
    """One axis of the packed decode, relative to the anchor (see JAX)."""
    scale = _f32(_PKL_SPAN * voxel_size / _PKL_MAX)
    halfspan = _f32(0.5 * _PKL_SPAN * voxel_size)
    q = (p >> shift) & _PKL_MAX
    local = q.to(torch.float32) * scale - halfspan
    return kv_axis.to(torch.float32) * _f32(voxel_size) + local + aoff


def _stream_offsets(lead: tuple, size: int, device) -> torch.Tensor | None:
    """Flat offsets s * size of each leading-dim row, shaped lead + (1,);
    None without a stream axis (or with one stream: all offsets are 0)."""
    b = int(np.prod(lead))
    if b == 1:
        return None
    return (torch.arange(b, dtype=I64, device=device) * size).reshape(lead + (1,))


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[..., clip(idx), ...] along the table's axis len(lead): table
    lead + (G,) + rest, idx lead + (M,) -> lead + (M,) + rest. Clamps like
    the JAX package's gathers."""
    lead = idx.shape[:-1]
    g = table.shape[len(lead)]
    rest = table.shape[len(lead) + 1:]
    fi = torch.clamp(idx.to(I64), 0, g - 1)
    offs = _stream_offsets(lead, g, idx.device)
    if offs is not None:
        fi = fi + offs
    return table.reshape((-1,) + rest)[fi.reshape(-1)].reshape(idx.shape + rest)


def _lookup(m: VoxelMap, qkeys, qvalid, cfg: MapConfig) -> torch.Tensor:
    """Grid lookup with in-cell fingerprint verification; slot or -1."""
    sb = _slot_bits(cfg)
    cell = _take(m.grid, grid_pos(qkeys, cfg))
    ok = qvalid & (cell >= 0) & ((cell >> sb) == _fp_of(qkeys, cfg))
    return torch.where(ok, cell & ((1 << sb) - 1), torch.full_like(cell, -1))


def num_voxels(m: VoxelMap) -> torch.Tensor:
    return torch.sum(m.keys >= 0, dim=-1).to(I32)


# ---------------------------------------------------------------------------
# dropping scatter
# ---------------------------------------------------------------------------


def _spare_buffer(t: torch.Tensor, inplace: bool) -> torch.Tensor:
    """A flat (numel + 1,) buffer whose first numel elements hold `t`.

    In place: when `t` is already the front view of such a buffer (every
    table this module returns is), that buffer itself; otherwise a copy."""
    n = t.numel()
    b = t._base
    if (inplace and b is not None and b.dim() == 1 and b.numel() == n + 1
            and t.is_contiguous() and b.data_ptr() == t.data_ptr()):
        return b
    b = torch.empty(n + 1, dtype=t.dtype, device=t.device)
    b[:n].copy_(t.reshape(-1))
    return b


def _scatter(t: torch.Tensor, flat_idx, vals, ok, inplace: bool,
             reduce: str | None = None) -> torch.Tensor:
    """t.flat[flat_idx[ok]] = vals[ok] (or amax with `reduce="amax"`);
    not-ok entries land in the spare element and are dropped. With leading
    stream dims lead = flat_idx.shape[:-1], flat_idx indexes each stream's
    own table t[s] (flattened)."""
    n = t.numel()
    lead = flat_idx.shape[:-1]
    b = _spare_buffer(t, inplace)
    idx = flat_idx.to(I64)
    offs = _stream_offsets(lead, n // max(int(np.prod(lead)), 1), idx.device)
    if offs is not None:
        idx = idx + offs
    idx = torch.where(ok, idx, torch.full_like(idx, n)).reshape(-1)
    vals = vals.to(t.dtype).expand(flat_idx.shape).reshape(-1)
    if reduce is None:
        b.index_put_((idx,), vals)
    else:
        b.scatter_reduce_(0, idx, vals, reduce=reduce, include_self=True)
    return b[:n].view(t.shape)


def _fresh(shape, fill, dtype, device) -> torch.Tensor:
    """A new table with a spare element behind it (see `_spare_buffer`)."""
    n = int(np.prod(shape))
    return torch.full((n + 1,), fill, dtype=dtype, device=device)[:n].view(shape)


# ---------------------------------------------------------------------------
# downsampling (reference icp.cpp:9-30)
# ---------------------------------------------------------------------------


def _first_valid(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 when none) —
    jnp.argmax(mask)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _shift_prev(a: torch.Tensor) -> torch.Tensor:
    head = torch.full(a.shape[:-1] + (1,), -9, dtype=a.dtype, device=a.device)
    return torch.cat([head, a[..., :-1]], dim=-1)


def _at_first_valid(vox: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """vox[..., argmax(mask), :] as (..., 1, 3)."""
    return _take(vox, _first_valid(mask)[..., None])


def _voxel_group_sort(vox, mask):
    """Group points by voxel with ONE int64 sort of (15-bit/axis
    anchor-relative voxel | index) — the JAX package's keys
    (voxel_map.py:492), so the same order. vox (..., N, 3) i32, mask
    (..., N). Returns (order (..., N) i64 original index per sorted
    position, group key (..., N) i64, valid_sorted (..., N), window_drops
    (...) i32)."""
    n = vox.shape[-2]
    if n > (1 << _IDX_BITS):
        raise ValueError(f"{n} points exceed the packed-sort budget")
    idx = torch.arange(n, dtype=I64, device=vox.device)
    local = (vox - _at_first_valid(vox, mask)).to(I64) + (1 << (_LOCAL_BITS - 1))
    in_window = torch.all((local >= 0) & (local < (1 << _LOCAL_BITS)), dim=-1)
    valid = mask & in_window
    window_drops = torch.sum(mask & ~in_window, dim=-1).to(I32)
    key = (local[..., 0] << (2 * _LOCAL_BITS)) | (local[..., 1] << _LOCAL_BITS) | local[..., 2]
    packed = torch.where(valid, (key << _IDX_BITS) | idx,
                         torch.full_like(key, _SENTINEL))
    s = torch.sort(packed, dim=-1).values
    return s & ((1 << _IDX_BITS) - 1), s >> _IDX_BITS, s < _SENTINEL, window_drops


def first_point_per_voxel(points, mask, voxel_size: float, out_capacity: int):
    """Keep the first valid point of each voxel (reference icp.cpp:9-30).

    `_voxel_group_sort` groups the points, a second payload sort compacts
    the winners. points (..., N, 3), mask (..., N). Returns (out_points
    (..., M, 3) f32, out_mask (..., M), n_unique (...), window_drops
    (...))."""
    n = points.shape[-2]
    lead = mask.shape[:-1]
    dev = points.device
    order, group, valid_s, window_drops = _voxel_group_sort(voxel_of(points, voxel_size), mask)

    first = valid_s & (group != _shift_prev(group))
    out_idx = torch.cumsum(first.to(I64), -1) - 1
    n_found = torch.clamp(out_idx[..., -1] + 1, min=0)
    n_unique = torch.clamp(n_found, max=out_capacity).to(I32)

    drop = ~(first & (out_idx < out_capacity))
    packed2 = (drop.to(I64) << 62) | (out_idx << _IDX_BITS) | order
    if n < out_capacity:
        packed2 = torch.cat([packed2, torch.full(lead + (out_capacity - n,), _SENTINEL,
                                                 dtype=I64, device=dev)], dim=-1)
    idx_sel = torch.sort(packed2, dim=-1).values[..., :out_capacity] & ((1 << _IDX_BITS) - 1)
    out_mask = torch.arange(out_capacity, dtype=I32, device=dev) < n_unique[..., None]
    gathered = _take(points, idx_sel)
    out = torch.where(out_mask[..., None], gathered, torch.zeros_like(gathered))
    return out, out_mask, n_unique, window_drops


@annotate("voxel_map.downsample")
def fused_downsample(points, mask, voxel_size: float, out_capacity: int,
                     tau=None) -> GroupedCloud:
    """First-point-per-(voxel/2) downsample grouped by the full voxel, from
    ONE int64 sort of (coarse | fine | [12-bit tau] | index), exactly the
    JAX package's key layout (`fused_downsample`, voxel_map.py:599). With
    `tau` the within-cell winner is the earliest point (quantized ties fall
    back to sensor order). points (..., N, 3), mask and tau (..., N)."""
    n = points.shape[-2]
    if not out_capacity <= n <= (1 << _IDX_BITS):
        raise ValueError(f"fused_downsample takes out_capacity ({out_capacity}) to "
                         f"{1 << _IDX_BITS} rows, got {n}")
    dev = points.device
    fine = voxel_of(points, 0.5 * voxel_size)
    # truncation-toward-zero halving (== voxel_of(points, voxel_size))
    coarse = (fine + ((fine >> 31) & 1)) >> 1
    fres = fine - 2 * coarse + 1

    local_c = coarse - _at_first_valid(coarse, mask) + (1 << (_DS_BITS - 1))
    in_window = torch.all((local_c >= 0) & (local_c < (1 << _DS_BITS)), dim=-1)
    valid = mask & in_window
    window_drops = torch.sum(mask & ~in_window, dim=-1).to(I32)

    lc = local_c.to(I64)
    ckey = (lc[..., 0] << (2 * _DS_BITS)) | (lc[..., 1] << _DS_BITS) | lc[..., 2]
    fkey = (fres[..., 0] << 4) | (fres[..., 1] << 2) | fres[..., 2]
    key = (ckey << 6) | fkey.to(I64)
    low_bits = _IDX_BITS
    low = torch.arange(n, dtype=I64, device=dev)
    if tau is not None:
        tmax = (1 << _TAU_BITS) - 1
        tq = torch.clamp(tau.to(torch.float32) * float(tmax), 0.0, float(tmax))
        low = (tq.to(I64) << _IDX_BITS) | low
        low_bits += _TAU_BITS
    packed = torch.where(valid, (key << low_bits) | low,
                         torch.full_like(key, _SENTINEL))
    s = torch.sort(packed, dim=-1).values

    idx_s = s & ((1 << _IDX_BITS) - 1)
    fine_key = s >> low_bits
    coarse_key = s >> (low_bits + 6)
    valid_s = s < _SENTINEL
    first = valid_s & (fine_key != _shift_prev(fine_key))
    c_first = valid_s & (coarse_key != _shift_prev(coarse_key))

    out_idx = torch.cumsum(first.to(I64), -1) - 1
    n_found = torch.clamp(out_idx[..., -1] + 1, min=0)
    n_unique = torch.clamp(n_found, max=out_capacity).to(I32)
    head_out = torch.cummax(torch.where(c_first, out_idx, torch.zeros_like(out_idx)), -1).values

    payload = ((out_idx << 37) | (head_out << 19)
               | (c_first.to(I64) << 18) | idx_s)
    drop = ~(first & (out_idx < out_capacity))
    sorted2 = torch.sort((drop.to(I64) << 62) | payload, dim=-1).values[..., :out_capacity]
    m18 = (1 << 18) - 1
    idx_sel = sorted2 & m18
    cfirst_sel = ((sorted2 >> 18) & 1).to(torch.bool)
    head_sel = ((sorted2 >> 19) & m18).to(I32)
    oidx_sel = ((sorted2 >> 37) & m18).to(I32)

    out_pts = _take(points, idx_sel).to(torch.float32)
    out_mask = torch.arange(out_capacity, dtype=I32, device=dev) < n_unique[..., None]
    return GroupedCloud(
        points=torch.where(out_mask[..., None], out_pts, torch.zeros_like(out_pts)),
        mask=out_mask,
        head=cfirst_sel & out_mask,
        head_pos=torch.clamp(head_sel, max=out_capacity - 1),
        rank=torch.clamp(oidx_sel - head_sel, 0, _RANK_CAP),
        n_unique=n_unique,
        window_drops=window_drops,
    )


# ---------------------------------------------------------------------------
# candidate fetch for the GN kernel
# ---------------------------------------------------------------------------


def _neighbor_voxels(queries, cfg: MapConfig) -> torch.Tensor:
    """(..., NB, N, 3) int32 candidate voxels of each query, neighbour-major."""
    dev = queries.device
    q = queries.to(torch.float32)
    if cfg.neighborhood == 8:
        # 2x2x2 cover of the +-half-voxel cube around the query
        half = _f32(0.5 * cfg.voxel_size)
        lo = voxel_of(q - half, cfg.voxel_size)[..., None, :, :]
        hi = voxel_of(q + half, cfg.voxel_size)[..., None, :, :]
        b = torch.arange(8, device=dev)
        offs = torch.stack([(b >> 2) & 1, (b >> 1) & 1, b & 1], dim=-1)  # ij order
        return torch.where(offs[:, None, :] == 0, lo, hi)
    b = torch.arange(27, device=dev)
    offs = torch.stack([b // 9 - 1, (b // 3) % 3 - 1, b % 3 - 1], dim=-1).to(I32)
    return voxel_of(q, cfg.voxel_size)[..., None, :, :] + offs[:, None, :]


# ---------------------------------------------------------------------------
# candidate fetch from the f32 point slab (the classic f64 path)
# ---------------------------------------------------------------------------


def _neighbor_slots(m: VoxelMap, queries, qmask, cfg: MapConfig) -> torch.Tensor:
    """Table slot of each query's candidate voxels, neighbour-minor as in
    the JAX package (voxel_map.py:757): (..., N, NB) i32, -1 = absent."""
    nbr = _neighbor_voxels(queries, cfg).transpose(-3, -2)  # (..., N, NB, 3)
    lead = queries.shape[:-2]
    n, nb = nbr.shape[-3], nbr.shape[-2]
    nkeys = pack_key(nbr).reshape(lead + (n * nb,))
    nvalid = qmask[..., None].expand(lead + (n, nb)).reshape(lead + (n * nb,))
    return _lookup(m, nkeys, nvalid, cfg).reshape(lead + (n, nb))


def gather_candidates(m: VoxelMap, queries, qmask, cfg: MapConfig):
    """Fetch each query's neighbourhood candidate blocks from the f32 slab
    (JAX voxel_map.py:726). queries (..., N, 3) f32 world frame. Returns
    (cand (..., N, NB*Kn*3) f32 flat rows, cand_valid (..., N, NB*Kn)),
    Kn = cfg.nn_points or K; absent voxels read slot 0 and are invalid."""
    if not m.points.numel():
        raise ValueError("the f32 candidate fetch requires store_points=True")
    kn = cfg.nn_points if cfg.nn_points else cfg.max_points_per_voxel
    slots = _neighbor_slots(m, queries, qmask, cfg)
    lead, (n, nb) = slots.shape[:-2], slots.shape[-2:]
    present = slots >= 0
    safe = torch.where(present, slots, torch.zeros_like(slots))
    # row prefixes by a plain row gather (JAX's `_gather_row_prefix` views the
    # rows as i64 pairs, a TPU gather trick)
    rows = _take(m.points, safe.reshape(lead + (n * nb,)))[..., :kn * 3]
    cand = rows.reshape(lead + (n, nb * kn * 3))
    cand_valid = present[..., None].expand(lead + (n, nb, kn)).reshape(lead + (n, nb * kn))
    return cand, cand_valid


def deinterleave_candidates(cand):
    """(..., N, NB*K*3) flat rows -> ((..., N, NB*K) x, y, z), once per fetch."""
    return (cand[..., 0::3].contiguous(), cand[..., 1::3].contiguous(),
            cand[..., 2::3].contiguous())


def argmin_first(d2: torch.Tensor):
    """(min, first index attaining it) along the last axis — jnp.argmin's
    tie rule, which torch.argmin does not promise on CUDA."""
    mn = torch.amin(d2, dim=-1)
    width = d2.shape[-1]
    pos = torch.arange(width, device=d2.device)
    first = torch.where(d2 == mn[..., None], pos, torch.full_like(pos, width)).amin(dim=-1)
    return mn, torch.clamp(first, max=width - 1)


def nn_from_candidates_soa(cx, cy, cz, cand_valid, qx, qy, qz, qmask):
    """Nearest candidate of each query over de-interleaved candidate planes
    (JAX voxel_map.py:922): f32 d^2 summed as (dx^2 + dy^2) + dz^2, first
    minimum wins. Returns (tx, ty, tz, nn_d2, found), each (..., N);
    not-found queries read 0 and +inf."""
    dx = cx - qx[..., None]
    dy = cy - qy[..., None]
    dz = cz - qz[..., None]
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(cand_valid, d2, torch.full_like(d2, float("inf")))
    nn_d2, best = argmin_first(d2)
    found = qmask & torch.isfinite(nn_d2)
    zero = torch.zeros_like(qx)
    pick = best[..., None]
    tx, ty, tz = (torch.where(found, torch.gather(c, -1, pick)[..., 0], zero)
                  for c in (cx, cy, cz))
    return tx, ty, tz, torch.where(found, nn_d2, torch.full_like(nn_d2, float("inf"))), found


def nn_from_candidates(cand, cand_valid, queries, qmask):
    """Distance argmin over pre-fetched flat candidates (JAX
    voxel_map.py:957). Returns (nn_points (..., N, 3) f32, nn_dist_sq (..., N)
    f32, found (..., N))."""
    q = queries.to(torch.float32)
    tx, ty, tz, d2, found = nn_from_candidates_soa(
        *deinterleave_candidates(cand), cand_valid, q[..., 0], q[..., 1], q[..., 2], qmask)
    return torch.stack([tx, ty, tz], dim=-1), d2, found


def nearest_neighbors(m: VoxelMap, queries, qmask, cfg: MapConfig):
    """True NN over each query's voxel neighbourhood (JAX voxel_map.py:983).
    Returns (nn_points (..., N, 3) f32, nn_dist_sq (..., N) f32, found)."""
    cand, cand_valid = gather_candidates(m, queries, qmask, cfg)
    return nn_from_candidates(cand, cand_valid, queries, qmask)


def gather_candidate_planes(m: VoxelMap, queries, qmask, cfg: MapConfig,
                            anchor) -> torch.Tensor:
    """Candidate fetch for the GN kernel from the f32 point slab (JAX
    voxel_map.py:792), the fused paths' fetch under `packed_nn=False`.

    queries (..., N, 3) f32 world frame; anchor (..., 3) centring offset,
    subtracted in f32 (rounded to f32 first, as JAX does). Returns
    (..., 3, NC, N) f32 candidate coordinates centred on `anchor`, NC = NB *
    Kn (Kn = cfg.nn_points or K), candidate j = nb * Kn + k — JAX's order,
    which decides the kernel's ties (it keeps the first minimum). +inf
    marks absent voxels and unused slots."""
    if not m.points.numel():
        raise ValueError("the f32 candidate fetch requires store_points=True")
    kn = cfg.nn_points if cfg.nn_points else cfg.max_points_per_voxel
    slots = _neighbor_slots(m, queries, qmask, cfg)
    lead, (n, nb) = slots.shape[:-2], slots.shape[-2:]
    present = slots >= 0
    safe = torch.where(present, slots, torch.zeros_like(slots))
    rows = _take(m.points, safe.reshape(lead + (n * nb,)))[..., :kn * 3]
    rows = torch.where(present.reshape(lead + (n * nb, 1)), rows,
                       torch.full_like(rows, float("inf")))
    planes = rows.reshape(lead + (n, nb * kn, 3)).transpose(-1, -3)  # (..., 3, NC, N)
    return planes - anchor.to(torch.float32)[..., :, None, None]


def _anchor_terms(anchor, voxel_size: float):
    """The anchor's voxel av = round(anchor / vs) (..., 3) i32 and its
    offset aoff = av * vs - anchor (..., 3), in f64, rounded to f32."""
    a64 = anchor.to(torch.float64)
    av = torch.round(_tdiv(a64, voxel_size)).to(I32)
    return av, (av.to(torch.float64) * voxel_size - a64).to(torch.float32)


def gather_candidate_planes_packed_plain(m: VoxelMap, queries, qmask, cfg: MapConfig,
                                         anchor) -> torch.Tensor:
    """Plain PyTorch version of `gather_candidate_planes_packed` (any
    device; the CPU path, and the card's tests' yardstick)."""
    kn = cfg.packed_width
    n = queries.shape[-2]
    lead = queries.shape[:-2]
    nbr = _neighbor_voxels(queries, cfg)  # (..., NB, N, 3)
    nb = nbr.shape[-3]
    nkeys = pack_key(nbr).reshape(lead + (nb * n,))
    slots = _lookup(m, nkeys, qmask.repeat((1,) * len(lead) + (nb,)), cfg)
    present = slots >= 0
    safe = torch.where(present, slots, torch.zeros_like(slots))
    pk = _take(m.packed, safe).transpose(-1, -2)  # (..., Kp, NB*N)
    pk = torch.where(present[..., None, :], pk, torch.full_like(pk, _PK_SENT32))
    vs = cfg.voxel_size
    av, aoff = _anchor_terms(anchor, vs)
    aoff = aoff[..., None, None]
    kv_rel = (nbr - av[..., None, None, :]).reshape(lead + (nb * n, 3))
    bad = pk < 0
    inf = torch.full(pk.shape, float("inf"), dtype=torch.float32, device=pk.device)
    planes = torch.stack([
        torch.where(bad, inf, _pk_decode_axis(pk, shift, kv_rel[..., None, :, axis],
                                              aoff[..., axis, :, :], vs))
        for axis, shift in ((0, 2 * _PKL_BITS), (1, _PKL_BITS), (2, 0))
    ], dim=-3)  # (..., 3, Kp, NB*N)
    return planes.reshape(lead + (3, kn * nb, n))


def gather_candidate_planes_packed(m: VoxelMap, queries, qmask, cfg: MapConfig,
                                   anchor) -> torch.Tensor:
    """Candidate fetch for the GN kernel from the packed i32 slab.

    queries (..., N, 3) world frame (used in f32); qmask (..., N) bool;
    anchor (..., 3) centering offset (any dtype; used in f64). Returns
    (..., 3, NC, N) f32 candidate coordinates centred on `anchor`, NC = Kp *
    NB, candidate j = kp * NB + nb — the JAX package's (3, NC, N/128, 128)
    planes without the lane split. +inf marks absent voxels and unused
    lanes (they lose the kernel's running min). CPU tensors: the plain
    version; CUDA tensors: the fetch kernel (`kernels/candidate_fetch`),
    bit-equal to it, with the anchor's two terms computed here."""
    if on_cpu(queries, qmask, anchor, m.grid, m.packed):
        return gather_candidate_planes_packed_plain(m, queries, qmask, cfg, anchor)
    av, aoff = _anchor_terms(anchor, cfg.voxel_size)
    return candidate_fetch.candidate_fetch(
        m.grid, m.packed, queries.to(torch.float32).contiguous(), qmask.contiguous(), av, aoff,
        **fetch_geometry(cfg))


def fetch_geometry(cfg: MapConfig) -> dict:
    """The fetch kernel's map geometry: the neighbourhood, the grid's log2
    dimensions, the slot bits and the decode's f32 constants (voxel size,
    half a voxel, a packed lane's scale, half the packed window)."""
    vs = cfg.voxel_size
    decode = (_f32(vs), _f32(0.5 * vs), _f32(_PKL_SPAN * vs / _PKL_MAX),
              _f32(0.5 * _PKL_SPAN * vs))
    return dict(neighborhood=cfg.neighborhood, grid_log2=_grid_log2(cfg),
                slot_bits=_slot_bits(cfg), decode=decode)


# ---------------------------------------------------------------------------
# insert (reference voxel_hash_map.cpp:12-62)
# ---------------------------------------------------------------------------


def _write_rows(m: VoxelMap, g: GroupedCloud, keys, row, pos, ok, cfg: MapConfig,
                inplace: bool):
    """Write the kept rows' points into the f32 slab and the packed slab."""
    k = cfg.max_points_per_voxel
    cap = cfg.capacity
    new_points = m.points
    if m.points.numel():
        for c in range(3):
            new_points = _scatter(new_points, row * (3 * k) + pos * 3 + c,
                                  g.points[..., c], ok & (row < cap), inplace)
    new_packed = m.packed
    if cfg.packed_nn:
        kp = cfg.packed_width
        pk = _pk_encode(g.points[..., 0], g.points[..., 1], g.points[..., 2], keys,
                        cfg.voxel_size)
        new_packed = _scatter(m.packed, row * kp + pos, pk,
                              ok & (row < cap) & (pos < kp), inplace)
    return new_points, new_packed


def _insert_grouped_compact(m: VoxelMap, g: GroupedCloud, cfg: MapConfig, keys,
                            inplace: bool) -> VoxelMap:
    """`insert_grouped` with the per-voxel accesses at head width
    H = cfg.max_insert_voxels (JAX voxel_map.py:998). Groups beyond H (in
    voxel-key order) are dropped whole and counted in `drops`."""
    k = cfg.max_points_per_voxel
    capacity = cfg.capacity
    mrows = g.points.shape[-2]
    h_cap = cfg.max_insert_voxels
    sb = _slot_bits(cfg)
    dev = keys.device

    active_head = g.head & g.mask
    hp = torch.where(active_head, torch.arange(mrows, dtype=I64, device=dev),
                     torch.full_like(active_head, mrows, dtype=I64))
    heads_ext = torch.sort(hp, dim=-1).values[..., : h_cap + 1].to(I32)
    heads_idx = heads_ext[..., :h_cap]
    valid_h = heads_idx < mrows
    n_heads_total = torch.sum(active_head, dim=-1).to(I32)
    capped = torch.clamp(n_heads_total - h_cap, min=0)

    safe_row = torch.clamp(heads_idx, max=mrows - 1)
    keys_h = torch.where(valid_h, _take(keys, safe_row), torch.zeros_like(heads_idx))
    fp_h = _fp_of(keys_h, cfg)
    gp_h = grid_pos(keys_h, cfg)

    cell = _take(m.grid, torch.where(valid_h, gp_h, torch.zeros_like(gp_h)))
    found = valid_h & (cell >= 0) & ((cell >> sb) == fp_h)
    missing = valid_h & ~found
    rank_m = (torch.cumsum(missing.to(I32), -1) - 1).to(I32)
    cand_slot = m.next_slot[..., None] + rank_m
    alloc = missing & (cand_slot < capacity)
    n_missing = torch.sum(missing, dim=-1).to(I32)
    new_next = torch.clamp(m.next_slot + n_missing, max=capacity).to(I32)
    dropped = (torch.sum(missing & ~alloc, dim=-1) + capped).to(I32)

    minus1 = torch.full_like(cand_slot, -1)
    head_slot = torch.where(found, cell & ((1 << sb) - 1),
                            torch.where(alloc, cand_slot, minus1))
    ok_head = valid_h & (head_slot >= 0)

    slot_safe = torch.where(ok_head, head_slot, torch.zeros_like(head_slot))
    base_h = torch.where(ok_head, _take(m.npts, slot_safe), torch.zeros_like(head_slot))
    n_valid_rows = torch.sum(g.mask, dim=-1).to(I32)
    next_row = torch.minimum(heads_ext[..., 1:], n_valid_rows[..., None])
    gsize = torch.clamp(next_row - heads_idx, min=0)
    new_count = torch.clamp(base_h + gsize, max=k)

    new_grid = _scatter(m.grid, gp_h, (fp_h << sb) | cand_slot, alloc, inplace)
    new_keys = _scatter(m.keys, head_slot, keys_h, ok_head, inplace)
    new_npts = _scatter(m.npts, head_slot, new_count, ok_head, inplace, reduce="amax")

    # members: head ordinal by running count, one gather of the packed
    # per-head info word (slot | base 4b | ok 1b)
    info_h = (head_slot << 5) | (base_h << 1) | ok_head.to(I32)
    h_ord = (torch.cumsum(active_head.to(I32), -1) - 1).to(I32)
    info = _take(info_h, torch.clamp(h_ord, 0, h_cap - 1))
    ok = g.mask & (h_ord >= 0) & (h_ord < h_cap) & ((info & 1) == 1)
    zero = torch.zeros_like(info)
    slot = torch.where(ok, info >> 5, zero)
    base = torch.where(ok, (info >> 1) & 0xF, zero)
    pos = base + g.rank
    ok = ok & (pos < k)
    row = torch.where(ok, slot, torch.full_like(slot, capacity))
    new_points, new_packed = _write_rows(m, g, keys, row, pos, ok, cfg, inplace)
    return VoxelMap(new_keys, new_points, new_npts, m.tombstones,
                    (m.drops + dropped).to(I32), new_grid, new_next, new_packed)


@annotate("voxel_map.insert")
def insert_grouped(m: VoxelMap, g: GroupedCloud, cfg: MapConfig, keys=None,
                   inplace: bool = False) -> VoxelMap:
    """Insert a pre-grouped compacted cloud (`fused_downsample` output).

    Within a voxel, earlier positions win the block's remaining capacity
    (reference voxel_hash_map.cpp:48-61). Missing voxels take bump-cursor
    slots; a resurrected (evicted) slot restarts at row 0 through its stale
    grid cell. See JAX voxel_map.py:1108 for the design."""
    k = cfg.max_points_per_voxel
    capacity = cfg.capacity
    if keys is None:
        keys = pack_key(voxel_of(g.points, cfg.voxel_size))
    if (0 < cfg.max_insert_voxels < g.points.shape[-2] and k <= 15
            and _slot_bits(cfg) <= 26):
        return _insert_grouped_compact(m, g, cfg, keys, inplace)
    sb = _slot_bits(cfg)
    fp = _fp_of(keys, cfg)
    gp = grid_pos(keys, cfg)

    active_head = g.head & g.mask
    cell = _take(m.grid, gp)
    found = active_head & (cell >= 0) & ((cell >> sb) == fp)
    missing = active_head & ~found
    rank_m = (torch.cumsum(missing.to(I32), -1) - 1).to(I32)
    cand_slot = m.next_slot[..., None] + rank_m
    alloc = missing & (cand_slot < capacity)
    n_missing = torch.sum(missing, dim=-1).to(I32)
    new_next = torch.clamp(m.next_slot + n_missing, max=capacity).to(I32)
    dropped = torch.sum(missing & ~alloc, dim=-1).to(I32)

    head_slot = torch.where(found, cell & ((1 << sb) - 1),
                            torch.where(alloc, cand_slot, torch.full_like(cand_slot, -1)))
    ok_head = active_head & (head_slot >= 0)
    new_grid = _scatter(m.grid, gp, (fp << sb) | cand_slot, alloc, inplace)
    new_keys = _scatter(m.keys, head_slot, keys, ok_head, inplace)

    # resolve every row through the updated grid; base = pre-insert count
    cell2 = _take(new_grid, gp)
    ok = g.mask & (cell2 >= 0) & ((cell2 >> sb) == fp)
    zero = torch.zeros_like(cell2)
    slot = torch.where(ok, cell2 & ((1 << sb) - 1), zero)
    base = torch.where(ok, _take(m.npts, slot), zero)
    pos = base + g.rank
    ok = ok & (pos < k)
    row = torch.where(ok, slot, torch.full_like(slot, capacity))
    new_points, new_packed = _write_rows(m, g, keys, row, pos, ok, cfg, inplace)
    new_npts = _scatter(m.npts, row, pos + 1, ok, inplace, reduce="amax")
    return VoxelMap(new_keys, new_points, new_npts, m.tombstones,
                    (m.drops + dropped).to(I32), new_grid, new_next, new_packed)


def insert(m: VoxelMap, points, mask, cfg: MapConfig) -> VoxelMap:
    """Insert world-frame points (..., N, 3), at most K per voxel: the
    sort-based grouping wrapper around `insert_grouped` (JAX
    voxel_map.py:1213)."""
    n = points.shape[-2]
    dev = points.device
    order, group, valid_s, wdrops = _voxel_group_sort(voxel_of(points, cfg.voxel_size), mask)
    idxs = torch.arange(n, dtype=I64, device=dev)
    first = valid_s & (group != _shift_prev(group))
    seg_start = torch.cummax(torch.where(first, idxs, torch.zeros_like(idxs)), -1).values
    g = GroupedCloud(
        points=_take(points, order).to(torch.float32),  # sentinel order clamps
        mask=valid_s,
        head=first,
        head_pos=seg_start.to(I32),
        rank=(idxs - seg_start).to(I32),
        n_unique=torch.sum(first, dim=-1).to(I32),
        window_drops=wdrops,
    )
    return insert_grouped(m, g, cfg)


# ---------------------------------------------------------------------------
# eviction (reference voxel_hash_map.cpp:146-171) / compaction
# ---------------------------------------------------------------------------


@annotate("voxel_map.evict")
def evict_far(m: VoxelMap, origin, cfg: MapConfig, exact_boundary: bool = False,
              inplace: bool = False) -> VoxelMap:
    """Tombstone voxels whose voxel-index distance (scaled to metres) from
    `origin` (..., 3) exceeds max_range. The grid is left untouched (a stale
    cell resolves to the tombstoned slot, whose rows read as empty).

    `exact_boundary` (JAX voxel_map.py:1295-1334; needs the f32 slab)
    instead removes the far points of far-gated voxels, compacts each
    voxel's kept points to the front (stable), tombstones the voxels left
    empty and re-encodes the packed slab from the compacted rows. It always
    returns fresh tables."""
    occupied = m.keys >= 0
    origin_vox = voxel_of(origin.to(torch.float32), cfg.voxel_size)[..., None, :]
    dvox = unpack_key_rel(torch.where(occupied, m.keys, torch.zeros_like(m.keys)),
                          origin_vox).to(torch.float32) * _f32(cfg.voxel_size)
    d2 = dvox[..., 0] * dvox[..., 0] + dvox[..., 1] * dvox[..., 1] + dvox[..., 2] * dvox[..., 2]
    far = occupied & (d2 > _f32(cfg.max_range**2))
    if exact_boundary:
        return _evict_exact(m, origin, occupied, far, cfg)
    tomb = (m.tombstones + torch.sum(far, dim=-1)).to(I32)
    if inplace:
        m.keys.masked_fill_(far, DELETED)
        if m.points.numel():
            m.points.masked_fill_(far[..., None], float("inf"))
        if m.packed.numel():
            m.packed.masked_fill_(far[..., None], _PK_SENT32)
        m.npts.masked_fill_(far, 0)
        return m._replace(tombstones=tomb)

    def keep_spare(t, fill, sel):
        return _with_spare(t).masked_fill_(sel, fill)

    return VoxelMap(
        keep_spare(m.keys, DELETED, far),
        keep_spare(m.points, float("inf"), far[..., None]) if m.points.numel() else m.points,
        keep_spare(m.npts, 0, far),
        tomb,
        m.drops,
        m.grid,
        m.next_slot,
        keep_spare(m.packed, _PK_SENT32, far[..., None]) if m.packed.numel() else m.packed,
    )


def _with_spare(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` as the front view of a flat buffer with a spare element."""
    return _spare_buffer(t, False)[: t.numel()].view(t.shape)


def _evict_exact(m: VoxelMap, origin, occupied, far, cfg: MapConfig) -> VoxelMap:
    """The `exact_boundary` branch of `evict_far`."""
    if not m.points.numel():
        raise ValueError("exact_boundary eviction requires store_points=True")
    c, k = cfg.capacity, cfg.max_points_per_voxel
    lead = m.keys.shape[:-1]
    dev = m.keys.device
    pts = m.points.reshape(lead + (c, k, 3))
    col = torch.arange(k, dtype=I32, device=dev)
    live = col < m.npts[..., None]
    d = pts - origin.to(torch.float32)[..., None, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    keep = live & ~(far[..., None] & (d2 > _f32(cfg.max_range**2)))

    # compact kept points to the front of each block (stable by position)
    perm = torch.argsort(torch.where(keep, 0, 1) * k + col, dim=-1)
    pts_c = torch.gather(pts, -2, perm[..., None].expand(pts.shape))
    new_npts = torch.where(occupied, torch.sum(keep, dim=-1).to(I32), torch.zeros_like(m.npts))
    live_c = col < new_npts[..., None]
    pts_c = torch.where(live_c[..., None], pts_c, torch.full_like(pts_c, float("inf")))

    emptied = occupied & (new_npts == 0) & far
    new_keys = torch.where(emptied, torch.full_like(m.keys, DELETED), m.keys)
    new_packed = m.packed
    if m.packed.numel():
        # rows moved: re-encode from the compacted coordinates (the +inf pad
        # lanes encode garbage and are masked out)
        kp = cfg.packed_width
        enc = _pk_encode(pts_c[..., 0], pts_c[..., 1], pts_c[..., 2],
                         torch.clamp(new_keys, min=0)[..., None], cfg.voxel_size)
        new_packed = _with_spare(torch.where(live_c[..., :kp], enc[..., :kp],
                                             torch.full_like(enc[..., :kp], _PK_SENT32)))
    return VoxelMap(
        _with_spare(new_keys),
        _with_spare(pts_c.reshape(lead + (c, k * 3))),
        _with_spare(new_npts),
        (m.tombstones + torch.sum(emptied, dim=-1)).to(I32),
        m.drops,
        m.grid,
        m.next_slot,
        new_packed,
    )


def update(m: VoxelMap, points, mask, pose, cfg: MapConfig) -> VoxelMap:
    """Transform by `pose` (..., 4, 4) f64, insert, evict (JAX
    voxel_map.py:1337; reference voxel_hash_map.cpp:132-144)."""
    world = (lie.rotate_points(pose[..., None, :3, :3], points.to(torch.float64))
             + pose[..., None, :3, 3]).to(torch.float32)
    return evict_far(insert(m, world, mask, cfg), pose[..., :3, 3], cfg)


def export_points(m: VoxelMap, cfg: MapConfig, origin=None):
    """The full map cloud (JAX voxel_map.py:1351; reference
    voxel_hash_map.cpp:173-198): ((C*K, 3) f32, mask). Without the f32 slab
    the cloud is decoded from the packed slab (voxel-local quantization, at
    most `packed_width` points per voxel), with the wrapped keys unwrapped
    around `origin` (3,) (default: the world origin)."""
    dev = m.keys.device
    occ = (m.keys >= 0)[:, None]
    if m.points.numel():
        k = cfg.max_points_per_voxel
        pts = m.points.reshape(cfg.capacity * k, 3)
    else:
        k = cfg.packed_width
        origin_vox = (voxel_of(torch.as_tensor(origin, dtype=torch.float32, device=dev),
                               cfg.voxel_size)
                      if origin is not None else torch.zeros(3, dtype=I32, device=dev))
        kv = unpack_key_rel(torch.clamp(m.keys, min=0), origin_vox) + origin_vox
        pts = torch.stack([
            _pk_decode_axis(m.packed, shift, kv[:, axis:axis + 1], 0.0, cfg.voxel_size)
            for axis, shift in ((0, 2 * _PKL_BITS), (1, _PKL_BITS), (2, 0))
        ], dim=-1).reshape(cfg.capacity * k, 3)
        occ = occ & (m.packed >= 0)
    col = torch.arange(k, dtype=I32, device=dev)
    mask = ((col < torch.clamp(m.npts, max=k)[:, None]) & occ).reshape(-1)
    return torch.where(mask[:, None], pts, torch.zeros_like(pts)), mask


def rebuild(m: VoxelMap, cfg: MapConfig) -> VoxelMap:
    """Compact live slots to the front of the slab (reclaims evicted
    slots): order-preserving move, dense grid regenerated, cursor reset."""
    dev = m.keys.device
    lead = m.keys.shape[:-1]
    occupied = m.keys >= 0
    live_keys = torch.where(occupied, m.keys, torch.zeros_like(m.keys))
    rank = (torch.cumsum(occupied.to(I32), -1) - 1).to(I32)

    def moved(t, fill):
        row = t.shape[-1] if t.dim() == len(lead) + 2 else 1
        out = _fresh(t.shape, fill, t.dtype, dev)
        cols = torch.arange(row, device=dev, dtype=I64)
        flat = (rank.to(I64)[..., None] * row + cols).reshape(lead + (-1,))
        ok = occupied[..., None].expand(occupied.shape + (row,)).reshape(lead + (-1,))
        return _scatter(out, flat, t.reshape(lead + (-1,)), ok, inplace=True)

    new_keys = moved(m.keys, EMPTY)
    pts = moved(m.points, float("inf")) if m.points.numel() else m.points
    npts = moved(torch.where(occupied, m.npts, torch.zeros_like(m.npts)), 0)
    sb = _slot_bits(cfg)
    grid = _scatter(_fresh(m.grid.shape, -1, I32, dev), grid_pos(live_keys, cfg),
                    (_fp_of(live_keys, cfg) << sb) | rank, occupied, inplace=True)
    packed = moved(m.packed, _PK_SENT32) if m.packed.numel() else m.packed
    n_live = torch.sum(occupied, dim=-1).to(I32)
    return VoxelMap(new_keys, pts, npts, torch.zeros(lead, dtype=I32, device=dev),
                    m.drops, grid, n_live, packed)

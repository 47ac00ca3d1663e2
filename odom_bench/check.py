"""The comparison that decides `correct`.

The reference (`reference/odometry.py`) follows the compared streams scan
by scan along the port's own trajectory: at every step it registers the
same raw scans itself, from the port's previous poses and its own map,
and reports its own pose and threshold; then it carries the port's pose
(not its own) into its state and map. The port's poses are thus fed to
the reference; the first scan of a stream, from a fresh state, is compared
with nothing carried. (A reference left to its own poses parts from the
port by chaos: a pose a micrometre off moves a point across a voxel face,
a different point wins a cell, and the two maps part for good.)
Compared:

* pose_gap_m, pose_gap_rad: the largest gap between the port's pose of a
  scan and the reference's registration of that scan, over every scan of
  the compared streams;
* sigma_gap_rel: the largest relative gap of the adaptive threshold sigma
  the port used for a scan against the reference's, worked out from the
  port's poses in f64: it holds the threshold's bookkeeping across scans
  and the precision of the pose chain;
* map_off_share: the share of the points of the two maps, at the end, of
  which the other map holds no point within 1 mm in the same voxel;
* ref_out_of_box: points the reference's grid could not hold (its limit
  is 0: a trajectory that leaves the box is no sound run);
* scans_compared: how many poses were compared (a lower limit).

Each limit is set in the configuration's file from the readings PERF.md
gives."""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.odometry import DenseMap, unpack_code

MATCH_TOL_M = 1e-3
_KEY_BITS, _KEY_MASK = 10, 1023


def pose_gaps(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """Largest translation (m) and rotation (rad) gap of two pose stacks."""
    dt = torch.linalg.norm(a[..., :3, 3] - b[..., :3, 3], dim=-1)
    rel = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    cos = (rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2] - 1.0) / 2.0
    skew = torch.stack([rel[..., 2, 1] - rel[..., 1, 2], rel[..., 0, 2] - rel[..., 2, 0],
                        rel[..., 1, 0] - rel[..., 0, 1]], -1) / 2.0
    dr = torch.atan2(torch.linalg.norm(skew, dim=-1), cos)
    return float(dt.max()), float(dr.max())


def sigma_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    return float((torch.abs(port - ref) / torch.abs(ref)).max())


def key_voxels(keys, pose_t, vs: float):
    """int64 voxels (B, C, 3) of wrapped 10-bit voxel keys (B, C), unwrapped
    around the voxel of pose_t (B, 3), the stream's last position."""
    dev = keys.device
    ov = torch.div(pose_t.to(torch.float32), torch.full((), vs, device=dev),
                   ).to(torch.int32).to(torch.int64)
    kk = keys.to(torch.int64)
    axes = []
    for axis, shift in ((0, 2 * _KEY_BITS), (1, _KEY_BITS), (2, 0)):
        field = (kk >> shift) & _KEY_MASK
        d = (field - (ov[:, axis, None] & _KEY_MASK)) & _KEY_MASK
        axes.append(ov[:, axis, None] + torch.where(d >= 512, d - 1024, d))
    return torch.stack(axes, -1)


def port_map_dense(keys, points, npts, pose_t, vs: float, like: DenseMap):
    """The port's map tables of B streams (keys (B, C) wrapped 10-bit
    voxel keys, points (B, C, K*3), npts (B, C)) laid out on the
    reference's grid: (points (B, G + 1, K, 3), counts (B, G + 1)). Keys
    unwrap around the voxel of pose_t (B, 3), the stream's last position."""
    b, c = keys.shape
    k = like.k
    dev = keys.device
    vox = key_voxels(keys, pose_t, vs)
    live = (keys >= 0) & (npts > 0)
    cell, inside = like.index(vox)
    cell = torch.where(live & inside, cell, torch.full_like(cell, like.cells))
    pts = torch.full((b, like.cells + 1, k, 3), math.inf, dtype=torch.float32, device=dev)
    cnt = torch.zeros((b, like.cells + 1), dtype=torch.int32, device=dev)
    rows = points.reshape(b, c, -1, 3)[:, :, :k]
    bi = torch.arange(b, device=dev)[:, None].expand(b, c)
    pts[bi, cell] = rows
    cnt[bi, cell] = torch.clamp(npts, max=k).to(torch.int32)
    pts[:, like.cells] = math.inf
    cnt[:, like.cells] = 0
    lost = torch.sum(live & ~inside).item()
    return pts, cnt, int(lost)


def packed_points(keys, packed, pose_t, vs: float):
    """The points (B, C, Kp * 3) f32 of the port's packed mirror (B, C, Kp)
    of 10-bit codes an axis, decoded in each slot's voxel as `unpack_code`
    decodes the reference's (lanes past a voxel's count read as garbage;
    the count masks them)."""
    vox = key_voxels(keys, pose_t, vs)[:, :, None, :]
    p = packed.to(torch.int64)[..., None]
    code = torch.cat([(p >> 20) & _KEY_MASK, (p >> 10) & _KEY_MASK, p & _KEY_MASK], -1)
    return unpack_code(code, vox, vs).reshape(packed.shape[0], packed.shape[1], -1)


def map_mismatch(ref: DenseMap, port_pts, port_cnt, chunk: int = 1 << 17):
    """(unmatched points, all points) of each stream's two maps: a point is
    matched when the other map holds a point of the same voxel within
    MATCH_TOL_M in every coordinate. Returns two int64 numpy arrays (B,)."""
    g = ref.cells
    occ = (ref.cnt[:, :g] > 0) | (port_cnt[:, :g] > 0)
    bi, ci = occ.nonzero(as_tuple=True)
    b = ref.cnt.shape[0]
    off = torch.zeros(b, dtype=torch.int64, device=bi.device)
    tot = torch.zeros_like(off)
    lane = torch.arange(ref.k, device=bi.device)
    for s in range(0, bi.numel(), chunk):
        bb, cc = bi[s:s + chunk], ci[s:s + chunk]
        rp, pp = ref.pts[bb, cc], port_pts[bb, cc]
        rv = lane < ref.cnt[bb, cc, None]
        pv = lane < port_cnt[bb, cc, None]
        d = torch.amax(torch.abs(rp[:, :, None, :] - pp[:, None, :, :]), -1)
        close = (d <= MATCH_TOL_M) & rv[:, :, None] & pv[:, None, :]
        miss = (rv & ~close.any(2)).sum(1) + (pv & ~close.any(1)).sum(1)
        off.index_add_(0, bb, miss.to(torch.int64))
        tot.index_add_(0, bb, (rv.sum(1) + pv.sum(1)).to(torch.int64))
    return off.cpu().numpy(), tot.cpu().numpy()


def compare(poses, own, sigmas, ref_sig, cols, ref_map: DenseMap, port_pts, port_cnt,
            lost: int, like: DenseMap | None = None) -> tuple[dict, dict]:
    """(numbers, detail) of the compared streams `cols`: the port's poses
    (steps, S, 4, 4) and sigmas (steps, S), the reference's own (steps, B,
    4, 4) and ref_sig (steps, B), and the port's maps laid out on the grid
    of `like` (default ref_map) by `port_map_dense`, with `lost` points
    off it."""
    like = ref_map if like is None else like
    gap_m, gap_rad = pose_gaps(poses[:, cols], own)
    off, tot = map_mismatch(like, port_pts, port_cnt)
    numbers = {
        "pose_gap_m": gap_m,
        "pose_gap_rad": gap_rad,
        "sigma_gap_rel": sigma_gap(sigmas[:, cols], ref_sig),
        "map_off_share": float(off.sum() / max(tot.sum(), 1)),
        "ref_out_of_box": float(ref_map.out_of_box.sum().item() + lost),
        "scans_compared": float(own.shape[0] * own.shape[1]),
    }
    detail = {"streams": cols.tolist(), "map_off_per_stream": off.tolist(),
              "map_points_per_stream": tot.tolist()}
    return numbers, detail


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): each number beside its limit; `scans_compared`
    is a lower limit, every other number an upper one. A number that is not
    finite fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        good = bool(np.isfinite(value)) and (value >= limit if name == "scans_compared"
                                             else value <= limit)
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks

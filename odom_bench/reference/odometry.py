"""Plain PyTorch reference of the batched KISS-ICP odometry step, written
from the configuration's stated semantics. It imports nothing of the port
and takes nothing the port made: it reads raw scans and the configuration's
values (the `pipeline` dict of a configuration file), and keeps its own
map, a dense voxel grid per stream.

One call of `RefOdometry.step` registers one scan of each of B streams:

1. preprocess: range gate on the squared range, per-point time (the scan's
   own times when any is positive, else the constant-rotation model per
   ring), time sort (ties by sensor order) where the configuration sorts,
   tau in [0, 1];
2. constant-velocity deskew by exp((tau - 0.5) log(T_{n-2}^-1 T_{n-1})),
   from the third scan on, in f32;
3. the guess T_{n-1} (T_{n-2}^-1 T_{n-1}) and the adaptive threshold sigma
   (KISS-ICP: the RMS of 2 r sin(theta / 2) + |t| of past model
   deviations above min_motion_th, once the sensor has moved);
4. the world transform at the guess; the map-insert downsample: the first
   point (in time order, by 12-bit tau for unsorted scans) of each
   half-voxel cell, cells in (voxel, cell) coordinate order, the first
   max_map_points kept; the ICP source: the first of those per 1.5-voxel
   cell, in cell order, the first max_source_points kept, then the Tukey
   IQR fence (1.25) on the squared distance to the guess;
5. the fixed ICP schedule: `outer` candidate fetches from the 2 x 2 x 2
   voxel block around each query (the first `nn_points` of each voxel, all
   where it is 0; quantized to 10 bits an axis in the 3-voxel window of
   their voxel when the map keeps its packed mirror), each followed by
   `inner` robust point-to-point Gauss-Newton iterations (nearest
   candidate in f32, weight (k / (k + r^2))^2 with k = sigma / 3, pairs
   within 3 sigma, f64 sums and 6 x 6 solve with a 1e-6 relative ridge
   on the rotation-scaled normal matrix, step clamped to max_step_norm,
   stop below estimation_threshold or under min_correspondences, a round
   abandoned once its translation drifts past half a voxel); rounds apply
   to streams not yet converged;
6. the divergence gate (keep the guess beyond max_model_deviation) and
   re-orthonormalization;
7. the map update by the correction: each downsampled point, moved by
   T_n T_guess^-1, is appended to the voxel it fell in before the
   correction while the voxel holds fewer than max_points_per_voxel;
   voxels are allocated in insert order while fewer than `capacity` were
   ever allocated (an evicted voxel that comes back reuses its own);
   voxels whose voxel distance from T_n exceeds max_range are evicted.

Voxel indices truncate toward zero (reference calculation_helpers.cpp),
by a true f32 division.

`forced` poses make the reference follow a given trajectory: it still
registers each scan itself and reports its own pose, but carries the
given pose into its state and map. Poses, threshold sums and the solve
run in `pose_dtype` (f64 as the configuration states; the control runs
f32).
"""

from __future__ import annotations

import copy
import math

import torch

F32, F64 = torch.float32, torch.float64
I64 = torch.int64
IQR_K = 1.25
TAU_MAX = (1 << 12) - 1
_PK_MAX = 1023
_PK_SPAN = 3.0


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=F32))


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a true division in x's dtype by a device scalar."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def voxel(points: torch.Tensor, size: float) -> torch.Tensor:
    """Truncation-toward-zero voxel index of f32 points, int64."""
    return _div(points.to(F32), _f32(size)).to(torch.int32).to(I64)


def pack_code(points, vox, vs: float):
    """The packed mirror's code of f32 points (..., 3) in their voxel vox
    (..., 3) int64: each axis quantized to 10 bits over the 3-voxel window
    centred on the voxel, as an f32 integer in [0, 1023]."""
    kv = vox.to(F32) * _f32(vs)
    inv = _f32(_PK_MAX / (_PK_SPAN * vs))
    return torch.clamp(torch.round((points - kv + _f32(0.5 * _PK_SPAN * vs)) * inv), 0, _PK_MAX)


def unpack_code(code, vox, vs: float):
    """f32 points (..., 3) of packed codes (..., 3) in voxel vox (..., 3)."""
    scale, halfspan = _f32(_PK_SPAN * vs / _PK_MAX), _f32(0.5 * _PK_SPAN * vs)
    return vox.to(F32) * _f32(vs) + (code.to(F32) * scale - halfspan)


# ---------------------------------------------------------------------------
# rigid-motion helpers (any float dtype, leading dims)
# ---------------------------------------------------------------------------


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                        -w[..., 1], w[..., 0], z], -1).reshape(w.shape[:-1] + (3, 3))


def _eye(lead, dtype, device, n=4):
    return torch.eye(n, dtype=dtype, device=device).expand(tuple(lead) + (n, n))


def rt(R, t):
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def quat(R):
    """Unit quaternion (w, x, y, z), w >= 0, of rotations R: the
    numerically largest of the four trace combinations picks the formula."""
    m = R
    t = torch.stack([1 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2],
                     1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    a = m[..., 2, 1] - m[..., 1, 2]
    b = m[..., 0, 2] - m[..., 2, 0]
    c = m[..., 1, 0] - m[..., 0, 1]
    d = m[..., 1, 0] + m[..., 0, 1]
    e = m[..., 0, 2] + m[..., 2, 0]
    f = m[..., 2, 1] + m[..., 1, 2]
    cands = torch.stack([torch.stack([t[..., 0], a, b, c], -1),
                         torch.stack([a, t[..., 1], d, e], -1),
                         torch.stack([b, d, t[..., 2], f], -1),
                         torch.stack([c, e, f, t[..., 3]], -1)], -2)
    best = torch.argmax(t, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot_log(R):
    """Rotation vector of R, for rotations below pi (the relative motions
    of one scan): the angle from the skew part and the trace, the axis
    from the skew part."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2
    sn = torch.linalg.norm(v, dim=-1)
    th = torch.atan2(sn, (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2)
    small = sn < 1e-12
    return v * torch.where(small, 1 + th * th / 6, th / torch.where(small, 1.0, sn))[..., None]


def _exp_coeffs(w):
    """(|w|^2, sin(th)/th, (1 - cos th)/th^2, (th - sin th)/th^3) with
    their series below th^2 = 1e-12."""
    sq = torch.sum(w * w, -1)
    small = sq < 1e-12
    safe = torch.where(small, 1.0, sq)
    th = torch.sqrt(safe)
    sin = torch.sin(th)
    a = torch.where(small, 1 - sq / 6, sin / th)
    b = torch.where(small, 0.5 - sq / 24, (1 - torch.cos(th)) / safe)
    c = torch.where(small, 1.0 / 6 - sq / 120, (th - sin) / (safe * th))
    return sq, a, b, c


def se3_exp(v, w):
    """exp of the twist (v, w): (R, t) with t = V(w) v, W^2 = w w^T -
    |w|^2 I."""
    sq, a, b, c = _exp_coeffs(w)
    W = _skew(w)
    W2 = w[..., :, None] * w[..., None, :] - sq[..., None, None] * _eye(
        w.shape[:-1], w.dtype, w.device, 3)
    R = a[..., None, None] * W + b[..., None, None] * W2
    V = b[..., None, None] * W + c[..., None, None] * W2
    R.diagonal(dim1=-2, dim2=-1).add_(1.0)
    V.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return R, (V @ v[..., None])[..., 0]


def se3_log(T):
    """Twist (v, w) of T: w = log R, v = V(w)^-1 t."""
    w = rot_log(T[..., :3, :3])
    sq = torch.sum(w * w, -1)
    small = sq < 1e-12
    th = torch.sqrt(torch.where(small, 1.0, sq))
    half = th / 2
    coef = torch.where(small, 1.0 / 12 + sq / 720,
                       (1 - half * torch.cos(half) / torch.sin(half)) / (th * th))
    W = _skew(w)
    Vinv = _eye(w.shape[:-1], w.dtype, w.device, 3) - 0.5 * W + coef[..., None, None] * (W @ W)
    return (Vinv @ T[..., :3, 3, None])[..., 0], w


def orthonormalize(T):
    return rt(quat_to_rot(quat(T[..., :3, :3])), T[..., :3, 3])


def rotate(R, p):
    """Elementwise rotation of (..., N, 3) points by (..., 3, 3) R in the
    points' dtype."""
    R = R.to(p.dtype)[..., None, :, :]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z,
                        R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z,
                        R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z], -1)


def _where4(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


# ---------------------------------------------------------------------------
# scan stages
# ---------------------------------------------------------------------------


def preprocess(xyz, time, ring, mask, stamp, lidar: dict):
    """Range gate, relative time, time sort. Returns (xyz (B, N, 3) f32,
    tau (B, N) f32, mask (B, N)), sorted by time where the configuration
    sorts (`sort_by_time`), else in sensor order with the gated points
    zeroed."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    d2 = x * x + y * y + z * z
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    stamped = torch.any(mask & (time > 0), dim=-1, keepdim=True)
    mask = mask & finite & (d2 >= lidar["min_range"] ** 2) & (d2 <= lidar["max_range"] ** 2)
    source = lidar["time_source"]
    if source != "per_point":
        rot_t = _rotation_time(xyz, ring, mask, lidar)
    if source == "per_point":
        rel = time - stamp[:, None]
    elif source == "rotation_model":
        rel = rot_t
    else:
        rel = torch.where(stamped, time - stamp[:, None], rot_t)
    t0 = torch.amin(torch.where(mask, rel, torch.full_like(rel, math.inf)), -1, keepdim=True)
    rel = rel - torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))
    if not lidar["sort_by_time"]:
        rel_s = torch.where(mask, rel, torch.zeros_like(rel))
        span = torch.amax(rel_s, -1, keepdim=True)
        tau = (rel_s / torch.where(span > 0, span, torch.ones_like(span))).to(F32)
        return torch.where(mask[..., None], xyz, torch.zeros_like(xyz)).to(F32), tau, mask
    key = torch.where(mask, torch.clamp(rel, min=0.0).to(F32),
                      torch.full_like(rel, math.inf, dtype=F32))
    key_s, order = torch.sort(key, dim=-1, stable=True)
    mask_s = torch.gather(mask, -1, order)
    xyz_s = torch.gather(xyz, -2, order[..., None].expand(order.shape + (3,)))
    xyz_s = torch.where(mask_s[..., None], xyz_s, torch.zeros_like(xyz_s)).to(F32)
    rel_s = torch.where(mask_s, key_s.to(F64), torch.zeros_like(key_s, dtype=F64))
    span = torch.amax(rel_s, -1, keepdim=True)
    tau = (rel_s / torch.where(span > 0, span, torch.ones_like(span))).to(F32)
    return xyz_s, tau, mask_s


def _rotation_time(xyz, ring, mask, lidar):
    """Per-point time (s) of a sensor that sweeps `angle_limit` degrees
    a frame at frame_rate: the azimuth behind the first valid point of the
    point's ring."""
    b, n = mask.shape
    lines = lidar["num_scan_lines"]
    yaw = torch.rad2deg(torch.atan2(xyz[..., 1], xyz[..., 0]))
    r = torch.clamp(ring.to(I64), 0, lines - 1)
    idx = torch.arange(n, device=xyz.device).expand(b, n)
    first = torch.full((b, lines), n, dtype=I64, device=xyz.device)
    first.scatter_reduce_(1, torch.where(mask, r, torch.full_like(r, lines - 1)),
                          torch.where(mask, idx, torch.full_like(idx, n)), reduce="amin")
    yaw_pad = torch.cat([yaw, torch.zeros_like(yaw[:, :1])], -1)
    yaw_first = torch.gather(yaw_pad, -1, first)
    yaw_fp = torch.gather(yaw_first, -1, r)
    deg_per_ms = lidar["frame_rate"] * 360.0 / 1000.0
    diff = torch.remainder(yaw_fp - yaw, lidar["max_angle"] - lidar["min_angle"])
    return (diff / deg_per_ms / 1000.0).to(F64)


def deskew(points, tau, v, w):
    """exp((tau - 1/2) (v, w)) applied to f32 points; v, w (B, 3) f32."""
    s = (tau - 0.5)[..., None]
    wn = torch.linalg.norm(w, dim=-1)[:, None, None]
    tiny = wn < 1e-8
    safe = torch.where(tiny, torch.ones_like(wn), wn)
    k = (w[:, None, :] / safe)
    th = s * wn
    c, si = torch.cos(th), torch.sin(th)
    kp = torch.linalg.cross(k.expand(points.shape), points, dim=-1)
    kd = (points[..., 0] * k[..., 0] + points[..., 1] * k[..., 1]
          + points[..., 2] * k[..., 2])[..., None]
    rot = points * c + kp * si + k * (kd * (1 - c))
    wxv = torch.linalg.cross(w, v, dim=-1)[:, None, :]
    wwxv = torch.linalg.cross(w, torch.linalg.cross(w, v, dim=-1), dim=-1)[:, None, :]
    a = torch.where(tiny, 0.5 * s * s, (1 - c) / (safe * safe))
    bb = torch.where(tiny, s * s * s / 6, (th - si) / (safe ** 3))
    return rot + s * v[:, None, :] + a * wxv + bb * wwxv


def _first_in_cell(order_key, valid):
    """Sort rows by key (stable: ties keep row order); return (order,
    sorted key, sorted valid, first-of-cell flags)."""
    key = torch.where(valid, order_key, torch.full_like(order_key, torch.iinfo(I64).max))
    key_s, order = torch.sort(key, dim=-1, stable=True)
    valid_s = torch.gather(valid, -1, order)
    prev = torch.cat([torch.full_like(key_s[:, :1], -1), key_s[:, :-1]], -1)
    return order, key_s, valid_s, valid_s & (key_s != prev)


def _coord_key(v, bits=20):
    """Lexicographic (x, y, z) int64 key of int64 coordinates."""
    bias = 1 << (bits - 1)
    return ((v[..., 0] + bias) << (2 * bits)) | ((v[..., 1] + bias) << bits) | (v[..., 2] + bias)


def _compact(flags, order, capacity):
    """Rows (in sorted order) whose flag is set, the first `capacity` of
    them: (source row index (B, capacity), kept (B, capacity))."""
    b, n = flags.shape
    rank = torch.cumsum(flags.to(I64), -1) - 1
    keep = flags & (rank < capacity)
    slot = torch.where(keep, rank, torch.full_like(rank, capacity))
    out = torch.zeros((b, capacity + 1), dtype=I64, device=flags.device)
    out.scatter_(1, slot, torch.where(keep, order, torch.zeros_like(order)))
    kept = torch.arange(capacity, device=flags.device) < torch.clamp(
        torch.sum(flags, -1, keepdim=True), max=capacity)
    return out[:, :capacity], kept


def downsample(world, mask, vs: float, capacity: int, tau=None):
    """Map-insert downsample: the first point of each half-voxel cell,
    cells ordered by (voxel, cell) coordinates, the first `capacity`
    cells. With `tau` (unsorted scans) the first of a cell is the earliest
    by tau quantized to 12 bits, ties in row order; without it, the first
    row. Returns (points (B, M, 3), kept (B, M), voxel (B, M, 3) int64 of
    each point's voxel, rank (B, M) of the point within its voxel)."""
    fine = voxel(world, 0.5 * vs)
    coarse = torch.div(fine, 2, rounding_mode="trunc")
    fres = fine - 2 * coarse + 1
    key = (_coord_key(coarse, 19) << 6) | (fres[..., 0] << 4) | (fres[..., 1] << 2) | fres[..., 2]
    if tau is None:
        order, _, _, first = _first_in_cell(key, mask)
    else:  # rows by time first, then a stable sort by cell keeps that order within a cell
        tmax = float(TAU_MAX)
        by_time = torch.sort(torch.clamp(tau.to(F32) * tmax, 0.0, tmax).to(I64), dim=-1,
                             stable=True).indices
        inner, _, _, first = _first_in_cell(torch.gather(key, 1, by_time),
                                            torch.gather(mask, 1, by_time))
        order = torch.gather(by_time, 1, inner)
    rows, kept = _compact(first, order, capacity)
    pts = torch.gather(world, 1, rows[..., None].expand(rows.shape + (3,)))
    pts = torch.where(kept[..., None], pts, torch.zeros_like(pts))
    vox = torch.gather(coarse, 1, rows[..., None].expand(rows.shape + (3,)))
    vkey = torch.where(kept, _coord_key(vox), torch.full_like(kept, -1, dtype=I64))
    prev = torch.cat([torch.full_like(vkey[:, :1], -2), vkey[:, :-1]], -1)
    head = kept & (vkey != prev)
    pos = torch.arange(capacity, device=world.device).expand(head.shape)
    start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), -1).values
    return pts, kept, vox, pos - start


def source_points(points, kept, vs: float, capacity: int):
    """The first point of each 1.5-voxel cell, cells in coordinate order,
    the first `capacity`."""
    order, _, _, first = _first_in_cell(_coord_key(voxel(points, 1.5 * vs)), kept)
    rows, out_kept = _compact(first, order, capacity)
    out = torch.gather(points, 1, rows[..., None].expand(rows.shape + (3,)))
    return torch.where(out_kept[..., None], out, torch.zeros_like(out)), out_kept


def _median_sorted(a, start, size):
    half = size // 2
    n = a.shape[-1]
    mid = torch.gather(a, -1, torch.clamp(start + half, 0, n - 1)[:, None])[:, 0]
    below = torch.clamp(start + torch.clamp(half - 1, min=0), 0, n - 1)
    lo = torch.gather(a, -1, below[:, None])[:, 0]
    return torch.where(size % 2 == 0, 0.5 * (lo + mid), mid)


def iqr_fence(values, mask):
    """Tukey fence by the median of halves: keep q1 - 1.25 iqr <= v <= q3 +
    1.25 iqr; one valid value gives (q1, q3) = (0, v)."""
    a = torch.sort(torch.where(mask, values, torch.full_like(values, math.inf)), -1).values
    n = torch.sum(mask, -1)
    half = n // 2
    q1 = _median_sorted(a, torch.zeros_like(n), torch.clamp(half, min=1))
    s3 = half + n % 2
    q3 = _median_sorted(a, s3, torch.clamp(n - s3, min=1))
    single = n <= 1
    q1 = torch.where(single, torch.zeros_like(q1), q1)
    q3 = torch.where(single, a[:, 0], q3)
    iqr = q3 - q1
    return mask & (values >= (q1 - IQR_K * iqr)[:, None]) & (values <= (q3 + IQR_K * iqr)[:, None])


# ---------------------------------------------------------------------------
# the map: a dense voxel grid per stream
# ---------------------------------------------------------------------------


class DenseMap:
    """B maps over the voxel box [xlo, xhi) x [ylo, yhi) x [zlo, zhi) of
    the streams' frame (a stream's first pose), K points a voxel in insert
    order. `alloc` marks voxels ever allocated; `n_alloc` counts them
    against the capacity."""

    def __init__(self, b, grid: dict, k, capacity, device):
        (self.xlo, xhi), (self.ylo, yhi), (self.zlo, self.zhi) = (
            (int(lo), int(hi)) for lo, hi in (grid["x"], grid["y"], grid["z"]))
        self.dims = (xhi - self.xlo, yhi - self.ylo, self.zhi - self.zlo)
        g = self.dims[0] * self.dims[1] * self.dims[2]
        self.k, self.capacity, self.cells = k, capacity, g
        self.pts = torch.full((b, g + 1, k, 3), math.inf, dtype=F32, device=device)
        self.cnt = torch.zeros((b, g + 1), dtype=torch.int32, device=device)
        self.alloc = torch.zeros((b, g + 1), dtype=torch.bool, device=device)
        self.n_alloc = torch.zeros((b,), dtype=I64, device=device)
        self.out_of_box = torch.zeros((b,), dtype=I64, device=device)
        self._vox_m = None

    def index(self, v):
        """Cell of int64 voxels (..., 3); the spare cell g off the box."""
        x, y, z = v[..., 0] - self.xlo, v[..., 1] - self.ylo, v[..., 2] - self.zlo
        inside = ((x >= 0) & (x < self.dims[0]) & (y >= 0) & (y < self.dims[1])
                  & (z >= 0) & (z < self.dims[2]))
        flat = (x * self.dims[1] + y) * self.dims[2] + z
        return torch.where(inside, flat, torch.full_like(flat, self.cells)), inside

    def voxels(self):
        """int64 (G, 3) voxel of every cell."""
        dev = self.cnt.device
        g = torch.arange(self.cells, device=dev)
        z = g % self.dims[2]
        y = (g // self.dims[2]) % self.dims[1]
        x = g // (self.dims[2] * self.dims[1])
        return torch.stack([x + self.xlo, y + self.ylo, z + self.zlo], -1)

    def occupied(self):
        return self.cnt[:, :self.cells] > 0

    def packed(self, lanes: int, vs: float) -> "DenseMap":
        """A copy holding each voxel's first `lanes` points as a packed
        mirror keeps them: coded by `pack_code` and decoded."""
        out = copy.copy(self)
        vox = self.voxels()[None, :, None, :]
        dec = unpack_code(pack_code(self.pts[:, :self.cells, :lanes], vox, vs), vox, vs)
        out.pts = torch.cat([dec, self.pts[:, self.cells:, :lanes]], 1)
        out.cnt = torch.clamp(self.cnt, max=lanes)
        out.k = lanes
        return out

    def insert(self, points, kept, vox, rank):
        """Append each kept point (rows grouped by voxel, `rank` its place in
        its group) to its voxel while the voxel holds fewer than K."""
        b = points.shape[0]
        cell, inside = self.index(vox)
        self.out_of_box += torch.sum(kept & ~inside, -1)
        kept = kept & inside
        head = kept & (rank == 0)
        known = torch.gather(self.alloc, 1, cell)
        new = head & ~known
        order = torch.cumsum(new.to(I64), -1) - 1
        grant = new & (self.n_alloc[:, None] + order < self.capacity)
        self.n_alloc = torch.clamp(self.n_alloc + torch.sum(new, -1), max=self.capacity)
        self.alloc.scatter_(1, torch.where(grant, cell, torch.full_like(cell, self.cells)),
                            torch.ones_like(grant))
        self.alloc[:, self.cells] = False
        ok = kept & torch.gather(self.alloc, 1, cell)
        pos = torch.gather(self.cnt, 1, cell).to(I64) + rank
        ok = ok & (pos < self.k)
        flat = torch.where(ok, cell * self.k + pos, torch.full_like(cell, self.cells * self.k))
        boff = (torch.arange(b, device=points.device) * (self.cells + 1) * self.k)[:, None]
        self.pts.view(-1, 3)[(flat + boff).reshape(-1)] = points.reshape(-1, 3)
        self.pts[:, self.cells] = math.inf
        new_cnt = torch.where(ok, pos + 1, torch.zeros_like(pos)).to(torch.int32)
        self.cnt.scatter_reduce_(1, torch.where(ok, cell, torch.full_like(cell, self.cells)),
                                 new_cnt, reduce="amax")
        self.cnt[:, self.cells] = 0

    def evict(self, origin, vs: float, max_range: float):
        """Drop voxels whose voxel offset from the origin's voxel, in
        metres, lies beyond max_range."""
        if self._vox_m is None:
            self._vox_m = self.voxels()
        ov = voxel(origin.to(F32), vs)  # (B, 3)
        d = (self._vox_m[None] - ov[:, None, :]).to(F32) * _f32(vs)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        far = self.occupied() & (d2 > _f32(max_range ** 2))
        self.cnt[:, :self.cells].masked_fill_(far, 0)
        self.pts[:, :self.cells].masked_fill_(far[..., None, None], math.inf)


# ---------------------------------------------------------------------------
# the odometry
# ---------------------------------------------------------------------------


class RefOdometry:
    def __init__(self, pipeline: dict, b: int, grid: dict, device, pose_dtype=F64):
        self.lidar, self.mapc, self.icp = pipeline["lidar"], pipeline["map"], pipeline["icp"]
        if self.mapc["neighborhood"] != 8:
            raise ValueError("the reference fetches the 2 x 2 x 2 voxel block")
        self.lanes = self.mapc["nn_points"] or self.mapc["max_points_per_voxel"]
        if self.icp["gn_backend"] != "pallas" or self.icp["batch_unroll_outer"] <= 0:
            raise ValueError("the reference follows the batched fixed-unroll schedule")
        self.pd, self.dev, self.b = pose_dtype, device, b
        eye = _eye((b,), pose_dtype, device).clone()
        self.pose, self.pose_prev, self.first_pose = eye.clone(), eye.clone(), eye.clone()
        self.num_poses = torch.zeros(b, dtype=I64, device=device)
        self.err_sum = torch.zeros(b, dtype=pose_dtype, device=device)
        self.err_n = torch.zeros(b, dtype=I64, device=device)
        self.model_dev = eye.clone()
        self.map = DenseMap(b, grid, self.mapc["max_points_per_voxel"],
                            self.mapc["capacity"], device)

    # -- threshold --------------------------------------------------------
    def _sigma(self, moved):
        m = self.mapc["max_range"]
        theta = torch.linalg.norm(rot_log(self.model_dev[:, :3, :3]), dim=-1)
        err = 2.0 * m * torch.sin(theta / 2.0) + torch.linalg.norm(self.model_dev[:, :3, 3], dim=-1)
        acc = moved & (err > self.icp["min_motion_th"])
        self.err_sum = torch.where(acc, self.err_sum + err * err, self.err_sum)
        self.err_n = torch.where(acc, self.err_n + 1, self.err_n)
        adaptive = torch.sqrt(self.err_sum / torch.clamp(self.err_n, min=1).to(self.pd))
        return torch.where(moved & (self.err_n >= 1), adaptive,
                           torch.full_like(adaptive, self.icp["initial_threshold"]))

    # -- candidates -------------------------------------------------------
    def _candidates(self, queries, qmask):
        """World coordinates (B, N, NC, 3) f64 of each query's candidates:
        the first `nn_points` points (all, where it is 0) of each voxel of
        the block, slot j = lane * 8 + neighbour, +inf where absent."""
        vs = self.mapc["voxel_size"]
        half = _f32(0.5 * vs)
        lo, hi = voxel(queries - half, vs), voxel(queries + half, vs)
        bits = torch.arange(8, device=self.dev)
        sel = torch.stack([(bits >> 2) & 1, (bits >> 1) & 1, bits & 1], -1).bool()  # (8, 3)
        nbr = torch.where(sel[None, None], hi[:, :, None, :], lo[:, :, None, :])  # (B, N, 8, 3)
        cell, inside = self.map.index(nbr)
        b, n = qmask.shape
        flat = cell.reshape(b, -1)
        pts = torch.gather(self.map.pts.reshape(b, self.map.cells + 1, -1), 1,
                           flat[..., None].expand(flat.shape + (self.map.k * 3,)))
        pts = pts.reshape(b, n, 8, self.map.k, 3)[:, :, :, :self.lanes]
        cnt = torch.gather(self.map.cnt, 1, flat).reshape(b, n, 8)
        lane = torch.arange(self.lanes, device=self.dev)
        valid = (lane < cnt[..., None]) & (inside & qmask[..., None])[..., None]
        if self.mapc["packed_nn"]:
            code = pack_code(pts, nbr[..., None, :], vs)
            world = (nbr.to(F64)[..., None, :] * vs
                     + code.to(F64) * _f32(_PK_SPAN * vs / _PK_MAX) - _f32(0.5 * _PK_SPAN * vs))
        else:
            world = pts.to(F64)
        world = torch.where(valid[..., None], world, torch.full_like(world, math.inf))
        return world.transpose(2, 3).reshape(b, n, 8 * self.lanes, 3)

    # -- one round of GN iterations ----------------------------------------
    def _gn_round(self, q, qmask, cand, kth, maxd2):
        """`inner` robust GN iterations of centred f32 queries q (B, N, 3)
        against centred f32 candidates (B, N, NC, 3). Returns the centred
        correction (R, t) and the converged flag."""
        pd, b = self.pd, q.shape[0]
        icp = self.icp
        mx, vs = icp["max_step_norm"], self.mapc["voxel_size"]
        R = _eye((b,), pd, self.dev, 3).clone()
        t = torch.zeros((b, 3), dtype=pd, device=self.dev)
        conv = torch.zeros(b, dtype=torch.bool, device=self.dev)
        stale = torch.zeros_like(conv)
        kth32, maxd2_32 = kth.to(F32)[:, None], maxd2.to(F32)[:, None]
        eye3 = _eye(q.shape[:2], pd, self.dev, 3)
        ridge_eye = _eye((b,), pd, self.dev, 6)
        for _ in range(icp["batch_unroll_inner"]):
            active = ~conv & ~stale
            # transform, nearest candidate (first of equals), robust weight: f32
            w = q @ R.to(F32).transpose(1, 2) + t.to(F32)[:, None, :]
            best, arg = torch.min(torch.sum((cand - w[:, :, None, :]) ** 2, -1), -1)
            c = torch.gather(cand, 2, arg[..., None, None].expand(arg.shape + (1, 3)))[:, :, 0]
            corr = qmask & (best < maxd2_32)
            r = torch.where(corr[..., None], w - c, 0.0)
            den = kth32 + torch.sum(r * r, -1)
            wt = torch.where(corr, (kth32 * kth32) / (den * den), 0.0).to(pd)
            # the residual's Jacobian [I, -[s]x] at the transformed query s;
            # normal matrix and gradient summed in pose precision
            s = torch.where(corr[..., None], w, 0.0).to(pd)
            J = torch.cat([eye3, -_skew(s)], -1)  # (B, N, 3, 6)
            H = torch.einsum("bn,bnki,bnkj->bij", wt, J, J)
            g = torch.einsum("bn,bnki,bnk->bi", wt, J, r.to(pd))
            # rotation columns scaled by 1 / rms(s), a 1e-6 relative ridge
            sw = H[:, 0, 0]
            tr = torch.einsum("bn,bn->b", wt, torch.sum(s * s, -1))
            i_s = torch.rsqrt(torch.clamp(tr / torch.clamp(sw, min=1e-20), min=1e-12))
            dg = torch.cat([torch.ones_like(s[:, 0]), i_s[:, None].expand(b, 3)], -1)
            A = H * dg[:, :, None] * dg[:, None, :]
            dmax = torch.amax(torch.diagonal(A, dim1=-2, dim2=-1)[:, [0, 3, 4, 5]], -1)
            A = A + (1e-6 * torch.clamp(dmax, min=1e-12))[:, None, None] * ridge_eye
            x = torch.linalg.solve_ex(A, -g * dg)[0] * dg
            ok = corr.sum(-1) >= icp["min_correspondences"]
            step = torch.linalg.norm(x, dim=-1)
            clamp = torch.where(step > mx, mx / torch.clamp(step, min=1e-20), 1.0)
            x = x * torch.where(active & ok, clamp, 0.0)[:, None]
            Rx, tx = se3_exp(x[:, :3], x[:, 3:])
            R = Rx @ R
            t = (Rx @ t[..., None])[..., 0] + tx
            small = torch.clamp(step, max=mx) < icp["estimation_threshold"]
            conv = conv | (active & (~ok | small))
            stale = stale | (~conv & (torch.sum(t * t, -1) > (0.5 * vs) ** 2))
        return R, t, conv

    def _icp(self, src, smask, sigma):
        """The fixed schedule from identity on world-frame sources: the
        correction T_icp (B, 4, 4) and whether the stream's map was empty."""
        pd, b = self.pd, src.shape[0]
        kth, maxd2 = sigma / 3.0, (3.0 * sigma) ** 2
        T = _eye((b,), pd, self.dev).clone()
        conv = torch.zeros(b, dtype=torch.bool, device=self.dev)
        p = src.to(pd)
        m = smask.to(pd)[..., None]
        for _ in range(self.icp["batch_unroll_outer"]):
            w = rotate(T[:, :3, :3], p) + T[:, None, :3, 3]
            anchor = ((w * m).sum(1) / torch.clamp(m.sum(1), min=1)).to(F32).to(pd)
            q = (w - anchor[:, None, :]).to(F32)
            cand = (self._candidates(w.to(F32), smask) - anchor[:, None, None, :].to(F64)).to(F32)
            Rd, td, conv_r = self._gn_round(q, smask, cand, kth, maxd2)
            td = td + anchor - (Rd @ anchor[..., None])[..., 0]
            T = _where4(~conv, rt(Rd, td) @ T, T)
            conv = conv | conv_r
        empty = torch.sum(self.map.occupied(), -1) == 0
        return T, empty

    # -- one step ---------------------------------------------------------
    def step(self, xyz, time, ring, mask, stamp, forced=None):
        """Register one scan of each stream. `forced` (B, 4, 4): carry these
        poses into the state and the map instead of the reference's own.
        Returns (own pose (B, 4, 4), sigma (B,)), both in pose_dtype."""
        return self.register(*preprocess(xyz, time, ring, mask, stamp, self.lidar),
                             forced=forced)

    def register(self, pts, tau, smask, forced=None):
        """`step` from preprocessed scans: points (B, N, 3) f32, tau (B, N)
        f32 and mask (B, N), as `preprocess` returns them."""
        pd, vs = self.pd, self.mapc["voxel_size"]
        if self.icp["deskew"]:
            v, w = se3_log(inverse(self.pose_prev) @ self.pose)
            desk = deskew(pts, tau, v.to(F32), w.to(F32))
            pts = torch.where((self.num_poses > 2)[:, None, None], desk, pts)
        eye = _eye((self.b,), pd, self.dev)
        last = _where4(self.num_poses == 0, eye, self.pose)
        pred = _where4(self.num_poses < 2, eye, inverse(self.pose_prev) @ self.pose)
        guess = last @ pred
        rel = inverse(self.first_pose) @ self.pose
        moved = (self.num_poses > 0) & (torch.linalg.norm(rel[:, :3, 3], dim=-1)
                                        > 5.0 * self.icp["min_motion_th"])
        sigma = self._sigma(moved)

        tg = guess[:, :3, 3].to(F32)
        world = rotate(guess[:, :3, :3], pts) + tg[:, None, :]
        g_pts, g_kept, g_vox, g_rank = downsample(
            world, smask, vs, self.icp["max_map_points"],
            tau=None if self.lidar["sort_by_time"] else tau)
        src, src_kept = source_points(g_pts, g_kept, vs, self.icp["max_source_points"])
        d_sq = torch.sum((src - tg[:, None, :]) ** 2, dim=-1)
        src_kept = iqr_fence(d_sq.to(F64), src_kept)
        T_icp, empty = self._icp(src, src_kept, sigma)
        pose_icp = _where4(empty, guess, T_icp @ guess)
        dev_ = inverse(guess) @ pose_icp
        diverged = torch.linalg.norm(dev_[:, :3, 3], dim=-1) > self.icp["max_model_deviation"]
        own = orthonormalize(_where4(diverged, guess, pose_icp))
        if forced is None:
            pose, self.model_dev = own, _where4(diverged, eye, dev_)
        else:
            pose = forced.to(pd)
            self.model_dev = inverse(guess) @ pose

        delta = pose @ inverse(guess)
        moved_pts = rotate(delta[:, :3, :3], g_pts) + delta[:, None, :3, 3].to(F32)
        self.map.insert(moved_pts, g_kept, g_vox, g_rank)
        if self.mapc["auto_evict"]:
            self.map.evict(pose[:, :3, 3], vs, self.mapc["max_range"])
        first = self.num_poses == 0
        self.pose_prev = _where4(first, pose, self.pose)
        self.first_pose = _where4(first, pose, self.first_pose)
        self.pose = pose
        self.num_poses = self.num_poses + 1
        return own, sigma

"""The measurement probes' kernels P1-P4: `take_rows`, `take_lanes` and
`gn_proto` (`csrc/probes.cu`), each beside its plain PyTorch version.

Counterparts of the Pallas kernels in the JAX package's `tools/`:

* `take_rows(table, idx)`: out[i, j] = table[idx[i, j], j] with idx (N, W),
  or table[idx[i, 0], j] with idx (N, 1) broadcast along W; table (C, W)
  f32 or i32. Serves P1 (`exp_pallas.py:run_take`, `jnp.take` of rows),
  P4 (`exp_gather2.py:probe` over `k_taa`, `take_along_axis` on axis 0, at
  W = 128 and 512) and P4's `k_i32` (an i32 table by an (N, 1) index).
* `take_lanes(table, idx)`: out[r, j] = table[r, idx[r, j]]; table (R, C)
  f32, idx (R, N) i32. Serves P2 (`exp_pallas.py:run_lane`).
* `gn_proto(q, qmask, cand, scal, n_inner)`: P3 (`exp_pallas.py:_gn_kernel`),
  `n_inner` f32 Gauss-Newton iterations from the identity over queries
  q (3, NQ), a query mask (NQ,) bool and candidates (3, NC, NQ) (the port's
  coalesced candidate layout), scal (2,) f32 = [kth, maxd2]. Returns (13,)
  f32: R row-major (9), t (3), conv. Not K1: no Jacobi scaling, no step
  clamp, no stale test, and f32 throughout. On the card one thread-block
  cluster of C CTAs splits the queries (K1's rule, `icp_gn.launch_shape`:
  16 CTAs at 4096 x 80) and adds their sums in rank order.

Indices are clamped into the table (the probes' are in range). The
dispatch rule is `_common`'s: the plain version for CPU tensors, the kernel
(or an exception) for CUDA tensors. All three take `_common`'s lean launch
path: the gathers take about as long on the card as a launch takes on the
host.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import LAUNCHES, bind, expect, lean_entry, on_cpu
from .icp_gn import MAX_CLUSTER, launch_shape

F32 = torch.float32
I32 = torch.int32
_ELEM_CODE = {F32: 0, I32: 1}

_vp, _i = ctypes.c_void_p, ctypes.c_int
_TAKE_ROWS_ARGS = [_vp, _vp, _i, _i, _i, _i, _i, _vp, _vp]
_TAKE_LANES_ARGS = [_vp, _vp, _i, _i, _i, _vp, _vp]
_GN_PROTO_ARGS = [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp, _vp]

_fns: dict[str, object] = {}  # bound C entries (`_common.bind`)
_cluster_ok: set[tuple[int, int]] = set()  # (device, C) gn_proto shapes checked resident


# ---------------------------------------------------------------------------
# gathers (P1, P2, P4)
# ---------------------------------------------------------------------------


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `take_rows`: torch.gather on axis 0."""
    n, w = idx.shape[0], table.shape[1]
    rows = idx.long().clamp(0, table.shape[0] - 1).expand(n, w)
    return torch.gather(table, 0, rows)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = table[idx[i, j or 0], j]: table (C, W) f32 / i32, idx
    (N, W) or (N, 1) i32 -> (N, W) of the table's dtype."""
    code = _ELEM_CODE.get(table.dtype)
    if code is None or idx.dtype != I32:
        raise TypeError(f"take_rows: expected a float32 or int32 table and an int32 index, "
                        f"got {table.dtype} and {idx.dtype}")
    ts, isz = table.shape, idx.shape
    if len(ts) != 2 or len(isz) != 2 or (isz[1] != 1 and isz[1] != ts[1]):
        raise ValueError(f"take_rows: expected table (C, W) and idx (N, 1) or (N, W), got "
                         f"{tuple(ts)} and {tuple(isz)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take_rows: expected contiguous tensors")
    if on_cpu(table, idx):
        return take_rows_plain(table, idx)
    fn, stream = lean_entry(_fns, "lis_take_rows", _TAKE_ROWS_ARGS, table, idx)
    out = table.new_empty((isz[0], ts[1]))
    status = fn(table.data_ptr(), idx.data_ptr(), ts[0], ts[1], isz[0], isz[1], code,
                out.data_ptr(), stream)
    _build.check(status, "take_rows")
    LAUNCHES["take_rows"] += 1
    return out


def take_lanes_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `take_lanes`: torch.gather on axis 1."""
    return torch.gather(table, 1, idx.long().clamp(0, table.shape[1] - 1))


def take_lanes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, j] = table[r, idx[r, j]]: table (R, C) f32, idx (R, N) i32 ->
    (R, N) f32."""
    if table.dtype != F32 or idx.dtype != I32:
        raise TypeError(f"take_lanes: expected a float32 table and an int32 index, got "
                        f"{table.dtype} and {idx.dtype}")
    ts, isz = table.shape, idx.shape
    if len(ts) != 2 or len(isz) != 2 or isz[0] != ts[0]:
        raise ValueError(f"take_lanes: expected table (R, C) and idx (R, N), got "
                         f"{tuple(ts)} and {tuple(isz)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take_lanes: expected contiguous tensors")
    if on_cpu(table, idx):
        return take_lanes_plain(table, idx)
    fn, stream = lean_entry(_fns, "lis_take_lanes", _TAKE_LANES_ARGS, table, idx)
    out = table.new_empty(isz)
    status = fn(table.data_ptr(), idx.data_ptr(), ts[0], ts[1], isz[1], out.data_ptr(), stream)
    _build.check(status, "take_lanes")
    LAUNCHES["take_lanes"] += 1
    return out


# ---------------------------------------------------------------------------
# the f32 GN prototype (P3)
# ---------------------------------------------------------------------------


def gn_proto_plain(q: torch.Tensor, qmask: torch.Tensor, cand: torch.Tensor,
                   scal: torch.Tensor, n_inner: int) -> torch.Tensor:
    """Plain version of `gn_proto`: `_gn_kernel` (exp_pallas.py:114-274)
    transcribed line by line, f32 throughout, each operation its own
    rounding; the 16 sums are torch.sum over the queries."""
    kth, maxd2 = scal[0], scal[1]
    qx, qy, qz = q[0], q[1], q[2]
    one = torch.ones((), dtype=F32, device=q.device)
    zero = torch.zeros((), dtype=F32, device=q.device)
    carry = (one, zero, zero, zero, one, zero, zero, zero, one, zero, zero, zero, zero)
    for _ in range(n_inner):
        (r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2, conv) = carry
        wx = r00 * qx + r01 * qy + r02 * qz + t0
        wy = r10 * qx + r11 * qy + r12 * qz + t1
        wz = r20 * qx + r21 * qy + r22 * qz + t2

        best = torch.full_like(qx, float("inf"))
        bx, by, bz = torch.zeros_like(qx), torch.zeros_like(qx), torch.zeros_like(qx)
        for j in range(cand.shape[1]):
            cx, cy, cz = cand[0, j], cand[1, j], cand[2, j]
            dx, dy, dz = cx - wx, cy - wy, cz - wz
            d2 = dx * dx + dy * dy + dz * dz
            hit = d2 < best
            best = torch.where(hit, d2, best)
            bx = torch.where(hit, cx, bx)
            by = torch.where(hit, cy, by)
            bz = torch.where(hit, cz, bz)

        corr = qmask & (best < maxd2)
        rx = torch.where(corr, wx - bx, 0.0)
        ry = torch.where(corr, wy - by, 0.0)
        rz = torch.where(corr, wz - bz, 0.0)
        res2 = rx * rx + ry * ry + rz * rz
        den = kth + res2
        w = torch.where(corr, (kth * kth) / (den * den), 0.0)

        sx = torch.where(corr, wx, 0.0)
        sy = torch.where(corr, wy, 0.0)
        sz = torch.where(corr, wz, 0.0)
        wsx, wsy, wsz = w * sx, w * sy, w * sz
        sw = torch.sum(w)
        Sx, Sy, Sz = torch.sum(wsx), torch.sum(wsy), torch.sum(wsz)
        sxx, syy, szz = torch.sum(wsx * sx), torch.sum(wsy * sy), torch.sum(wsz * sz)
        sxy, sxz, syz = torch.sum(wsx * sy), torch.sum(wsx * sz), torch.sum(wsy * sz)
        trx, try_, trz = torch.sum(w * rx), torch.sum(w * ry), torch.sum(w * rz)
        bxs = torch.sum(wsy * rz - wsz * ry)
        bys = torch.sum(wsz * rx - wsx * rz)
        bzs = torch.sum(wsx * ry - wsy * rx)

        # 6x6 normal equations, unrolled f32 Cholesky solve of A xi = -b
        A = [
            [sw, 0.0, 0.0, 0.0, Sz, -Sy],
            [0.0, sw, 0.0, -Sz, 0.0, Sx],
            [0.0, 0.0, sw, Sy, -Sx, 0.0],
            [0.0, -Sz, Sy, syy + szz, -sxy, -sxz],
            [Sz, 0.0, -Sx, -sxy, sxx + szz, -syz],
            [-Sy, Sx, 0.0, -sxz, -syz, sxx + syy],
        ]
        b = [-trx, -try_, -trz, -bxs, -bys, -bzs]
        dmax = torch.maximum(torch.maximum(torch.maximum(A[0][0], A[3][3]),
                                           torch.maximum(A[4][4], A[5][5])), one)
        ridge = 1e-7 * dmax
        L = [[None] * 6 for _ in range(6)]
        for jj in range(6):
            d = A[jj][jj] + ridge
            for kk in range(jj):
                d = d - L[jj][kk] * L[jj][kk]
            L[jj][jj] = torch.sqrt(torch.clamp(d, min=1e-20))
            inv = 1.0 / L[jj][jj]
            for ii in range(jj + 1, 6):
                s = A[ii][jj]
                for kk in range(jj):
                    s = s - L[ii][kk] * L[jj][kk]
                L[ii][jj] = s * inv
        y = [None] * 6
        for ii in range(6):
            acc = b[ii]
            for kk in range(ii):
                acc = acc - L[ii][kk] * y[kk]
            y[ii] = acc / L[ii][ii]
        xi = [None] * 6
        for ii in reversed(range(6)):
            acc = y[ii]
            for kk in range(ii + 1, 6):
                acc = acc - L[kk][ii] * xi[kk]
            xi[ii] = acc / L[ii][ii]

        vx, vy, vz, ox, oy, oz = xi
        ncorr = torch.sum(corr.to(F32))
        ok = ncorr >= 20.0
        step2 = vx * vx + vy * vy + vz * vz + ox * ox + oy * oy + oz * oz
        # freeze on starvation or convergence
        scale = torch.where(ok & (conv < 0.5), 1.0, 0.0).to(F32)
        vx, vy, vz = vx * scale, vy * scale, vz * scale
        ox, oy, oz = ox * scale, oy * scale, oz * scale

        # Rodrigues (f32): R = I + a W + b2 W^2; left Jacobian with (b2, c3)
        sq = ox * ox + oy * oy + oz * oz
        sqc = torch.clamp(sq, min=1e-30)
        th = torch.sqrt(sqc)
        small = sq < 1e-12
        a = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
        b2 = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(th)) / sqc)
        c3 = torch.where(small, 1.0 / 6.0, (1.0 - a) / sqc).to(F32)
        e00 = 1.0 + b2 * (ox * ox - sq)
        e01 = a * -oz + b2 * ox * oy
        e02 = a * oy + b2 * ox * oz
        e10 = a * oz + b2 * ox * oy
        e11 = 1.0 + b2 * (oy * oy - sq)
        e12 = a * -ox + b2 * oy * oz
        e20 = a * -oy + b2 * ox * oz
        e21 = a * ox + b2 * oy * oz
        e22 = 1.0 + b2 * (oz * oz - sq)
        v00 = 1.0 + c3 * (ox * ox - sq)
        v01 = b2 * -oz + c3 * ox * oy
        v02 = b2 * oy + c3 * ox * oz
        v10 = b2 * oz + c3 * ox * oy
        v11 = 1.0 + c3 * (oy * oy - sq)
        v12 = b2 * -ox + c3 * oy * oz
        v20 = b2 * -oy + c3 * ox * oz
        v21 = b2 * ox + c3 * oy * oz
        v22 = 1.0 + c3 * (oz * oz - sq)
        dt0 = v00 * vx + v01 * vy + v02 * vz
        dt1 = v10 * vx + v11 * vy + v12 * vz
        dt2 = v20 * vx + v21 * vy + v22 * vz

        # compose: new = E @ old
        carry = (
            e00 * r00 + e01 * r10 + e02 * r20,
            e00 * r01 + e01 * r11 + e02 * r21,
            e00 * r02 + e01 * r12 + e02 * r22,
            e10 * r00 + e11 * r10 + e12 * r20,
            e10 * r01 + e11 * r11 + e12 * r21,
            e10 * r02 + e11 * r12 + e12 * r22,
            e20 * r00 + e21 * r10 + e22 * r20,
            e20 * r01 + e21 * r11 + e22 * r21,
            e20 * r02 + e21 * r12 + e22 * r22,
            e00 * t0 + e01 * t1 + e02 * t2 + dt0,
            e10 * t0 + e11 * t1 + e12 * t2 + dt1,
            e20 * t0 + e21 * t1 + e22 * t2 + dt2,
            torch.where((~ok) | (torch.sqrt(step2) < 5e-4), one, conv),
        )
    return torch.stack(carry)


def max_active_clusters(clusters: int) -> int:
    """How many clusters of `clusters` CTAs of gn_proto the current card
    holds at once (cudaOccupancyMaxActiveClusters), after allowing sizes
    above 8."""
    fn = bind(_fns, "lis_gn_proto_cluster_check", [_i, ctypes.POINTER(_i)])
    active = ctypes.c_int(0)
    _build.check(fn(clusters, ctypes.byref(active)), f"gn_proto cluster check (C = {clusters})")
    return active.value


def _launch(q, qmask, cand, scal, n_inner: int, shape: tuple[int, int]) -> torch.Tensor:
    """gn_proto on CUDA tensors, one cluster of shape (C, queries per CTA);
    raises unless such a cluster can be resident."""
    fn, stream = lean_entry(_fns, "lis_gn_proto", _GN_PROTO_ARGS, q, qmask, cand, scal)
    clusters, per_cta = shape
    if not 1 <= clusters <= MAX_CLUSTER:
        raise ValueError(f"gn_proto: cluster of {clusters} CTAs, not 1-{MAX_CLUSTER}")
    key = (q.get_device(), clusters)
    if key not in _cluster_ok:
        if max_active_clusters(clusters) < 1:
            raise RuntimeError(f"gn_proto: no cluster of {clusters} CTAs can be resident")
        _cluster_ok.add(key)
    out = q.new_empty(13)
    status = fn(q.data_ptr(), qmask.data_ptr(), cand.data_ptr(), scal.data_ptr(), q.shape[1],
                cand.shape[1], int(n_inner), clusters, per_cta, out.data_ptr(), stream)
    _build.check(status, "gn_proto")
    LAUNCHES["gn_proto"] += 1
    return out


def gn_proto(q: torch.Tensor, qmask: torch.Tensor, cand: torch.Tensor, scal: torch.Tensor,
             n_inner: int) -> torch.Tensor:
    """P3: `n_inner` f32 GN iterations from the identity; q (3, NQ) f32,
    qmask (NQ,) bool, cand (3, NC, NQ) f32, scal (2,) f32 [kth, maxd2] ->
    (13,) f32 [R 9 | t 3 | conv]. CPU tensors: the plain version; CUDA
    tensors: the cluster kernel at `launch_shape(NQ, NC)`."""
    expect("q", q, F32, (3, None))
    nq = q.shape[1]
    expect("qmask", qmask, torch.bool, (nq,))
    expect("cand", cand, F32, (3, None, nq))
    expect("scal", scal, F32, (2,))
    if on_cpu(q, qmask, cand, scal):
        return gn_proto_plain(q, qmask, cand, scal, n_inner)
    return _launch(q, qmask, cand, scal, n_inner, launch_shape(nq, cand.shape[1]))


"""Fused Gauss-Newton ICP round, kernel K1 (`fused_gn_carry`).

Counterpart of the JAX package's `ops/pallas/icp_gn.py:fused_gn_carry`.
One call runs `n_inner` robust point-to-point GN iterations of the
centred queries against their candidate slots, then de-centres the
correction and composes it with the carried world pose. Precision: the
per-query work (transform, nearest candidate, residual, weight) is f32;
the weighted sums, the 6x6 solve and the pose are f64 — the TPU kernel
carried everything in f32 plus float-float translations.

Layouts:
  q      (3, N) f32       queries centred on the anchor
  qmask  (N,) f32         1.0 = valid query
  cand   (3, NC, N) f32   candidates centred on the anchor, +inf = empty
  scal   (8,) f64         [kernel_th, max_d2, est_th, min_corr, max_step,
                           stale_d2, -, -]
  carry  (15,) f64        [R 9 | t 3 | anchor 3]: carried world pose and
                           this round's centring anchor
Returns (16,) f64: [R 9 | t 3 | n_corr | rms | iters | flags] with
(R, t) = T_delta @ T_carry and flags = converged + 2 * stale.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import LAUNCHES, expect, expect_cuda, on_cpu, stream_handle

OUT_WIDTH = 16
F32 = torch.float32
F64 = torch.float64

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load().lis_fused_gn_carry
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _gn_update(S, R, t, conv, stale, ncorr_o, rms_o, iters, scal):
    """One GN update from the 18 reduced f64 sums (0-d tensors throughout,
    no host sync). Mirrors the kernel's thread-0 solve."""
    est_th, min_corr, max_step, stale_d2 = scal[2], scal[3], scal[4], scal[5]
    active = (conv < 0.5) & (stale < 0.5)
    sw, Sx, Sy, Sz = S[0], S[1], S[2], S[3]
    sxx, syy, szz, sxy, sxz, syz = S[4], S[5], S[6], S[7], S[8], S[9]
    g = S[10:16]
    ncorr = S[16]
    rms = torch.sqrt(S[17] / torch.clamp(ncorr, min=1.0))

    s2 = (sxx + syy + szz) / torch.clamp(sw, min=1e-20)
    i_s = torch.rsqrt(torch.clamp(s2, min=1e-12))
    i2 = i_s * i_s
    z = torch.zeros_like(sw)
    A = [
        [sw, z, z, z, Sz * i_s, -Sy * i_s],
        [z, sw, z, -Sz * i_s, z, Sx * i_s],
        [z, z, sw, Sy * i_s, -Sx * i_s, z],
        [z, -Sz * i_s, Sy * i_s, (syy + szz) * i2, -sxy * i2, -sxz * i2],
        [Sz * i_s, z, -Sx * i_s, -sxy * i2, (sxx + szz) * i2, -syz * i2],
        [-Sy * i_s, Sx * i_s, z, -sxz * i2, -syz * i2, (sxx + syy) * i2],
    ]
    b = [-g[0], -g[1], -g[2], -g[3] * i_s, -g[4] * i_s, -g[5] * i_s]
    dmax = torch.maximum(torch.maximum(A[0][0], A[3][3]), torch.maximum(A[4][4], A[5][5]))
    ridge = 1e-6 * torch.clamp(dmax, min=1e-12)
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        d = A[j][j] + ridge
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(d, min=1e-25))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, 6):
            acc = A[i][j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc * inv
    y = [None] * 6
    for i in range(6):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    xi = [None] * 6
    for i in reversed(range(6)):
        acc = y[i]
        for k in range(i + 1, 6):
            acc = acc - L[k][i] * xi[k]
        xi[i] = acc / L[i][i]
    v = torch.stack(xi[:3])
    o = torch.stack(xi[3:]) * i_s

    ok = ncorr >= min_corr
    step = torch.sqrt(torch.sum(v * v) + torch.sum(o * o))
    clamp = torch.where(step > max_step, max_step / torch.clamp(step, min=1e-20),
                        torch.ones_like(step))
    scale = torch.where(active & ok, clamp, torch.zeros_like(clamp))
    v = v * scale
    o = o * scale
    ox, oy, oz = o[0], o[1], o[2]

    sq = ox * ox + oy * oy + oz * oz
    th = torch.sqrt(torch.clamp(sq, min=1e-30))
    small = sq < 1e-12
    safe_sq = torch.clamp(sq, min=1e-30)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
    b2 = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(th)) / safe_sq)
    c3 = torch.where(small, torch.full_like(sq, 1.0 / 6.0), (1.0 - a) / safe_sq)

    def rot_like(p, q):
        # I + p W + q W^2 with W^2 = o o^T - |o|^2 I
        return torch.stack([
            torch.stack([1.0 + q * (ox * ox - sq), p * -oz + q * ox * oy, p * oy + q * ox * oz]),
            torch.stack([p * oz + q * ox * oy, 1.0 + q * (oy * oy - sq), p * -ox + q * oy * oz]),
            torch.stack([p * -oy + q * ox * oz, p * ox + q * oy * oz, 1.0 + q * (oz * oz - sq)]),
        ])

    E = rot_like(a, b2)
    V = rot_like(b2, c3)
    R_new = E @ R
    t_new = E @ t + V @ v

    one = torch.ones_like(conv)
    ncorr_o = torch.where(active, ncorr, ncorr_o)
    rms_o = torch.where(active, rms, rms_o)
    iters = iters + active.to(F64)
    conv = torch.where(active & (~ok | (torch.clamp(step, max=max_step) < est_th)), one, conv)
    drift2 = torch.sum(t_new * t_new)
    stale = torch.where((conv < 0.5) & (drift2 > stale_d2), one, stale)
    return R_new, t_new, conv, stale, ncorr_o, rms_o, iters


def fused_gn_carry_ref(q, qmask, cand, scal, carry, n_inner: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K1, same iteration semantics (a
    frozen iteration is an exact identity update, as the kernel's early
    exit)."""
    dev = q.device
    kth = scal[0].to(F32)
    maxd2 = scal[1].to(F32)
    qx, qy, qz = q[0], q[1], q[2]
    valid_q = qmask > 0.5
    R = torch.eye(3, dtype=F64, device=dev)
    t = torch.zeros(3, dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    conv, stale, ncorr_o, rms_o, iters = zero, zero, zero, zero, zero
    for _ in range(n_inner):
        Rf, tf = R.to(F32), t.to(F32)
        wx = Rf[0, 0] * qx + Rf[0, 1] * qy + Rf[0, 2] * qz + tf[0]
        wy = Rf[1, 0] * qx + Rf[1, 1] * qy + Rf[1, 2] * qz + tf[1]
        wz = Rf[2, 0] * qx + Rf[2, 1] * qy + Rf[2, 2] * qz + tf[2]
        d2 = (cand[0] - wx) ** 2 + (cand[1] - wy) ** 2 + (cand[2] - wz) ** 2  # (NC, N)
        best, arg = torch.min(d2, dim=0)
        pick = arg[None]
        bx = torch.gather(cand[0], 0, pick)[0]
        by = torch.gather(cand[1], 0, pick)[0]
        bz = torch.gather(cand[2], 0, pick)[0]
        corr = valid_q & (best < maxd2)
        f0 = torch.zeros_like(wx)
        rx = torch.where(corr, wx - bx, f0)
        ry = torch.where(corr, wy - by, f0)
        rz = torch.where(corr, wz - bz, f0)
        res2 = rx * rx + ry * ry + rz * rz
        den = kth + res2
        w = torch.where(corr, (kth * kth) / (den * den), f0).to(F64)
        sx, sy, sz = (torch.where(corr, c, f0).to(F64) for c in (wx, wy, wz))
        rx, ry, rz = rx.to(F64), ry.to(F64), rz.to(F64)
        wsx, wsy, wsz = w * sx, w * sy, w * sz
        S = torch.stack([
            w.sum(), wsx.sum(), wsy.sum(), wsz.sum(),
            (wsx * sx).sum(), (wsy * sy).sum(), (wsz * sz).sum(),
            (wsx * sy).sum(), (wsx * sz).sum(), (wsy * sz).sum(),
            (w * rx).sum(), (w * ry).sum(), (w * rz).sum(),
            (wsy * rz - wsz * ry).sum(), (wsz * rx - wsx * rz).sum(),
            (wsx * ry - wsy * rx).sum(),
            corr.to(F64).sum(), torch.where(corr, best, f0).to(F64).sum(),
        ])
        R, t, conv, stale, ncorr_o, rms_o, iters = _gn_update(
            S, R, t, conv, stale, ncorr_o, rms_o, iters, scal)

    Rc, tc, anchor = carry[:9].reshape(3, 3), carry[9:12], carry[12:15]
    eye = torch.eye(3, dtype=F64, device=dev)
    twd = t + (eye - R) @ anchor
    return torch.cat([(R @ Rc).reshape(9), R @ tc + twd,
                      torch.stack([ncorr_o, rms_o, iters, conv + 2.0 * stale])])


def fused_gn_carry(q, qmask, cand, scal, carry, n_inner: int) -> torch.Tensor:
    """Run one fused ICP round (see module docstring). CPU tensors: the
    plain version; CUDA tensors: kernel K1."""
    expect("q", q, F32, (3, None))
    n = q.shape[1]
    expect("qmask", qmask, F32, (n,))
    expect("cand", cand, F32, (3, None, n))
    expect("scal", scal, F64, (8,))
    expect("carry", carry, F64, (15,))
    args = (q, qmask, cand, scal, carry)
    if on_cpu(*args):
        return fused_gn_carry_ref(q, qmask, cand, scal, carry, n_inner)
    fn = _kernel()
    expect_cuda(*args)
    out = torch.empty(OUT_WIDTH, dtype=F64, device=q.device)
    status = fn(q.data_ptr(), qmask.data_ptr(), cand.data_ptr(), scal.data_ptr(),
                carry.data_ptr(), n, cand.shape[1], int(n_inner), out.data_ptr(),
                stream_handle(q.device))
    _build.check(status, "fused_gn_carry")
    LAUNCHES["fused_gn_carry"] += 1
    return out

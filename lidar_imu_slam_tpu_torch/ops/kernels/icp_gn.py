"""Fused Gauss-Newton ICP rounds: kernels K1 (`fused_gn_carry`), K4
(`fused_gn`) and K5 (`fused_gn_batched`).

Counterparts of the JAX package's `ops/pallas/icp_gn.py` functions of the
same names. One call runs `n_inner` robust point-to-point GN iterations of
the centred queries against their candidate slots. K1 then de-centres the
correction and composes it with the carried world pose; K4 returns the
centred correction; K5 is K4 over a leading stream axis, each stream with
its own scalars. Precision: the per-query work (transform, nearest
candidate, residual, weight) is f32; the weighted sums, the 6x6 solve and
the pose are f64 — the TPU kernels carried everything in f32 (K1 plus
float-float translations).

On the card the three are one kernel, `gn_cluster_kernel` in
`csrc/icp_gn.cu`: each stream is a thread-block cluster of C CTAs that
split its queries (`launch_shape`: C from the stream's N x NC candidate
reads, 16 CTAs at the main path's 4096 x 80), add their f64 sums into CTA
rank 0 in rank order (repeated launches give bit-equal rows) and take the
solve from it, one launch per ICP round. K1 and K4 are its launches with
one stream, K1 with the carry epilogue.

A single stream too large for one cluster (N x NC above MAX_CLUSTER x
SLOTS_PER_CTA, as the dense preset's 16,384 x 80) spreads over G clusters
of C CTAs instead (`spread_shape`; `gn_spread_kernel`): 128-160 queries
a CTA at the dense shape, two threads a query, the CTA's candidate slice
copied once into shared memory where it fits. Each iteration the
clusters' rank-0 CTAs write their sums to a per-launch scratch slot and
meet at a G-party barrier in global memory; each then adds the G sums in
cluster order and runs the same solve, so every cluster holds the same
state bit for bit and leaves the loop in the same iteration. G is capped
at the clusters the card holds at once (cudaOccupancyMaxActiveClusters,
cached per device): a barrier among clusters that are not all resident
would never complete, so a forced shape above the cap raises before it
launches. Where the rule gives G = 1 (K1 and K4 at 4096 x 80, every K5
launch) the launch is the one-cluster kernel above.

Layouts (K1 and K4; K5 adds a leading S to q, qmask, cand and scal):
  q      (3, N) f32       queries centred on the anchor
  qmask  (N,) f32         1.0 = valid query
  cand   (3, NC, N) f32   candidates centred on the anchor, +inf = empty
  scal   (8,) f64         [kernel_th, max_d2, est_th, min_corr, max_step,
                           stale_d2, -, -]
  carry  (15,) f64        [R 9 | t 3 | anchor 3]: carried world pose and
                           this round's centring anchor
Returns (16,) f64: [R 9 | t 3 | n_corr | rms | iters | flags] with
flags = converged + 2 * stale and (R, t) = T_delta @ T_carry (K1) or the
centred correction T_delta itself (K4; K5 returns (S, 16)).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import LAUNCHES, expect, expect_cuda, on_cpu, stream_handle

OUT_WIDTH = 16
F32 = torch.float32
F64 = torch.float64
SLOTS_PER_CTA = 256 * 80  # query-slot pairs a CTA reads per iteration (245 KB)
MAX_CLUSTER = 16  # kMaxCluster in csrc/icp_gn.cu (above 8: a non-portable size)
MAX_GROUPS = 32  # kMaxGroups in csrc/icp_gn.cu: clusters a spread stream
SPREAD_QUERIES = 128  # queries a CTA of a spread stream (a thread pair each)
SPREAD_CLUSTERS = (8, 16)  # C of a spread stream, in the order tried
# a CTA's dynamic shared memory for its slice: the 227 KB a block may opt
# into on an H100 less the spread kernel's static workspace, 9,216 bytes
# (on the card: the budget `spread_limits` reads)
SMEM_BUDGET = 232_448 - 9_216

_fn = None  # the launcher of K1, K4 and K5
_spread_fn = None  # the launcher of the spread kernel (K1 / K4, G >= 2)
_cluster_ok: set[tuple[int, int]] = set()  # (device, C) shapes checked resident
_spread_active: dict[tuple, tuple[int, int]] = {}  # (device, C, NC, per CTA, resident) -> limits
_shapes: dict[tuple, tuple[int, int, int, bool]] = {}  # (device, N, NC) -> device_shape


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cluster_shape(n: int, clusters: int) -> tuple[int, int]:
    """Split N queries over at most `clusters` CTAs: returns (C, queries per
    CTA). Each slice starts on a multiple of 32 queries (whole warps on
    128-byte lines), none is empty, and C x per covers N."""
    n = max(int(n), 1)
    per = _cdiv(_cdiv(n, clusters), 32) * 32
    return _cdiv(n, per), per


def launch_shape(n: int, nc: int) -> tuple[int, int]:
    """The cluster of one stream of N queries x NC candidate slots: about
    SLOTS_PER_CTA query-slot pairs per CTA (256 queries at the main path's
    80 slots), at most MAX_CLUSTER CTAs. (C, queries per CTA)."""
    return cluster_shape(n, min(MAX_CLUSTER, _cdiv(max(int(n) * int(nc), 1), SLOTS_PER_CTA)))


def slab_bytes(per_cta: int, nc: int) -> int:
    """Dynamic shared memory of a CTA whose slice of at most `per_cta`
    queries x NC slots is resident: 3 planes of 2 ceil(NC / 2) rows of
    per_cta f32 and 32 of padding (`slab_bytes` in csrc/icp_gn.cu)."""
    return 4 * 3 * (2 * _cdiv(nc, 2) * per_cta + 32)


def spread_split(n: int, nc: int, groups: int, clusters: int,
                 smem: int = SMEM_BUDGET) -> tuple[int, int, int, bool]:
    """One stream of N queries over `groups` clusters of `clusters` CTAs:
    (G, C, at most this many queries a CTA, resident). CTA b takes the
    whole warps [b W / K, (b + 1) W / K) of the W = ceil(N / 32) warps of
    queries (K = G x C), so none is empty when K <= W (else ValueError);
    `resident`: that slice fits `smem` bytes of shared memory."""
    n, nc = max(int(n), 1), max(int(nc), 1)
    warps, ctas = _cdiv(n, 32), groups * clusters
    if not (1 <= clusters <= MAX_CLUSTER and 1 <= groups <= MAX_GROUPS and ctas <= warps):
        raise ValueError(f"fused GN: {groups} clusters of {clusters} CTAs for {n} queries "
                         f"({warps} warps): a CTA without queries, a cluster above "
                         f"{MAX_CLUSTER} CTAs or more than {MAX_GROUPS} clusters")
    per = _cdiv(warps, ctas) * 32
    return groups, clusters, per, slab_bytes(per, nc) <= smem


def spread_shape(n: int, nc: int, active: dict[int, int],
                 smem: int = SMEM_BUDGET) -> tuple[int, int, int, bool]:
    """The launch of one stream of N queries x NC slots: (G, C, queries a
    CTA at most, resident). G = 1 is `launch_shape`'s single cluster (the
    one-cluster kernel), taken while one cluster of MAX_CLUSTER CTAs reads
    at most SLOTS_PER_CTA pairs a CTA. Beyond that, for each C of
    SPREAD_CLUSTERS in turn: enough clusters for about SPREAD_QUERIES
    queries a CTA, at most `active[C]` (the clusters the card holds at
    once), at least 2; the first C whose slice is resident wins, else the
    first that spreads at all, else G = 1."""
    n, nc = max(int(n), 1), max(int(nc), 1)
    single = (1, *launch_shape(n, nc), False)
    if n * nc <= MAX_CLUSTER * SLOTS_PER_CTA:
        return single
    spread = []
    for c in SPREAD_CLUSTERS:
        g = min(active.get(c, 0), _cdiv(_cdiv(n, SPREAD_QUERIES), c), _cdiv(n, 32) // c,
                MAX_GROUPS)
        if g >= 2:
            spread.append(spread_split(n, nc, g, c, smem))
    return next((s for s in spread if s[3]), spread[0] if spread else single)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load().lis_fused_gn
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [i] * 6 + [vp, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def max_active_clusters(clusters: int) -> int:
    """How many clusters of `clusters` CTAs of the GN kernel the current
    card holds at once (cudaOccupancyMaxActiveClusters), after allowing
    sizes above 8."""
    fn = _build.load().lis_gn_cluster_check
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    active = ctypes.c_int(0)
    _build.check(fn(clusters, ctypes.byref(active)), f"fused GN cluster check (C = {clusters})")
    return active.value


def spread_limits(device: torch.device, clusters: int, nc: int = 0, per_cta: int = 0,
                  resident: bool = True) -> tuple[int, int]:
    """(how many clusters of `clusters` CTAs of the spread kernel the card
    holds at once, the shared memory a CTA's slice may take), cached per
    device: at per_cta queries x NC slots a CTA, the resident variant or
    the other; per_cta = 0: the most a CTA can take (one CTA an SM)."""
    key = (device.index, clusters, nc, per_cta, resident)
    if key not in _spread_active:
        fn = _build.load().lis_gn_spread_check
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        active, budget = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(fn(clusters, nc, per_cta, int(resident), ctypes.byref(active),
                            ctypes.byref(budget)), f"spread GN check (C = {clusters})")
        _spread_active[key] = (active.value, budget.value)
    return _spread_active[key]


def device_shape(n: int, nc: int, device: torch.device) -> tuple[int, int, int, bool]:
    """`spread_shape` at the card's limits: the launch of one stream of N x
    NC on `device` (cached)."""
    key = (device.index, n, nc)
    if key not in _shapes:
        limits = {c: spread_limits(device, c) for c in SPREAD_CLUSTERS}
        budget = min(b for _, b in limits.values())
        _shapes[key] = spread_shape(n, nc, {c: a for c, (a, _) in limits.items()}, budget)
    return _shapes[key]


def _check_cluster(device: torch.device, clusters: int) -> None:
    """At the first launch of a cluster size on a device: raise unless at
    least one such cluster can be resident."""
    key = (device.index, clusters)
    if key not in _cluster_ok:
        if max_active_clusters(clusters) < 1:
            raise RuntimeError(f"fused GN: no cluster of {clusters} CTAs can be resident on "
                               f"{torch.cuda.get_device_name(device)}")
        _cluster_ok.add(key)


def _gn_update(S, R, t, conv, stale, ncorr_o, rms_o, iters, scal):
    """One GN update from the 18 reduced f64 sums S (..., 18), for any
    leading stream dims (0-d per-stream state, no host sync). Mirrors the
    kernel's thread-0 solve."""
    est_th, min_corr, max_step, stale_d2 = (scal[..., i] for i in (2, 3, 4, 5))
    active = (conv < 0.5) & (stale < 0.5)
    sw, Sx, Sy, Sz = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    sxx, syy, szz, sxy, sxz, syz = (S[..., i] for i in range(4, 10))
    g = [S[..., i] for i in range(10, 16)]
    ncorr = S[..., 16]
    rms = torch.sqrt(S[..., 17] / torch.clamp(ncorr, min=1.0))

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
    v = torch.stack(xi[:3], dim=-1)
    o = torch.stack(xi[3:], dim=-1) * i_s[..., None]

    ok = ncorr >= min_corr
    step = torch.sqrt(torch.sum(v * v, dim=-1) + torch.sum(o * o, dim=-1))
    clamp = torch.where(step > max_step, max_step / torch.clamp(step, min=1e-20),
                        torch.ones_like(step))
    scale = torch.where(active & ok, clamp, torch.zeros_like(clamp))[..., None]
    v = v * scale
    o = o * scale
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]

    sq = ox * ox + oy * oy + oz * oz
    th = torch.sqrt(torch.clamp(sq, min=1e-30))
    small = sq < 1e-12
    safe_sq = torch.clamp(sq, min=1e-30)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
    b2 = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(th)) / safe_sq)
    c3 = torch.where(small, torch.full_like(sq, 1.0 / 6.0), (1.0 - a) / safe_sq)

    def rot_like(p, q):
        # I + p W + q W^2 with W^2 = o o^T - |o|^2 I, shape (..., 3, 3)
        return torch.stack([
            torch.stack([1.0 + q * (ox * ox - sq), p * -oz + q * ox * oy,
                         p * oy + q * ox * oz], dim=-1),
            torch.stack([p * oz + q * ox * oy, 1.0 + q * (oy * oy - sq),
                         p * -ox + q * oy * oz], dim=-1),
            torch.stack([p * -oy + q * ox * oz, p * ox + q * oy * oz,
                         1.0 + q * (oz * oz - sq)], dim=-1),
        ], dim=-2)

    E = rot_like(a, b2)
    V = rot_like(b2, c3)
    R_new = E @ R
    t_new = (E @ t[..., None] + V @ v[..., None])[..., 0]

    one = torch.ones_like(conv)
    ncorr_o = torch.where(active, ncorr, ncorr_o)
    rms_o = torch.where(active, rms, rms_o)
    iters = iters + active.to(F64)
    conv = torch.where(active & (~ok | (torch.clamp(step, max=max_step) < est_th)), one, conv)
    drift2 = torch.sum(t_new * t_new, dim=-1)
    stale = torch.where((conv < 0.5) & (drift2 > stale_d2), one, stale)
    return R_new, t_new, conv, stale, ncorr_o, rms_o, iters


def _gn_iterations_ref(q, qmask, cand, scal, n_inner: int):
    """The kernels' shared loop in plain PyTorch, for any leading stream
    dims: q (..., 3, N), qmask (..., N), cand (..., 3, NC, N), scal (..., 8).
    A frozen iteration is an exact identity update, as the kernel's early
    exit. Returns (R (..., 3, 3), t (..., 3), conv, stale, n_corr, rms,
    iters), the last five (...) f64."""
    dev = q.device
    batch = q.shape[:-2]
    kth = scal[..., 0].to(F32)[..., None]
    maxd2 = scal[..., 1].to(F32)[..., None]
    qx, qy, qz = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    cx, cy, cz = cand[..., 0, :, :], cand[..., 1, :, :], cand[..., 2, :, :]
    valid_q = qmask > 0.5
    R = torch.eye(3, dtype=F64, device=dev).expand(batch + (3, 3))
    t = torch.zeros(batch + (3,), dtype=F64, device=dev)
    zero = torch.zeros(batch, dtype=F64, device=dev)
    conv, stale, ncorr_o, rms_o, iters = zero, zero, zero, zero, zero
    for _ in range(n_inner):
        Rf, tf = R.to(F32)[..., None], t.to(F32)[..., None]
        wx = Rf[..., 0, 0, :] * qx + Rf[..., 0, 1, :] * qy + Rf[..., 0, 2, :] * qz + tf[..., 0, :]
        wy = Rf[..., 1, 0, :] * qx + Rf[..., 1, 1, :] * qy + Rf[..., 1, 2, :] * qz + tf[..., 1, :]
        wz = Rf[..., 2, 0, :] * qx + Rf[..., 2, 1, :] * qy + Rf[..., 2, 2, :] * qz + tf[..., 2, :]
        d2 = ((cx - wx[..., None, :]) ** 2 + (cy - wy[..., None, :]) ** 2
              + (cz - wz[..., None, :]) ** 2)  # (..., NC, N)
        best, arg = torch.min(d2, dim=-2)
        pick = arg[..., None, :]
        bx = torch.gather(cx, -2, pick)[..., 0, :]
        by = torch.gather(cy, -2, pick)[..., 0, :]
        bz = torch.gather(cz, -2, pick)[..., 0, :]
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
            w, wsx, wsy, wsz, wsx * sx, wsy * sy, wsz * sz, wsx * sy, wsx * sz, wsy * sz,
            w * rx, w * ry, w * rz, wsy * rz - wsz * ry, wsz * rx - wsx * rz,
            wsx * ry - wsy * rx, corr.to(F64), torch.where(corr, best, f0).to(F64),
        ], dim=-1).sum(dim=-2)
        R, t, conv, stale, ncorr_o, rms_o, iters = _gn_update(
            S, R, t, conv, stale, ncorr_o, rms_o, iters, scal)
    return R, t, conv, stale, ncorr_o, rms_o, iters


def _row(R, t, conv, stale, ncorr, rms, iters):
    return torch.cat([R.flatten(-2), t, torch.stack([ncorr, rms, iters, conv + 2.0 * stale],
                                                    dim=-1)], dim=-1)


def fused_gn_carry_ref(q, qmask, cand, scal, carry, n_inner: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K1."""
    R, t, conv, stale, ncorr, rms, iters = _gn_iterations_ref(q, qmask, cand, scal, n_inner)
    Rc, tc, anchor = carry[:9].reshape(3, 3), carry[9:12], carry[12:15]
    eye = torch.eye(3, dtype=F64, device=q.device)
    twd = t + (eye - R) @ anchor
    return _row(R @ Rc, R @ tc + twd, conv, stale, ncorr, rms, iters)


def fused_gn_batched_ref(q, qmask, cand, scal, n_inner: int) -> torch.Tensor:
    """Plain PyTorch version of kernels K4 (no leading dim) and K5 (leading
    stream axis): the centred correction rows."""
    return _row(*_gn_iterations_ref(q, qmask, cand, scal, n_inner))


fused_gn_ref = fused_gn_batched_ref


def _launch(name, q, qmask, cand, scal, carry, n_inner, streams, out_shape, shape=None):
    """Launch a GN kernel on CUDA tensors (carry None for K4 / K5) at
    `shape` = (G, C, queries a CTA, resident), by default `device_shape`
    for one stream and `launch_shape`'s cluster a stream for several: G = 1
    the cluster kernel, `streams` clusters of C; G >= 2 (one stream) the
    spread kernel."""
    fn = _kernel()
    expect_cuda(*(t for t in (q, qmask, cand, scal, carry) if t is not None))
    n, nc = q.shape[-1], cand.shape[-2]
    if shape is None:
        shape = (device_shape(n, nc, q.device) if streams == 1
                 else (1, *launch_shape(n, nc), False))
    if shape[0] > 1:
        if streams != 1:
            raise ValueError(f"{name}: {shape[0]} clusters a stream for {streams} streams")
        return _launch_spread(name, q, qmask, cand, scal, carry, n_inner, shape)
    _, clusters, per_cta, _ = shape
    _check_cluster(q.device, clusters)
    out = torch.empty(out_shape, dtype=F64, device=q.device)
    status = fn(q.data_ptr(), qmask.data_ptr(), cand.data_ptr(), scal.data_ptr(),
                None if carry is None else carry.data_ptr(), n, nc, int(n_inner),
                streams, clusters, per_cta, out.data_ptr(), stream_handle(q.device))
    _build.check(status, name)
    LAUNCHES[name] += 1
    return out


def _launch_spread(name, q, qmask, cand, scal, carry, n_inner, shape):
    """The spread kernel at `shape` = (G >= 2, C, queries a CTA, resident):
    raises RuntimeError before launching unless all G clusters can be
    resident at once (the G-party barrier would never complete)."""
    global _spread_fn
    groups, clusters, per_cta, resident = shape
    n, nc = q.shape[-1], cand.shape[-2]
    smem = slab_bytes(per_cta, nc) if resident else 0
    active, budget = spread_limits(q.device, clusters, nc, per_cta, resident)
    if smem > budget:
        raise ValueError(f"{name}: a resident slice of {per_cta} x {nc} needs {smem} bytes of "
                         f"shared memory, above the {budget} a CTA may take")
    if groups > active:
        raise RuntimeError(f"{name}: {groups} clusters of {clusters} CTAs cannot all be "
                           f"resident on {torch.cuda.get_device_name(q.device)} (at most "
                           f"{active}); the clusters' barrier would never complete")
    if _spread_fn is None:
        fn = _build.load().lis_fused_gn_spread
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [i] * 7 + [vp, vp, vp]
        fn.restype = ctypes.c_int
        _spread_fn = fn
    # the barrier's counter (word 0) and the clusters' sums, this launch's own
    scratch = torch.zeros(1 + int(n_inner) * groups * 18, dtype=F64, device=q.device)
    out = torch.empty((OUT_WIDTH,), dtype=F64, device=q.device)
    status = _spread_fn(q.data_ptr(), qmask.data_ptr(), cand.data_ptr(), scal.data_ptr(),
                        None if carry is None else carry.data_ptr(), n, nc, int(n_inner), groups,
                        clusters, per_cta, int(resident), scratch.data_ptr(), out.data_ptr(),
                        stream_handle(q.device))
    _build.check(status, name)
    LAUNCHES[name] += 1
    LAUNCHES["gn_spread"] += 1
    return out


def fused_gn_carry(q, qmask, cand, scal, carry, n_inner: int) -> torch.Tensor:
    """Run one fused ICP round (see module docstring). CPU tensors: the
    plain version; CUDA tensors: kernel K1."""
    expect("q", q, F32, (3, None))
    n = q.shape[1]
    expect("qmask", qmask, F32, (n,))
    expect("cand", cand, F32, (3, None, n))
    expect("scal", scal, F64, (8,))
    expect("carry", carry, F64, (15,))
    if on_cpu(q, qmask, cand, scal, carry):
        return fused_gn_carry_ref(q, qmask, cand, scal, carry, n_inner)
    return _launch("fused_gn_carry", q, qmask, cand, scal, carry, n_inner, 1, (OUT_WIDTH,))


def fused_gn(q, qmask, cand, scal, n_inner: int) -> torch.Tensor:
    """Kernel K4: `n_inner` GN iterations of one stream; returns the (16,)
    centred-correction row. CPU tensors: the plain version."""
    expect("q", q, F32, (3, None))
    n = q.shape[1]
    expect("qmask", qmask, F32, (n,))
    expect("cand", cand, F32, (3, None, n))
    expect("scal", scal, F64, (8,))
    if on_cpu(q, qmask, cand, scal):
        return fused_gn_batched_ref(q, qmask, cand, scal, n_inner)
    return _launch("fused_gn", q, qmask, cand, scal, None, n_inner, 1, (OUT_WIDTH,))


def fused_gn_batched(q, qmask, cand, scal, n_inner: int) -> torch.Tensor:
    """Kernel K5: K4 over a leading stream axis, one thread-block cluster
    per stream; returns (S, 16) rows. CPU tensors: the plain version."""
    expect("q", q, F32, (None, 3, None))
    s, n = q.shape[0], q.shape[2]
    expect("qmask", qmask, F32, (s, n))
    expect("cand", cand, F32, (s, 3, None, n))
    expect("scal", scal, F64, (s, 8))
    if on_cpu(q, qmask, cand, scal):
        return fused_gn_batched_ref(q, qmask, cand, scal, n_inner)
    return _launch("fused_gn_batched", q, qmask, cand, scal, None, n_inner, s, (s, OUT_WIDTH))

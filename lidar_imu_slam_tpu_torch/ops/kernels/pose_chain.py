"""Per-scan pose bookkeeping kernels K2 (`pose_pre`) and K3 (`pose_post`).

Counterpart of the JAX package's `ops/pallas/pose_chain.py`. The CUDA
kernels (`csrc/pose_chain.cu`) are single-thread f64 chains that read the
f64 state tensors directly; the plain versions `pose_pre_ref` /
`pose_post_ref` compute the same rows with tensor operations. Row layouts
(the JAX slot order minus the float-float "lo" slots):

  pose_pre row (32,) f64:
    [0:9] guess R  [9:12] guess t  [12] sigma  [13] moved  [14] thr_sse'
    [15] thr_n'  [16] |w|  [17:20] k  [20:23] v  [23:26] w x v
    [26:29] w x (w x v)  [29:32] 0
  pose_post row (48,) f64:
    [0:9] new pose R  [9:12] new pose t  [12] diverged  [13:22] delta R
    [22:25] delta t  [25:41] model_deviation' (4x4 row-major)  [41:48] 0
"""

from __future__ import annotations

import ctypes

import torch

from ..lie import cross
from . import _build
from ._common import LAUNCHES, expect, expect_cuda, on_cpu, stream_handle

PRE_WIDTH = 32
POST_WIDTH = 48
F64 = torch.float64

_fns: dict[str, object] = {}


def _kernel(name: str):
    if name not in _fns:
        lib = _build.load()
        fn = getattr(lib, name)
        vp, d, i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
        if name == "lis_pose_pre":
            fn.argtypes = [vp] * 7 + [d, d, d, i, vp, vp]
        else:
            fn.argtypes = [vp, vp, d, vp, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


# ---------------------------------------------------------------------------
# K2 pose_pre
# ---------------------------------------------------------------------------


def pose_pre_ref(pose, pose_prev, first_pose, thr_sse, model_dev, num_poses,
                 thr_n, *, min_motion_th: float, initial_threshold: float,
                 max_range: float, deskew_on: bool) -> torch.Tensor:
    """Plain PyTorch version of the pose_pre kernel (f64)."""
    dev = pose.device
    eye = torch.eye(3, dtype=F64, device=dev)
    zero3 = torch.zeros(3, dtype=F64, device=dev)
    Rc, tc = pose[:3, :3], pose[:3, 3]
    Rp, tp = pose_prev[:3, :3], pose_prev[:3, 3]
    Rf, tf = first_pose[:3, :3], first_pose[:3, 3]

    # relative pose, constant-velocity prediction, guess (icp.cpp:146-154)
    R_rel = Rp.T @ Rc
    t_rel = Rp.T @ (tc - tp)
    has2 = num_poses >= 2
    has1 = num_poses >= 1
    R_pred = torch.where(has2, R_rel, eye)
    t_pred = torch.where(has2, t_rel, zero3)
    R_last = torch.where(has1, Rc, eye)
    t_last = torch.where(has1, tc, zero3)
    R_g = R_last @ R_pred
    t_g = t_last + R_last @ t_pred

    # has_moved (icp.cpp:156-163)
    mrel = Rf.T @ (tc - tf)
    mth = 5.0 * min_motion_th
    moved = has1 & (torch.sum(mrel * mrel) > mth * mth)

    # adaptive threshold (threshold.cpp:5-29)
    c_md = torch.clamp(0.5 * (torch.trace(model_dev[:3, :3]) - 1.0), -1.0, 1.0)
    sin_half = torch.sqrt(torch.clamp(0.5 * (1.0 - c_md), min=0.0))
    err = 2.0 * max_range * sin_half + torch.sqrt(torch.sum(model_dev[:3, 3] ** 2))
    acc = moved & (err > min_motion_th)
    sse = thr_sse + torch.where(acc, err * err, torch.zeros_like(err))
    n_new = thr_n + acc.to(thr_n.dtype)
    sigma_ad = torch.sqrt(sse / torch.clamp(n_new, min=1).to(F64))
    sigma = torch.where(moved & (n_new >= 1), sigma_ad,
                        torch.tensor(initial_threshold, dtype=F64, device=dev))

    if deskew_on:
        s_vec = 0.5 * torch.stack([R_rel[2, 1] - R_rel[1, 2],
                                   R_rel[0, 2] - R_rel[2, 0],
                                   R_rel[1, 0] - R_rel[0, 1]])
        c = torch.clamp(0.5 * (torch.trace(R_rel) - 1.0), -1.0, 1.0)
        sn = torch.sqrt(torch.clamp(torch.sum(s_vec * s_vec), min=0.0))
        th = torch.atan2(sn, c)
        small = sn < 1e-6
        one = torch.ones_like(sn)
        scale = torch.where(small, 1.0 + sn * sn / 6.0, th / torch.where(small, one, sn))
        w = s_vec * scale
        th2 = th * th
        half = 0.5 * th
        coeff = torch.where(
            small, 1.0 / 12.0 + th2 / 720.0,
            (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
            / torch.where(small, one, th2))
        wt = cross(w, t_rel)
        wwt = cross(w, wt)
        g = ((num_poses > 2) & (sn > 0)).to(F64)
        v = (t_rel - 0.5 * wt + coeff * wwt) * g
        kx = torch.where(small, zero3, s_vec / torch.where(small, one, sn)) * g
        wn_o = th * g
        wg = w * g
        wxv = cross(wg, v)
        wwxv = cross(wg, wxv)
    else:
        wn_o = torch.zeros((), dtype=F64, device=dev)
        kx = v = wxv = wwxv = zero3

    return torch.cat([
        R_g.reshape(9), t_g, sigma.reshape(1), moved.to(F64).reshape(1),
        sse.reshape(1), n_new.to(F64).reshape(1), wn_o.reshape(1),
        kx, v, wxv, wwxv, zero3,
    ])


def pose_pre(pose, pose_prev, first_pose, thr_sse, model_dev, num_poses, thr_n,
             *, min_motion_th: float, initial_threshold: float,
             max_range: float, deskew_on: bool) -> torch.Tensor:
    """The pre-ICP pose chain (CV guess, adaptive sigma, moved flag,
    threshold accumulators, deskew twist pieces) as one (32,) f64 row.

    pose / pose_prev / first_pose / model_dev (4, 4) f64, thr_sse () f64,
    num_poses / thr_n () int32. CPU tensors: the plain version; CUDA
    tensors: kernel K2."""
    args = (pose, pose_prev, first_pose, thr_sse, model_dev, num_poses, thr_n)
    kw = dict(min_motion_th=min_motion_th, initial_threshold=initial_threshold,
              max_range=max_range, deskew_on=deskew_on)
    for name, t in zip(("pose", "pose_prev", "first_pose"), args[:3]):
        expect(name, t, F64, (4, 4))
    expect("thr_sse", thr_sse, F64, ())
    expect("model_dev", model_dev, F64, (4, 4))
    expect("num_poses", num_poses, torch.int32, ())
    expect("thr_n", thr_n, torch.int32, ())
    if on_cpu(*args):
        return pose_pre_ref(*args, **kw)
    fn = _kernel("lis_pose_pre")
    expect_cuda(*args)
    out = torch.empty(PRE_WIDTH, dtype=F64, device=pose.device)
    status = fn(*(t.data_ptr() for t in args), float(min_motion_th),
                float(initial_threshold), float(max_range), int(bool(deskew_on)),
                out.data_ptr(), stream_handle(pose.device))
    _build.check(status, "pose_pre")
    LAUNCHES["pose_pre"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 pose_post
# ---------------------------------------------------------------------------


def pose_post_ref(corr, guess, *, max_model_deviation: float) -> torch.Tensor:
    """Plain PyTorch version of the pose_post kernel (f64)."""
    dev = corr.device
    eye = torch.eye(3, dtype=F64, device=dev)
    Rc, tc = corr[:9].reshape(3, 3), corr[9:12]
    Rg, tg = guess[:9].reshape(3, 3), guess[9:12]
    R_icp = Rc @ Rg
    t_icp = Rc @ tg + tc
    R_dev = Rg.T @ R_icp
    t_dev = Rg.T @ (t_icp - tg)
    div = torch.sum(t_dev * t_dev) > max_model_deviation * max_model_deviation
    R_s = torch.where(div, Rg, R_icp)
    t_s = torch.where(div, tg, t_icp)
    R_o = R_s @ (1.5 * eye - 0.5 * (R_s.T @ R_s))
    R_d = R_o @ Rg.T
    t_d = t_s - R_d @ tg
    md = torch.eye(4, dtype=F64, device=dev)
    md[:3, :3] = torch.where(div, eye, R_dev)
    md[:3, 3] = torch.where(div, torch.zeros_like(t_dev), t_dev)
    return torch.cat([R_o.reshape(9), t_s, div.to(F64).reshape(1), R_d.reshape(9),
                      t_d, md.reshape(16), torch.zeros(7, dtype=F64, device=dev)])


def pose_post(corr, guess, *, max_model_deviation: float) -> torch.Tensor:
    """The post-ICP pose chain (compose, divergence gate, Newton
    orthonormalization, map delta, model deviation) as one (48,) f64 row.

    corr: 1-D f64 whose first 12 entries are the ICP correction [R 9 | t 3]
    (the ICP result); guess: 1-D f64 whose first 12 entries are the guess
    (the pose_pre row). CPU tensors: the plain version; CUDA: kernel K3."""
    expect("corr", corr, F64, min_numel=12)
    expect("guess", guess, F64, min_numel=12)
    if on_cpu(corr, guess):
        return pose_post_ref(corr, guess, max_model_deviation=max_model_deviation)
    fn = _kernel("lis_pose_post")
    expect_cuda(corr, guess)
    out = torch.empty(POST_WIDTH, dtype=F64, device=corr.device)
    status = fn(corr.data_ptr(), guess.data_ptr(), float(max_model_deviation),
                out.data_ptr(), stream_handle(corr.device))
    _build.check(status, "pose_post")
    LAUNCHES["pose_post"] += 1
    return out

"""Per-scan pose bookkeeping kernels K2 (`pose_pre`) and K3 (`pose_post`).

Counterpart of the JAX package's `ops/pallas/pose_chain.py`. The CUDA
kernels (`csrc/pose_chain.cu`) are one-warp f64 chains that read the f64
state tensors directly and also write the next state's pose bookkeeping;
the plain versions `pose_pre_ref` / `pose_post_ref` compute the same
outputs with tensor operations. Row layouts (the JAX slot order minus the
float-float "lo" slots):

  pose_pre row (32,) f64:
    [0:9] guess R  [9:12] guess t  [12] sigma  [13] moved  [14] thr_sse'
    [15] thr_n'  [16] |w|  [17:20] k  [20:23] v  [23:26] w x v
    [26:29] w x (w x v)  [29:32] 0
  pose_post row (48,) f64:
    [0:9] new pose R  [9:12] new pose t  [12] diverged  [13:22] delta R
    [22:25] delta t  [25:41] model_deviation' (4x4 row-major)  [41:48] 0

Both wrappers take `_common`'s lean launch path: each kernel takes about
as long on the card as its launch takes on the host. K3's outputs lie in
three buffers (f64, i32, f32) carved into views.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..lie import cross, make_transform
from . import _build
from ._common import LAUNCHES, expect, lean_entry, on_cpu

PRE_WIDTH = 32
POST_WIDTH = 48
F64 = torch.float64
F32 = torch.float32
I32 = torch.int32

_vp, _d, _i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
_PRE_ARGS = [_vp] * 7 + [_d, _d, _d, _i, _vp, _vp, _vp]
_POST_ARGS = [_vp] * 5 + [_d, _vp, _vp, _vp, _vp]

_fns: dict[str, object] = {}  # bound C entries (`_common.bind`)


class PoseRow(NamedTuple):
    """K2's outputs."""

    row: torch.Tensor  # (32,) f64, the layout above
    model_error_sq: torch.Tensor  # () f64 thr_sse' (a view of row[14])
    num_samples: torch.Tensor  # () i32 thr_n'


class PosePost(NamedTuple):
    """K3's outputs: the row and the next state's pose bookkeeping."""

    row: torch.Tensor  # (48,) f64, the layout above
    pose: torch.Tensor  # (4, 4) f64 the new pose
    pose_prev: torch.Tensor  # (4, 4) f64 pose_prev' (the new pose on the first scan)
    first_pose: torch.Tensor  # (4, 4) f64 first_pose' (likewise)
    num_poses: torch.Tensor  # () i32 num_poses + 1
    model_deviation: torch.Tensor  # (4, 4) f64 model_deviation' (identity when diverged)
    delta_R: torch.Tensor  # (3, 3) f32 map-correction rotation
    delta_t: torch.Tensor  # (3,) f32 map-correction translation


# ---------------------------------------------------------------------------
# K2 pose_pre
# ---------------------------------------------------------------------------


def pose_pre_ref(pose, pose_prev, first_pose, thr_sse, model_dev, num_poses,
                 thr_n, *, min_motion_th: float, initial_threshold: float,
                 max_range: float, deskew_on: bool) -> PoseRow:
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

    row = torch.cat([
        R_g.reshape(9), t_g, sigma.reshape(1), moved.to(F64).reshape(1),
        sse.reshape(1), n_new.to(F64).reshape(1), wn_o.reshape(1),
        kx, v, wxv, wwxv, zero3,
    ])
    return PoseRow(row, row[14], n_new)


def pose_pre(pose, pose_prev, first_pose, thr_sse, model_dev, num_poses, thr_n,
             *, min_motion_th: float, initial_threshold: float,
             max_range: float, deskew_on: bool) -> PoseRow:
    """The pre-ICP pose chain (CV guess, adaptive sigma, moved flag,
    threshold accumulators, deskew twist pieces): the (32,) f64 row and
    the state-ready accumulators.

    pose / pose_prev / first_pose / model_dev (4, 4) f64, thr_sse () f64,
    num_poses / thr_n () int32. CPU tensors: the plain version; CUDA
    tensors: kernel K2."""
    for name, t in (("pose", pose), ("pose_prev", pose_prev), ("first_pose", first_pose),
                    ("model_dev", model_dev)):
        expect(name, t, F64, (4, 4))
    expect("thr_sse", thr_sse, F64, ())
    expect("num_poses", num_poses, I32, ())
    expect("thr_n", thr_n, I32, ())
    args = (pose, pose_prev, first_pose, thr_sse, model_dev, num_poses, thr_n)
    if on_cpu(*args):
        return pose_pre_ref(*args, min_motion_th=min_motion_th,
                            initial_threshold=initial_threshold, max_range=max_range,
                            deskew_on=deskew_on)
    fn, stream = lean_entry(_fns, "lis_pose_pre", _PRE_ARGS, *args)
    row = pose.new_empty(PRE_WIDTH)
    n = num_poses.new_empty(())
    status = fn(pose.data_ptr(), pose_prev.data_ptr(), first_pose.data_ptr(),
                thr_sse.data_ptr(), model_dev.data_ptr(), num_poses.data_ptr(),
                thr_n.data_ptr(), min_motion_th, initial_threshold, max_range,
                bool(deskew_on), row.data_ptr(), n.data_ptr(), stream)
    _build.check(status, "pose_pre")
    LAUNCHES["pose_pre"] += 1
    return PoseRow(row, row[14], n)


# ---------------------------------------------------------------------------
# K3 pose_post
# ---------------------------------------------------------------------------


def pose_post_ref(corr, guess, pose, first_pose, num_poses, *,
                  max_model_deviation: float) -> PosePost:
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
    row = torch.cat([R_o.reshape(9), t_s, div.to(F64).reshape(1), R_d.reshape(9),
                     t_d, md.reshape(16), torch.zeros(7, dtype=F64, device=dev)])
    new_pose = make_transform(R_o, t_s)
    first = num_poses == 0
    return PosePost(row, new_pose, torch.where(first, new_pose, pose),
                    torch.where(first, new_pose, first_pose), num_poses + 1, md,
                    R_d.to(F32), t_d.to(F32))


def pose_post(corr, guess, pose, first_pose, num_poses, *,
              max_model_deviation: float) -> PosePost:
    """The post-ICP pose chain (compose, divergence gate, Newton
    orthonormalization, map delta, model deviation) and the next state's
    pose bookkeeping.

    corr: 1-D f64 whose first 12 entries are the ICP correction [R 9 | t 3]
    (the ICP result); guess: 1-D f64 whose first 12 entries are the guess
    (the pose_pre row, or LIO's IMU guess); pose / first_pose (4, 4) f64
    and num_poses () i32 of the state. CPU tensors: the plain version;
    CUDA: kernel K3."""
    expect("corr", corr, F64, min_numel=12)
    expect("guess", guess, F64, min_numel=12)
    expect("pose", pose, F64, (4, 4))
    expect("first_pose", first_pose, F64, (4, 4))
    expect("num_poses", num_poses, I32, ())
    args = (corr, guess, pose, first_pose, num_poses)
    if on_cpu(*args):
        return pose_post_ref(*args, max_model_deviation=max_model_deviation)
    fn, stream = lean_entry(_fns, "lis_pose_post", _POST_ARGS, *args)
    out = pose.new_empty((7, 4, 4))  # row (48) | pose | pose_prev' | first_pose' | md'
    n = num_poses.new_empty(())
    delta = pose.new_empty((4, 3), dtype=F32)  # delta R | delta t
    status = fn(corr.data_ptr(), guess.data_ptr(), pose.data_ptr(), first_pose.data_ptr(),
                num_poses.data_ptr(), max_model_deviation, out.data_ptr(), n.data_ptr(),
                delta.data_ptr(), stream)
    _build.check(status, "pose_post")
    LAUNCHES["pose_post"] += 1
    new_pose, prev, first, md = out[3:].unbind(0)
    return PosePost(out[:3].view(POST_WIDTH), new_pose, prev, first, n, md, delta[:3], delta[3])

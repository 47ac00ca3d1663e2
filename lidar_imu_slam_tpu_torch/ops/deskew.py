"""Constant-velocity motion compensation (counterpart of
the JAX package's `ops/deskew.py`; reference deskew.cpp:10-29).

Every point moves by exp((tau_i - 0.5) * twist). On the fast path the twist
pieces come from the pose_pre kernel, so only the per-point vector stage
runs here, elementwise in f32; the classic path derives them from the two
last poses (`constant_velocity_deskew_fast`). Both take leading stream
dims: points (..., N, 3), tau (..., N).
"""

from __future__ import annotations

import torch

from .lie import cross, delta_pose


def deskew_from_scalars(points: torch.Tensor, tau: torch.Tensor, sc: torch.Tensor,
                        mid_pose_timestamp: float = 0.5) -> torch.Tensor:
    """Apply exp((tau - mid) * twist) to (N, 3) f32 points given the twist
    pieces sc = [|w|, k(3), v(3), w x v(3), w x (w x v)(3)] from pose_pre.

      p' = p cos(th) + (k x p) sin(th) + k (k.p)(1 - cos th)
           + s v + a (w x v) + b (w x (w x v)),   th = s |w|

    An all-zero `sc` is the identity, so the num_poses / deskew gating
    lives in the pose kernel and no branch wraps the vector math."""
    sc = sc.to(torch.float32)
    wn = sc[..., 0:1]  # (..., 1) against the (..., N) point axis
    k, v, wxv, wwxv = (sc[..., None, i:i + 3] for i in (1, 4, 7, 10))  # (..., 1, 3)

    s = tau.to(torch.float32) - mid_pose_timestamp
    th = s * wn
    c, si = torch.cos(th), torch.sin(th)

    p = points.to(torch.float32)
    kxp = cross(k.expand(p.shape), p)
    kdp = p[..., 0] * k[..., 0] + p[..., 1] * k[..., 1] + p[..., 2] * k[..., 2]
    rot = p * c[..., None] + kxp * si[..., None] + k * (kdp * (1.0 - c))[..., None]

    tiny = wn < 1e-8
    wn_safe = torch.where(tiny, torch.ones_like(wn), wn)
    a = torch.where(tiny, 0.5 * s * s, (1.0 - c) / (wn_safe * wn_safe))
    b = torch.where(tiny, s * s * s / 6.0, (th - si) / (wn_safe**3))
    trans = s[..., None] * v + a[..., None] * wxv + b[..., None] * wwxv
    return rot + trans


def constant_velocity_deskew_fast(points: torch.Tensor, tau: torch.Tensor,
                                  pose_start: torch.Tensor, pose_end: torch.Tensor,
                                  mid_pose_timestamp: float = 0.5) -> torch.Tensor:
    """The classic path's f32 closed-form deskew (JAX deskew.py:33): the
    twist log(pose_start^-1 pose_end) in f64, cast to f32, split into the
    pieces `deskew_from_scalars` applies. Poses (..., 4, 4) f64."""
    twist = delta_pose(pose_start, pose_end).to(torch.float32)
    v, w = twist[..., :3], twist[..., 3:]
    wn = torch.linalg.norm(w, dim=-1, keepdim=True)
    k = w / torch.where(wn < 1e-8, torch.ones_like(wn), wn)
    wxv = cross(w, v)
    sc = torch.cat([wn, k, v, wxv, cross(w, wxv)], dim=-1)
    return deskew_from_scalars(points, tau, sc, mid_pose_timestamp)

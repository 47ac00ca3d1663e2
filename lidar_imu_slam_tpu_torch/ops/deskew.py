"""Constant-velocity motion compensation (counterpart of
the JAX package's `ops/deskew.py`; reference deskew.cpp:10-29).

Every point moves by exp((tau_i - 0.5) * twist). On the fast path the twist
pieces come from the pose_pre kernel, so only the per-point vector stage
runs here, elementwise in f32.
"""

from __future__ import annotations

import torch

from .lie import cross


def deskew_from_scalars(points: torch.Tensor, tau: torch.Tensor, sc: torch.Tensor,
                        mid_pose_timestamp: float = 0.5) -> torch.Tensor:
    """Apply exp((tau - mid) * twist) to (N, 3) f32 points given the twist
    pieces sc = [|w|, k(3), v(3), w x v(3), w x (w x v)(3)] from pose_pre.

      p' = p cos(th) + (k x p) sin(th) + k (k.p)(1 - cos th)
           + s v + a (w x v) + b (w x (w x v)),   th = s |w|

    An all-zero `sc` is the identity, so the num_poses / deskew gating
    lives in the pose kernel and no branch wraps the vector math."""
    sc = sc.to(torch.float32)
    wn = sc[0]
    k, v, wxv, wwxv = sc[1:4], sc[4:7], sc[7:10], sc[10:13]

    s = tau.to(torch.float32) - mid_pose_timestamp
    th = s * wn
    c, si = torch.cos(th), torch.sin(th)

    p = points.to(torch.float32)
    kxp = cross(k.expand(p.shape), p)
    kdp = p[:, 0] * k[0] + p[:, 1] * k[1] + p[:, 2] * k[2]
    rot = p * c[:, None] + kxp * si[:, None] + k[None, :] * (kdp * (1.0 - c))[:, None]

    tiny = wn < 1e-8
    wn_safe = torch.where(tiny, torch.ones_like(wn), wn)
    a = torch.where(tiny, 0.5 * s * s, (1.0 - c) / (wn_safe * wn_safe))
    b = torch.where(tiny, s * s * s / 6.0, (th - si) / (wn_safe**3))
    trans = s[:, None] * v[None, :] + a[:, None] * wxv[None, :] + b[:, None] * wwxv[None, :]
    return rot + trans

"""Trajectory evaluation (numpy only).

`ate_rmse` and the Umeyama alignment it calls, identical to
the JAX package's `utils/trajectory.py` (the reference ships no evaluation
code — SURVEY §4). Trajectory writers wait for the runner slice.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment of src onto dst, both (N, 3)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = 1.0
    if with_scale:
        c = np.trace(np.diag(D) @ S) / (xs**2).sum(axis=1).mean()
    t = mu_d - c * R @ mu_s
    return R, t, c


def ate_rmse(est_poses, gt_poses, align: bool = True) -> float:
    """Absolute trajectory error RMSE over translations, SE(3)-aligned.

    Accepts numpy arrays or CPU/CUDA tensors of shape (N, 4, 4)."""
    est = _np(est_poses)[:, :3, 3]
    gt = _np(gt_poses)[:, :3, 3]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        R, t, _ = umeyama_alignment(est, gt)
        est = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)

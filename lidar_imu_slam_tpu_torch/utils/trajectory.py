"""Trajectory export and evaluation (numpy only), identical to the JAX
package's `utils/trajectory.py`: TUM and KITTI writers (the same bytes for
the same poses), ATE with the Umeyama alignment and RPE (the reference
ships no evaluation code — SURVEY §4).
"""

from __future__ import annotations

import numpy as np


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (x, y, z, w) for TUM format."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def write_tum(path: str, timestamps, poses) -> None:
    """poses: (N, 4, 4). TUM: t tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for t, T in zip(np.asarray(timestamps), _np(poses)):
            q = _rot_to_quat_np(T[:3, :3])
            tr = T[:3, 3]
            f.write(
                f"{t:.9f} {tr[0]:.9f} {tr[1]:.9f} {tr[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def write_kitti(path: str, poses) -> None:
    """poses: (N, 4, 4). KITTI: 12 row-major entries of the top 3x4 block."""
    with open(path, "w") as f:
        for T in _np(poses):
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")


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


def rpe_rmse(est_poses, gt_poses, delta: int = 1):
    """Relative pose error RMSE (translation, rotation-deg) at frame offset delta."""
    est = _np(est_poses)
    gt = _np(gt_poses)
    n = min(len(est), len(gt))
    terr, rerr = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        ang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(ang)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)

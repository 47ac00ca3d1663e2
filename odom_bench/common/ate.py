"""ATE against the drive's ground truth: `chip_smoke.py:_ate` (itself
`bench.py:_ate`, positions interpolated at `shift` scan periods), rewritten
to align the two trajectories by the rigid motion that fits them best
(Horn / Umeyama without scale) instead of at their first poses. A stream
starts mid-lap at full speed with no motion prior; its first registrations
leave the whole trajectory rigidly offset, which the first-pose anchor
counts against every later scan while the aligned error measures how well
the stream tracks."""

from __future__ import annotations

import numpy as np

TRACK_GATE_M = 0.5  # chip_smoke.py:monte_carlo_phase's tracking gate


def ate(poses: np.ndarray, gt: np.ndarray, shift: float) -> float:
    """Translation RMS ATE of poses (n, 4, 4) against gt (>= n + 1, 4, 4)
    interpolated at `shift` scan periods, after the best rigid alignment."""
    n = poses.shape[0]
    pos = gt[:, :3, 3]
    t = np.minimum(np.arange(n, dtype=np.float64) + shift, len(gt) - 1.0)
    k = np.minimum(t.astype(int), len(gt) - 2)
    a = (t - k)[:, None]
    target = (1.0 - a) * pos[k] + a * pos[k + 1]
    est = poses[:, :3, 3]
    mu_e, mu_t = est.mean(0), target.mean(0)
    u, _, vt = np.linalg.svd((est - mu_e).T @ (target - mu_t))
    d = np.sign(np.linalg.det(vt.T @ u.T)) or 1.0
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    err = (est - mu_e) @ rot.T + mu_t - target
    return float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))


def failed_scans(poses: np.ndarray, gt_of, shift: float) -> tuple[int, list]:
    """Scans with a non-finite pose, plus every scan of a stream whose ATE
    against its ground truth `gt_of(s)` passes the tracking gate. poses
    (steps, S, 4, 4). Returns (failed, per-stream ATE)."""
    steps = poses.shape[0]
    failed, ates = 0, []
    for s in range(poses.shape[1]):
        p = poses[:, s]
        finite = np.isfinite(p).all(axis=(-1, -2))
        a = ate(p, gt_of(s), shift) if finite.all() else float("inf")
        ates.append(a)
        failed += steps if not a <= TRACK_GATE_M else int((~finite).sum())
    return failed, ates

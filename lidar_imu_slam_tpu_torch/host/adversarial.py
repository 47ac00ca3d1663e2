"""Adversarial real-sensor artifact injectors for the synthetic simulator
(counterpart of the JAX package's `host/adversarial.py`, numpy only, the
same outputs for the same seed).

The reference was validated on a real 1,079 s indoor bag
(reference env_ws/src/limu/launch/limu.launch:3-11, env_ws/log_pose.txt)
whose sensor artifacts — ring dropouts, timestamp anomalies, clock jitter,
dynamic objects, reflective ghosts — the clean synthetic worlds never
exercise. Real bags cannot reach this machine (zero egress), so these
injectors are the honest substitute: each corrupts a rendered scan message
the way a real sensor would, and the runners must keep tracking through
each.

All functions take and return the host-side scan-message dict
{"xyz" (n,3), optional "time" (n,), optional "ring" (n,), "stamp"} used by
the runners; they never touch device state.
"""

from __future__ import annotations

import numpy as np


def assign_rings(msg: dict, n_rings: int = 16) -> dict:
    """Synthesize per-point ring ids by elevation angle (the simulator has
    no beam structure; real sensors report this field)."""
    xyz = np.asarray(msg["xyz"])
    elev = np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1) + 1e-9)
    lo, hi = np.min(elev), np.max(elev) + 1e-9
    ring = ((elev - lo) / (hi - lo) * n_rings).astype(np.int32)
    out = dict(msg)
    out["ring"] = np.clip(ring, 0, n_rings - 1)
    return out


def drop_rings(msg: dict, rings_to_drop, rng=None) -> dict:
    """Per-ring dropout: every point of the given rings vanishes (failed
    beams / blockage). Real LiDARs lose whole rings, not random points."""
    out = dict(msg)
    ring = np.asarray(out["ring"])
    keep = ~np.isin(ring, np.asarray(list(rings_to_drop)))
    for k in ("xyz", "time", "ring"):
        if out.get(k) is not None:
            out[k] = np.asarray(out[k])[keep]
    return out


def wrap_timestamps(msg: dict, period: float = 0.1) -> dict:
    """Wrap-around per-point timestamps: the sensor reports times modulo its
    scan period, so a scan straddling the period boundary restarts at ~0
    mid-sweep (common on VLP-16 'time since top of the hour' fields). The
    preprocessing time-sort must reorder, not corrupt."""
    out = dict(msg)
    t = np.asarray(out["time"], np.float64).copy()
    stamp = float(out.get("stamp", 0.0))
    rel = t - stamp
    out["time"] = stamp + np.mod(rel + period / 2, period)
    return out


def jitter_clock(times: np.ndarray, sigma: float = 1e-3, offset: float = 0.0,
                 seed: int = 0) -> np.ndarray:
    """IMU clock jitter + constant offset: each stamp wobbles by N(0, sigma)
    (non-monotone for sigma above the sample period — exercises the
    loop-back defense) on top of a constant clock offset."""
    rng = np.random.default_rng(seed)
    return np.asarray(times, np.float64) + offset + rng.normal(0, sigma, len(times))


def add_moving_outliers(msg: dict, n_points: int = 200, center=None,
                        velocity=(2.0, 0.0, 0.0), scan_index: int = 0,
                        dt: float = 0.1, size: float = 1.5,
                        seed: int = 0) -> dict:
    """A rigid point cluster translating through the scene (a passing
    vehicle): static-world ICP must down-weight it (Geman-McClure kernel +
    IQR gate), not track it."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center if center is not None else [8.0, 2.0, 1.0])
    pos = center + np.asarray(velocity) * (scan_index * dt)
    cluster = pos + rng.uniform(-size / 2, size / 2, (n_points, 3))
    out = dict(msg)
    xyz = np.asarray(out["xyz"])
    out["xyz"] = np.concatenate([xyz, cluster])
    if out.get("time") is not None:
        t = np.asarray(out["time"])
        pad = np.full(n_points, t.max() if len(t) else 0.0)
        out["time"] = np.concatenate([t, pad])
    if out.get("ring") is not None:
        r = np.asarray(out["ring"])
        out["ring"] = np.concatenate([r, np.zeros(n_points, r.dtype)])
    return out


def add_reflective_ghosts(msg: dict, fraction: float = 0.05,
                          range_gain: float = 2.0, seed: int = 0) -> dict:
    """Mirror/ghost returns: a fraction of points duplicated farther along
    their own ray (multi-path off reflective surfaces). Ghosts land in
    empty space; the robust kernel must reject them as correspondences."""
    rng = np.random.default_rng(seed)
    out = dict(msg)
    xyz = np.asarray(out["xyz"])
    n = len(xyz)
    k = max(1, int(n * fraction))
    idx = rng.choice(n, size=k, replace=False)
    ghosts = xyz[idx] * range_gain
    out["xyz"] = np.concatenate([xyz, ghosts])
    if out.get("time") is not None:
        t = np.asarray(out["time"])
        out["time"] = np.concatenate([t, t[idx]])
    if out.get("ring") is not None:
        r = np.asarray(out["ring"])
        out["ring"] = np.concatenate([r, r[idx]])
    return out


def drop_random_points(msg: dict, fraction: float = 0.3, seed: int = 0) -> dict:
    """Uniform random dropout (rain / low-reflectivity returns)."""
    rng = np.random.default_rng(seed)
    out = dict(msg)
    xyz = np.asarray(out["xyz"])
    keep = rng.uniform(size=len(xyz)) > fraction
    for k in ("xyz", "time", "ring"):
        if out.get(k) is not None:
            out[k] = np.asarray(out[k])[keep]
    return out

"""Synthetic LiDAR world simulator (numpy only).

The deterministic "fake backend": a known trajectory through a known world,
producing scans whose recovered poses can be asserted against ground truth.
Same functions, same random streams as the JAX package's `host/synthetic.py`
(the parity tests check equality from the same seeds), ported so the port
never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..config import GRAVITY


def make_world(
    seed: int = 0,
    n_points: int = 120_000,
    extent=(120.0, 30.0, 8.0),
) -> np.ndarray:
    """Random structured world: two walls, ground, ceiling scatter + volume scatter."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = extent
    n_wall = n_points // 4

    def plane(n, axis, value, jitter=0.05):
        pts = np.empty((n, 3))
        pts[:, 0] = rng.uniform(-10, ex, n)
        pts[:, 1] = rng.uniform(-ey, ey, n)
        pts[:, 2] = rng.uniform(0, ez, n)
        pts[:, axis] = value + rng.normal(0, jitter, n)
        return pts

    walls = np.concatenate(
        [
            plane(n_wall, 1, -ey),
            plane(n_wall, 1, ey),
            plane(n_wall, 2, 0.0),
        ]
    )
    scatter = np.stack(
        [
            rng.uniform(-10, ex, n_points - 3 * n_wall),
            rng.uniform(-ey, ey, n_points - 3 * n_wall),
            rng.uniform(0, ez, n_points - 3 * n_wall),
        ],
        axis=1,
    )
    return np.concatenate([walls, scatter]).astype(np.float64)


def make_trajectory(
    n_poses: int = 50,
    speed: float = 1.0,
    yaw_rate: float = 0.02,
    dt: float = 0.1,
    z: float = 2.0,
    n_static: int = 0,
    ramp: int = 3,
) -> np.ndarray:
    """Smooth forward trajectory with gentle yaw. Returns (N, 4, 4) f64.

    `n_static` initial poses are identical (a stationary phase for IMU static
    initialization, like the reference's 200-sample init) and speed ramps up
    over `ramp` poses afterwards.
    """
    poses = np.zeros((n_poses, 4, 4))
    x, y, yaw = 0.0, 0.0, 0.0
    for i in range(n_poses):
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = [x, y, z]
        poses[i] = T
        if i < n_static:
            continue
        frac = min(1.0, (i - n_static + 1) / max(ramp, 1))
        v = speed * frac
        x += v * dt * c
        y += v * dt * s
        yaw += yaw_rate * frac
    return poses


def render_scan(
    world: np.ndarray,
    pose: np.ndarray,
    max_points: int,
    min_range: float,
    max_range: float,
    noise: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Points visible from `pose`, in the sensor frame, padded caller-side.

    Returns (n, 3) f64 with n <= max_points.
    """
    rng = np.random.default_rng(seed)
    rel = world - pose[:3, 3]
    d = np.linalg.norm(rel, axis=1)
    vis = (d > min_range * 1.05) & (d < max_range * 0.95)
    idx = np.flatnonzero(vis)
    if len(idx) > max_points:
        idx = rng.choice(idx, size=max_points, replace=False)
    pts_w = world[idx]
    R, t = pose[:3, :3], pose[:3, 3]
    pts_s = (pts_w - t) @ R  # R^T (p - t)
    pts_s = pts_s + rng.normal(0, noise, pts_s.shape)
    return pts_s


def azimuth_times(pts: np.ndarray, stamp: float, period: float = 0.1) -> np.ndarray:
    """Per-point absolute timestamps from the spinning-sensor azimuth model.

    A mechanical LiDAR emits points in azimuth order over one revolution;
    real sensors stamp each point accordingly (the reference reads these
    into `curvature`, frame.cpp:151-156, and only falls back to a rotation
    model when they are absent, frame.cpp:128-133). Synthetic benches carry
    them so preprocessing exercises the timestamp path real sensors take.
    """
    az = np.arctan2(pts[:, 1], pts[:, 0])  # [-pi, pi)
    return stamp + (az + np.pi) / (2.0 * np.pi) * period


def render_scan_rolling(
    world: np.ndarray,
    pose_start: np.ndarray,
    pose_end: np.ndarray,
    scan_duration: float,
    max_points: int,
    min_range: float,
    max_range: float,
    noise: float = 0.01,
    seed: int = 0,
):
    """Rolling-shutter scan: each point observed at its own interpolated pose.

    Models the intra-scan motion a spinning LiDAR sees, so IMU/CV motion
    compensation has real distortion to remove. Returns (points (n,3) in the
    *per-point* sensor frame, rel_times (n,) seconds in [0, scan_duration)).
    """
    rng = np.random.default_rng(seed)
    rel = world - pose_start[:3, 3]
    d = np.linalg.norm(rel, axis=1)
    vis = (d > min_range * 1.05) & (d < max_range * 0.95)
    idx = np.flatnonzero(vis)
    if len(idx) > max_points:
        idx = rng.choice(idx, size=max_points, replace=False)
    pts_w = world[idx]
    tau = np.sort(rng.uniform(0, 1, len(idx)))

    Ra, Rb = pose_start[:3, :3], pose_end[:3, :3]
    w_ab = _log_so3(Ra.T @ Rb)
    pa, pb = pose_start[:3, 3], pose_end[:3, 3]
    # vectorized per-point pose interpolation (a Python loop here costs
    # minutes at 131k points): rel_i = points in the
    # interpolated sensor frame, Rt = Ra exp(w t) applied transposed via
    # the Rodrigues expansion on (N,3) blocks
    theta = np.linalg.norm(w_ab)
    d_w = pts_w - (pa[None] + tau[:, None] * (pb - pa)[None])  # (N,3) world
    d_a = d_w @ Ra  # rows: Ra^T d  -> start-frame
    if theta < 1e-12:
        out = d_a
    else:
        k = w_ab / theta
        ang = theta * tau  # (N,)
        c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
        # exp(w t)^T d = c d - s (k x d) + (1-c)(k.d) k
        kxd = np.cross(np.broadcast_to(k, d_a.shape), d_a)
        kdd = (d_a @ k)[:, None]
        out = c * d_a - s * kxd + (1.0 - c) * kdd * k[None]
    out += rng.normal(0, noise, out.shape)
    return out, tau * scan_duration


def make_imu_stream(
    poses: np.ndarray,
    scan_dt: float,
    imu_rate: float = 200.0,
    accel_noise: float = 0.0,
    gyro_noise: float = 0.0,
    seed: int = 0,
):
    """Ideal IMU samples consistent with the pose sequence.

    Returns (times (M,), gyro (M,3), accel (M,3)) — accel includes gravity
    reaction (specific force), in the body frame, NED-style +g when at rest.
    """
    rng = np.random.default_rng(seed)
    n = len(poses)
    total_t = (n - 1) * scan_dt
    m = int(total_t * imu_rate) + 1
    times = np.arange(m) / imu_rate

    # finite-difference world velocities/accelerations of the pose spline
    pos = poses[:, :3, 3]
    pose_times = np.arange(n) * scan_dt
    vel = np.gradient(pos, pose_times, axis=0)
    acc = np.gradient(vel, pose_times, axis=0)

    gyro = np.zeros((m, 3))
    accel = np.zeros((m, 3))
    g_world = np.array([0.0, 0.0, -GRAVITY])
    for i, t in enumerate(times):
        k = min(int(t / scan_dt), n - 2)
        a = t / scan_dt - k
        R0, R1 = poses[k, :3, :3], poses[k + 1, :3, :3]
        # body rate from relative rotation
        ang = _log_so3(R0.T @ R1) / scan_dt
        a_w = (1 - a) * acc[k] + a * acc[min(k + 1, n - 1)]
        # piecewise-constant orientation R0 is fine for tests
        accel[i] = R0.T @ (a_w - g_world) + rng.normal(0, accel_noise, 3)
        gyro[i] = ang + rng.normal(0, gyro_noise, 3)
    return times, gyro, accel


def imu_packets(times: np.ndarray, gyro: np.ndarray, accel: np.ndarray, n_scans: int,
                scan_dt: float = 0.1, max_samples: int = 10, time_offset: float = 1e-3):
    """Split an IMU stream into per-scan packets as bench.py:_bench_lio does:
    packet i holds the samples in [scan_dt i, scan_dt (i + 1)), at most
    `max_samples`, their times shifted by `time_offset` s. Returns n_scans
    (times, gyro, accel) triples."""
    packets = []
    for i in range(n_scans):
        lo, hi = np.searchsorted(times, (i * scan_dt, (i + 1) * scan_dt))
        hi = min(hi, lo + max_samples)
        packets.append((times[lo:hi] + time_offset, gyro[lo:hi], accel[lo:hi]))
    return packets


def _log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-10:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2 * np.sin(theta))
        * theta
    )
    return w

"""The benchmark's own renderer: a deployment's world and drive made on the
card from the run's seed.

A torch copy of the port's `host/synthetic.py` recipe (the structured
world of `make_world`, the rolling-shutter arithmetic of
`render_scan_rolling`, the static scan of `render_scan`), drawn from a
`torch.Generator` on the device, a whole scan a call, instead of host
numpy. The numbers drawn differ from numpy's, the recipe and the
arithmetic are the same (`odom_bench/tests/test_odom_render.py` holds them
to the host version).

The configuration's file names every choice, so that a new deployment is
a new file: the world's `kind` (`box`: `make_world`'s street; `ring_street`:
the same street bent into a ring around the circuit), the drive's `kind`
(`circuit`: L scans a lap on a circle whose pose L equals pose 0, so a
stream goes round it again and again), the sensor's field of view, how a
point gets its line (`ring`), whether points carry their own time
(`rolling`), and the share of returns that come back empty (`dropout`,
NaN coordinates, as an organized cloud marks them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F64 = torch.float64


class Drive(NamedTuple):
    """A rendered lap, stored on the device.

    xyz (L, P, 3) f32 sensor-frame points (NaN for an empty return); time
    (L, P) f64 absolute per-point times, or None where the sensor stamps no
    point; ring (L, P) i32 line of each point; stamp (L,) f64; gt (L + 1,
    4, 4) f64 host poses (gt[L] == gt[0]); rolling: the points were taken
    along the scan (ground truth at mid-scan)."""

    xyz: torch.Tensor
    time: torch.Tensor | None
    ring: torch.Tensor
    stamp: torch.Tensor
    gt: np.ndarray
    rolling: bool


def make_world(gen: torch.Generator, n_points: int, extent, device) -> torch.Tensor:
    """`host/synthetic.make_world`'s recipe: two walls (y = -ey, +ey) and a
    ground (z = 0), each a quarter of the points with 0.05 m of normal
    jitter across the plane, the rest scattered through the box x in
    [-10, ex], y in [-ey, ey], z in [0, ez]. (n, 3) f64."""
    ex, ey, ez = (float(e) for e in extent)
    n_wall = n_points // 4
    lo = torch.tensor([-10.0, -ey, 0.0], dtype=F64, device=device)
    hi = torch.tensor([ex, ey, ez], dtype=F64, device=device)
    pts = lo + torch.rand((n_points, 3), generator=gen, dtype=F64, device=device) * (hi - lo)
    jitter = torch.randn((3, n_wall), generator=gen, dtype=F64, device=device) * 0.05
    for block, (axis, value) in enumerate(((1, -ey), (1, ey), (2, 0.0))):
        rows = slice(block * n_wall, (block + 1) * n_wall)
        pts[rows, axis] = value + jitter[block]
    return pts


def ring_street(gen: torch.Generator, world: dict, centre, radius: float,
                device) -> torch.Tensor:
    """`make_world`'s street bent into a ring of `radius` around `centre`
    (x, y), `half_width` to each side: an inner and an outer wall (r =
    radius -+ half_width) and a ground (z = 0), each a quarter of the
    points with 0.05 m of normal jitter across the surface, the rest
    scattered through the ring's volume up to `height`; area-uniform in the
    ring. (n, 3) f64."""
    n_points, hw = int(world["n_points"]), float(world["half_width"])
    r_in, r_out = radius - hw, radius + hw
    n_wall = n_points // 4
    u = torch.rand((n_points, 3), generator=gen, dtype=F64, device=device)
    r = torch.sqrt(r_in ** 2 + u[:, 0] * (r_out ** 2 - r_in ** 2))
    z = u[:, 2] * float(world["height"])
    jitter = torch.randn((3, n_wall), generator=gen, dtype=F64, device=device) * 0.05
    r[:n_wall] = r_in + jitter[0]
    r[n_wall:2 * n_wall] = r_out + jitter[1]
    z[2 * n_wall:3 * n_wall] = jitter[2]
    th = u[:, 1] * (2.0 * math.pi)
    return torch.stack([centre[0] + r * torch.cos(th), centre[1] + r * torch.sin(th), z], -1)


def circuit_radius(drive: dict) -> float:
    return drive["speed"] * drive["dt"] * int(drive["scans_per_lap"]) / (2.0 * math.pi)


def circuit(drive: dict) -> np.ndarray:
    """(L + 1, 4, 4) f64 poses of a closed circle driven counter-clockwise
    at `speed` m/s, `scans_per_lap` scans of `dt` s a lap, centred on
    `centre` (x, y) at height `z`: pose j heads along the tangent at angle
    2 pi j / L, and pose L is pose 0."""
    n = int(drive["scans_per_lap"])
    radius = circuit_radius(drive)
    cx, cy = drive["centre"]
    poses = np.tile(np.eye(4), (n + 1, 1, 1))
    for j in range(n + 1):
        th = 2.0 * math.pi * (j % n) / n
        c, s = math.cos(th), math.sin(th)
        poses[j, :3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        poses[j, :3, 3] = [cx + radius * s, cy - radius * c, drive["z"]]
    return poses


def _log_so3(R: np.ndarray) -> np.ndarray:
    """`host/synthetic._log_so3`."""
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-10:
        return np.zeros(3)
    return (np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
            / (2 * np.sin(theta)) * theta)


def rolling_frame(pts_w: torch.Tensor, tau: torch.Tensor, pose_a: np.ndarray,
                  pose_b: np.ndarray) -> torch.Tensor:
    """World points (..., P, 3) f64 seen at their own interpolated pose,
    tau (..., P) in [0, 1] along the scan from pose_a to pose_b: the
    vectorized rotation of `render_scan_rolling`, rel_i = exp(w tau_i)^T
    Ra^T (p_i - (pa + tau_i (pb - pa))). Without noise."""
    dev = pts_w.device
    Ra = torch.as_tensor(pose_a[:3, :3], dtype=F64, device=dev)
    pa = torch.as_tensor(pose_a[:3, 3], dtype=F64, device=dev)
    pb = torch.as_tensor(pose_b[:3, 3], dtype=F64, device=dev)
    w_ab = _log_so3(pose_a[:3, :3].T @ pose_b[:3, :3])
    theta = float(np.linalg.norm(w_ab))
    d_w = pts_w - (pa + tau[..., None] * (pb - pa))
    d_a = d_w @ Ra
    if theta < 1e-12:
        return d_a
    k = torch.as_tensor(w_ab / theta, dtype=F64, device=dev)
    ang = theta * tau
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    kxd = torch.linalg.cross(k.expand(d_a.shape), d_a, dim=-1)
    kdd = (d_a @ k)[..., None]
    return c * d_a - s * kxd + (1.0 - c) * kdd * k


def _visible_pick(world, R, t, n_pick, drive, gen):
    """`n_pick` distinct random indices of the world points within
    (1.05 min_range, 0.95 max_range) of t and inside the field of view of
    a sensor at (R, t) (`fov_deg`: horizontal width about the heading,
    vertical [low, high] from the sensor's plane): the head of a random
    permutation of the visible ones. Raises where fewer are visible (the
    recipe promises full scans)."""
    rel = (world - t) @ R
    d = torch.linalg.norm(rel, dim=-1)
    vis = (d > drive["min_range"] * 1.05) & (d < drive["max_range"] * 0.95)
    fov = drive["fov_deg"]
    if float(fov["horizontal"]) < 360.0:
        az = torch.rad2deg(torch.atan2(rel[:, 1], rel[:, 0]))
        vis &= torch.abs(az) <= 0.5 * float(fov["horizontal"])
    el = torch.rad2deg(torch.atan2(rel[:, 2], torch.linalg.norm(rel[:, :2], dim=-1)))
    vis &= (el >= float(fov["vertical"][0])) & (el <= float(fov["vertical"][1]))
    idx = torch.nonzero(vis)[:, 0]
    if idx.numel() < n_pick:
        raise ValueError(f"only {idx.numel()} world points visible, the scan takes {n_pick}")
    return idx[torch.randperm(idx.numel(), generator=gen, device=idx.device)[:n_pick]]


def rings(rel: torch.Tensor, ring: dict) -> torch.Tensor:
    """The line of each of a scan's points (P, 3), sensor frame:
    `elevation` splits the vertical field `fov` [low, high] degrees into
    `lines` equal bands, lowest first (a spinning sensor's lasers);
    `interleaved` gives point i line i % `lines` (lasers that fire
    together, points in firing order). (P,) i32."""
    lines = int(ring["lines"])
    if ring["kind"] == "interleaved":
        return torch.arange(rel.shape[0], device=rel.device).remainder(lines).to(torch.int32)
    lo, hi = (float(v) for v in ring["fov"])
    el = torch.rad2deg(torch.atan2(rel[:, 2], torch.linalg.norm(rel[:, :2], dim=-1)))
    band = torch.floor((el - lo) / (hi - lo) * lines)
    return torch.clamp(band, 0, lines - 1).to(torch.int32)


def _world(gen, world_cfg: dict, drive_cfg: dict, device) -> torch.Tensor:
    if world_cfg["kind"] == "box":
        return make_world(gen, int(world_cfg["n_points"]), world_cfg["extent"], device)
    if world_cfg["kind"] == "ring_street":
        return ring_street(gen, world_cfg, drive_cfg["centre"], circuit_radius(drive_cfg),
                           device)
    raise ValueError(f"unknown world kind {world_cfg['kind']!r}")


def render_drive(config: dict, seed: int, device) -> Drive:
    """The configuration's world and lap, rendered on `device` from
    `seed`: the world from `config["world"]`, the lap from
    `config["drive"]`, one scan of exactly `points` points a pose (a
    rolling-shutter scan from pose j to pose j + 1 with per-point times,
    or a static scan at pose j without them), normal noise on every
    coordinate, each point's line, and a `dropout` share of empty
    returns."""
    world_cfg, drive_cfg = config["world"], config["drive"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    world = _world(gen, world_cfg, drive_cfg, device)
    if drive_cfg["kind"] != "circuit":
        raise ValueError(f"unknown drive kind {drive_cfg['kind']!r}")
    gt = circuit(drive_cfg)
    n, p = int(drive_cfg["scans_per_lap"]), int(drive_cfg["points"])
    dt, rolling = float(drive_cfg["dt"]), bool(drive_cfg["rolling"])
    dropout = float(drive_cfg["dropout"])
    xyz = torch.empty((n, p, 3), dtype=torch.float32, device=device)
    ring = torch.empty((n, p), dtype=torch.int32, device=device)
    taus = torch.empty((n, p), dtype=F64, device=device) if rolling else None
    for j in range(n):
        t = torch.as_tensor(gt[j, :3, 3], dtype=F64, device=device)
        R = torch.as_tensor(gt[j, :3, :3], dtype=F64, device=device)
        idx = _visible_pick(world, R, t, p, drive_cfg, gen)
        pts_w = world[idx]
        if rolling:
            tau = torch.sort(torch.rand(p, generator=gen, dtype=F64, device=device)).values
            rel = rolling_frame(pts_w, tau, gt[j], gt[j + 1])
            taus[j] = tau
        else:
            rel = (pts_w - t) @ R
        ring[j] = rings(rel, drive_cfg["ring"])
        noise = torch.randn(rel.shape, generator=gen, dtype=F64, device=device)
        rel = rel + noise * float(drive_cfg["noise"])
        if dropout > 0.0:
            empty = torch.rand(p, generator=gen, dtype=F64, device=device) < dropout
            rel = torch.where(empty[:, None], torch.full_like(rel, math.nan), rel)
        xyz[j] = rel.to(torch.float32)
    stamp = torch.arange(n, dtype=F64, device=device) * dt
    time = stamp[:, None] + taus * dt if rolling else None
    return Drive(xyz=xyz, time=time, ring=ring, stamp=stamp, gt=gt, rolling=rolling)

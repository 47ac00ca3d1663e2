"""The benchmark's renderer against the port's host/synthetic.py on small
sizes: the same rolling-shutter arithmetic, the same world recipe, a
closed circuit."""

import math

import numpy as np
import torch

from lidar_imu_slam_tpu_torch.host import synthetic
from odom_bench.common import render


def test_rolling_frame_matches_host_synthetic():
    world = synthetic.make_world(seed=3, n_points=4000, extent=(20.0, 10.0, 5.0))
    a = np.eye(4)
    a[:3, 3] = [2.0, 1.0, 2.0]
    yaw = 0.05
    b = np.eye(4)
    b[:3, :3] = [[math.cos(yaw), -math.sin(yaw), 0], [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]]
    b[:3, 3] = [2.8, 1.1, 2.0]
    pts, rel = synthetic.render_scan_rolling(world, a, b, 0.1, 10**6, 1.0, 20.0, noise=0.0, seed=7)
    d = np.linalg.norm(world - a[:3, 3], axis=1)
    pts_w = world[(d > 1.05) & (d < 19.0)]
    tau = np.sort(np.random.default_rng(7).uniform(0, 1, len(pts_w)))
    np.testing.assert_allclose(rel, tau * 0.1)
    ours = render.rolling_frame(torch.as_tensor(pts_w), torch.as_tensor(tau), a, b).numpy()
    np.testing.assert_allclose(ours, pts, atol=1e-9)


def test_world_recipe():
    gen = torch.Generator().manual_seed(5)
    w = render.make_world(gen, 40_000, (30.0, 12.0, 6.0), "cpu").numpy()
    host = synthetic.make_world(seed=5, n_points=40_000, extent=(30.0, 12.0, 6.0))
    assert w.shape == host.shape
    q = 10_000
    for ours, theirs in ((w, host),):
        for block, (axis, value) in enumerate(((1, -12.0), (1, 12.0), (2, 0.0))):
            rows = slice(block * q, (block + 1) * q)
            assert abs(ours[rows, axis].mean() - value) < 0.01
            assert abs(ours[rows, axis].std() - theirs[rows, axis].std()) < 0.005
    for axis, (lo, hi) in enumerate(((-10.0, 30.0), (-12.0, 12.0), (0.0, 6.0))):
        scatter = w[3 * q:, axis]
        assert lo <= scatter.min() and scatter.max() <= hi
        assert abs(scatter.mean() - host[3 * q:, axis].mean()) < 0.1 * (hi - lo)


def test_circuit_closes_at_speed():
    drive = {"speed": 8.0, "dt": 0.1, "scans_per_lap": 200, "centre": [25.0, 0.0], "z": 2.0}
    gt = render.circuit(drive)
    np.testing.assert_array_equal(gt[0], gt[-1])
    steps = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    np.testing.assert_allclose(steps, 0.8, rtol=1e-3)
    heading = gt[1:, :3, 0]
    np.testing.assert_allclose(np.sum(heading[:-1] * heading[1:], 1), math.cos(2 * math.pi / 200))


SPIN = {"fov_deg": {"horizontal": 360.0, "vertical": [-30.0, 15.0]},
        "ring": {"kind": "elevation", "lines": 16, "fov": [-30.0, 15.0]}}


def test_drive_is_the_seeds():
    cfg = {"world": {"kind": "box", "n_points": 20_000, "extent": [20.0, 15.0, 6.0]},
           "drive": {"kind": "circuit", "speed": 2.0, "dt": 0.1, "scans_per_lap": 4,
                     "centre": [5.0, 0.0], "z": 2.0, "rolling": True, "points": 2048,
                     "min_range": 2.5, "max_range": 30.0, "noise": 0.02, "dropout": 0.0, **SPIN}}
    a = render.render_drive(cfg, 2**33 + 5, "cpu")
    b = render.render_drive(cfg, 2**33 + 5, "cpu")
    c = render.render_drive(cfg, 6, "cpu")
    assert a.xyz.shape == (4, 2048, 3) and a.time.shape == (4, 2048)
    assert torch.equal(a.xyz, b.xyz) and torch.equal(a.time, b.time)
    assert torch.equal(a.ring, b.ring)
    assert not torch.equal(a.xyz, c.xyz)
    assert torch.all(torch.diff(a.time, dim=1) >= 0)
    r = torch.linalg.norm(a.xyz, dim=-1)
    assert float(r.min()) > 2.5 and float(r.max()) < 30.0


def test_ring_street_field_lines_and_dropout():
    """The ring street around the circuit, a forward field of view, the
    lines of both kinds and the empty returns."""
    drive = {"kind": "circuit", "speed": 4.0, "dt": 0.1, "scans_per_lap": 200,
             "centre": [3.0, -2.0], "z": 1.0, "rolling": False, "points": 3000,
             "min_range": 5.0, "max_range": 30.0, "noise": 0.0, "dropout": 0.25,
             "fov_deg": {"horizontal": 70.0, "vertical": [-38.0, 38.0]},
             "ring": {"kind": "interleaved", "lines": 6}}
    world = {"kind": "ring_street", "n_points": 60_000, "half_width": 8.0, "height": 6.0}
    gen = torch.Generator().manual_seed(4)
    w = render._world(gen, world, drive, "cpu").numpy()
    radius = render.circuit_radius(drive)
    r = np.hypot(w[:, 0] - 3.0, w[:, 1] + 2.0)
    q = 15_000
    assert abs(r[:q].mean() - (radius - 8.0)) < 0.01 and abs(r[q:2 * q].mean() - (radius + 8.0)) < 0.01
    assert abs(w[2 * q:3 * q, 2].mean()) < 0.01 and w[:, 2].max() <= 6.0 + 0.3
    assert (r[3 * q:] >= radius - 8.0).all() and (r[3 * q:] <= radius + 8.0).all()
    d = render.render_drive({"world": world, "drive": drive}, 9, "cpu")
    empty = torch.isnan(d.xyz).any(-1)
    assert 0.2 < float(empty.float().mean()) < 0.3
    p = d.xyz[~empty]
    az = torch.rad2deg(torch.atan2(p[:, 1], p[:, 0]))
    el = torch.rad2deg(torch.atan2(p[:, 2], torch.linalg.norm(p[:, :2], dim=-1)))
    assert float(az.abs().max()) <= 35.0 and float(el.abs().max()) <= 38.0
    assert torch.equal(d.ring[0], torch.arange(3000).remainder(6).to(torch.int32))
    rel = torch.tensor([[10.0, 0.0, -10.0], [10.0, 0.0, 0.0], [10.0, 0.0, 10.0]])
    lines = render.rings(rel, {"kind": "elevation", "lines": 16, "fov": [-45.0, 45.0]})
    assert lines.tolist() == [0, 8, 15]

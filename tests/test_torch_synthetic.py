"""The port's synthetic world and trajectory evaluation against the JAX
package's, from the same seeds: equal arrays."""

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.utils import trajectory as jtraj
from lidar_imu_slam_tpu_torch.host import synthetic as tsyn
from lidar_imu_slam_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,n,extent", [(0, 20000, (20.0, 8.0, 4.0)),
                                           (3, 5001, (120.0, 30.0, 8.0))])
def test_make_world_equal(seed, n, extent):
    np.testing.assert_array_equal(jsyn.make_world(seed, n, extent),
                                  tsyn.make_world(seed, n, extent))


@pytest.mark.parametrize("kw", [dict(n_poses=20, speed=1.2, yaw_rate=0.03),
                                dict(n_poses=12, speed=8.0, yaw_rate=0.01, n_static=3)])
def test_make_trajectory_equal(kw):
    np.testing.assert_array_equal(jsyn.make_trajectory(**kw), tsyn.make_trajectory(**kw))


def test_renders_equal():
    world = jsyn.make_world(seed=1, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = jsyn.make_trajectory(n_poses=4, speed=2.0, yaw_rate=0.05, dt=0.1)
    for i in range(3):
        np.testing.assert_array_equal(
            jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i),
            tsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i))
        a = jsyn.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5, 30.0, seed=i)
        b = tsyn.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5, 30.0, seed=i)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(jsyn.azimuth_times(a[0], 0.3),
                                      tsyn.azimuth_times(a[0], 0.3))


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_equal(align):
    gt = jsyn.make_trajectory(n_poses=10, speed=1.0, yaw_rate=0.05)
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(0).normal(0, 0.05, (10, 3))
    assert jtraj.ate_rmse(est, gt, align=align) == ttraj.ate_rmse(est, gt, align=align)
    assert ttraj.ate_rmse(torch.from_numpy(est), gt, align=align) == ttraj.ate_rmse(
        est, gt, align=align)


@pytest.mark.parametrize("kw", [dict(imu_rate=100.0),
                                dict(imu_rate=200.0, accel_noise=0.05, gyro_noise=0.01, seed=4)])
def test_make_imu_stream_equal(kw):
    gt = jsyn.make_trajectory(n_poses=12, speed=8.0, yaw_rate=0.01, dt=0.1, n_static=2)
    for a, b in zip(jsyn.make_imu_stream(gt, 0.1, **kw), tsyn.make_imu_stream(gt, 0.1, **kw)):
        np.testing.assert_array_equal(a, b)


def test_imu_packets_slice_the_stream_per_scan():
    # bench.py:_bench_lio's rule: packet i holds the first (at most 10)
    # samples in [0.1 i, 0.1 (i + 1)), times + 1 ms
    gt = tsyn.make_trajectory(n_poses=6, speed=8.0, yaw_rate=0.01, dt=0.1)
    times, gyro, accel = tsyn.make_imu_stream(gt, 0.1, imu_rate=200.0)
    packets = tsyn.imu_packets(times, gyro, accel, 6)
    assert len(packets) == 6 and len(packets[-1][0]) == 1  # only t = 0.5 s lies past 0.5
    for i, (t, g, a) in enumerate(packets[:-1]):
        inside = np.flatnonzero((times >= i * 0.1) & (times < (i + 1) * 0.1))[:10]
        assert len(t) == 10 and len(inside) == 10
        np.testing.assert_array_equal(t, times[inside] + 1e-3)
        np.testing.assert_array_equal(g, gyro[inside])
        np.testing.assert_array_equal(a, accel[inside])

"""The port's copy of the numpy oracle (`lidar_imu_slam_tpu_torch/
validation/oracle.py`) against the JAX package's original, on
tests/test_trajectory_parity.py's drive (52 scans of 3000 points, 1 m
voxels, the 27-voxel shell): in `match_jax` mode over every scan, and in
`reference` mode with its true-NN fix over the first 10 and without it
(its farthest-voxel fallback, the slowest mode) over the first 6.
The frames are the port's preprocessed scans; both copies get the same
ones and must give the same poses bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from lidar_imu_slam_tpu.validation import oracle as jorc
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.host import synthetic
from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan
from lidar_imu_slam_tpu_torch.validation import oracle as torc

N_SCANS = 52


@pytest.fixture(scope="module")
def frames():
    cfg = tcfg.PipelineConfig(
        lidar=tcfg.LidarConfig(num_scan_lines=16, max_points=4096, min_range=1.0,
                               max_range=40.0),
        map=tcfg.MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 14, neighborhood=27),
        icp=tcfg.IcpConfig(deskew=False, max_map_points=4096, max_source_points=2048,
                           max_iterations=100),
    )
    world = synthetic.make_world(seed=3, n_points=120_000, extent=(70.0, 24.0, 8.0))
    gt = synthetic.make_trajectory(n_poses=N_SCANS, speed=2.0, yaw_rate=0.02, dt=0.1)
    out = []
    for i, pose in enumerate(gt):
        pts = synthetic.render_scan(world, pose, 3000, 1.0, 40.0, noise=0.01, seed=100 + i)
        scan = preprocess_scan(pack_raw_scan(pts, stamp=i * 0.1, max_points=4096, device="cpu"),
                               cfg.lidar)
        out.append(scan.xyz.numpy()[scan.mask.numpy()].astype(np.float64))
    return cfg, out


def _oracle_cfg(mod, cfg, mode, **kw):
    factory = getattr(mod.OracleConfig, mode)
    ocfg = factory(**kw, voxel_size=cfg.map.voxel_size, max_range=cfg.map.max_range,
                   max_points_per_voxel=cfg.map.max_points_per_voxel,
                   initial_threshold=cfg.icp.initial_threshold,
                   min_motion_th=cfg.icp.min_motion_th, max_iterations=cfg.icp.max_iterations,
                   estimation_threshold=cfg.icp.estimation_threshold)
    if mode == "match_jax":  # tests/test_trajectory_parity.py's settings
        ocfg.min_correspondences = cfg.icp.min_correspondences
        ocfg.max_step_norm = cfg.icp.max_step_norm
        ocfg.max_model_deviation = cfg.icp.max_model_deviation
    return ocfg


@pytest.mark.parametrize("mode,kw,n", [("match_jax", {}, N_SCANS),
                                       ("reference", {"true_nn": True}, 10),
                                       ("reference", {}, 6)],
                         ids=["match_jax", "reference_true_nn", "reference"])
def test_copy_is_bit_equal(frames, mode, kw, n):
    cfg, fr = frames
    want = jorc.ReferenceOdometry(_oracle_cfg(jorc, cfg, mode, **kw))
    got = torc.ReferenceOdometry(_oracle_cfg(torc, cfg, mode, **kw))
    assert dataclasses_equal(want.cfg, got.cfg)
    for f in fr[:n]:
        np.testing.assert_array_equal(got.register_frame(f), want.register_frame(f))


def dataclasses_equal(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_se3_helpers_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        xi = rng.normal(size=6)
        T = torc.se3_exp(xi)
        np.testing.assert_array_equal(T, jorc.se3_exp(xi))
        np.testing.assert_array_equal(torc.se3_log(T), jorc.se3_log(T))
        np.testing.assert_array_equal(torc.inv(T), jorc.inv(T))
        np.testing.assert_allclose(torc.se3_log(T), xi, atol=1e-9)

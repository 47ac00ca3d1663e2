"""The port's online keyframe backend (`lidar_imu_slam_tpu_torch/host/
keyframes.py`) against the JAX package's, on the CPU.

The chunks are recorded once from the port's classic odometry on
tests/test_online_backend.py's closed circuit (120 scans, its config and
its verify thresholds): each scan's pose, keypoints (the ICP source in the
world frame at the initial guess) and keypoint mask as numpy. The same
chunks go through both `OnlineBackend`s (JAX's `OdometryRunner` with its
backend is not run here: its jitted verification and solves would compile
per shape):

* the same keyframes (`kf_scan_idx`), the same loop pairs, loop
  measurements and optimized keyframe poses within 1e-6 m / 1e-6, the
  corrected trajectory (`correct`) within 1e-6, the same number of
  optimizations; the port fed device tensors in place of numpy arrays
  gives the same result bit for bit;
* thinning (tests/test_backend_scale.py::test_thin_remaps_loop_edges):
  the same remaps in both;
* the keyframe cloud's frame: a stored cloud is the keypoints taken to the
  sensor frame with the scan's FINAL pose, so it is off by the scan's ICP
  correction (JAX keyframes.py:88-91; ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host.keyframes import OnlineBackend as JBackend
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.host import synthetic
from lidar_imu_slam_tpu_torch.host.keyframes import OnlineBackend as TBackend
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

torch.set_num_threads(1)

N_SCANS = 120
BACKEND_KW = dict(  # tests/test_online_backend.py::test_runner_online_loop_closure
    enabled=True, max_keyframes=64, max_edges=256, keyframe_dist=1.0, keyframe_rot=0.3,
    chunk=6, optimize_every=6, loop_radius=3.0, min_index_gap=12, max_candidates=4,
    verify_max_residual=0.65, verify_min_correspondences=150, lm_iterations=8,
)


def _cfg(c, **backend):
    return c.PipelineConfig(
        lidar=c.LidarConfig(max_range=25.0, min_range=0.5, max_points=2048),
        map=c.MapConfig(voxel_size=0.5, max_range=25.0, capacity=1 << 13),
        icp=c.IcpConfig(max_map_points=2048, max_source_points=512, max_iterations=30),
        backend=c.BackendConfig(**{**BACKEND_KW, **backend}),
    )


def circuit():
    """tests/test_online_backend.py's world and closed circle (radius
    ~4.3 m): ground truth and scan messages."""
    world = synthetic.make_world(seed=11, n_points=80_000, extent=(36.0, 36.0, 5.0))
    gt = synthetic.make_trajectory(n_poses=N_SCANS, speed=2.3,
                                   yaw_rate=2 * np.pi / (N_SCANS - 1), dt=0.1)
    msgs = [{"xyz": synthetic.render_scan(world, p, 1600, 0.5, 25.0, noise=0.03, seed=i),
             "stamp": i * 0.1} for i, p in enumerate(gt)]
    return gt, msgs


@pytest.fixture(scope="module")
def recorded():
    """Each scan's final pose, keypoints and keypoint mask from the port's
    classic odometry, as numpy."""
    cfg = _cfg(tcfg)
    _, msgs = circuit()
    state = tk.init_state(cfg, "cpu")
    poses, clouds, masks = [], [], []
    for m in msgs:
        scan = preprocess_scan(pack_raw_scan(m["xyz"], stamp=m["stamp"],
                                             max_points=cfg.lidar.max_points, device="cpu"),
                               cfg.lidar)
        state, out = tk.register_frame_step(state, scan, cfg)
        poses.append(out.pose.numpy().copy())
        clouds.append(out.keypoints.numpy().copy())
        masks.append(out.keypoints_mask.numpy().copy())
    return np.stack(poses), np.stack(clouds), np.stack(masks)


def _feed(backend, recorded, as_tensors=False, chunk=BACKEND_KW["chunk"]):
    poses, clouds, masks = recorded
    conv = torch.from_numpy if as_tensors else (lambda a: a)
    for s in range(0, len(poses), chunk):
        idx = list(range(s, min(s + chunk, len(poses))))
        backend.observe_chunk(idx, poses[idx], [conv(clouds[i]) for i in idx],
                              [conv(masks[i]) for i in idx])
    backend.optimize()  # the runner's final round
    return backend


@pytest.fixture(scope="module")
def both(recorded):
    return (_feed(JBackend(_cfg(jcfg)), recorded),
            _feed(TBackend(_cfg(tcfg), device="cpu"), recorded))


def test_same_keyframes_and_loops(both):
    jb_, tb_ = both
    assert tb_.kf_scan_idx == jb_.kf_scan_idx
    assert len(tb_.kf_scan_idx) >= 10
    assert [(i, j) for i, j, _, _ in tb_.loop_edges] == [(i, j) for i, j, _, _ in jb_.loop_edges]
    assert len(tb_.loop_edges) >= 1
    for (_, _, mt, wt), (_, _, mj, wj) in zip(tb_.loop_edges, jb_.loop_edges):
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6)
        assert wt == wj
    assert tb_._checked_pairs == jb_._checked_pairs
    assert (tb_.num_optimizations, tb_.thin_events) == (jb_.num_optimizations, jb_.thin_events)
    for a, b in zip(tb_.kf_clouds, jb_.kf_clouds):
        np.testing.assert_array_equal(a, b)


def test_same_optimized_and_corrected(both, recorded):
    jb_, tb_ = both
    np.testing.assert_allclose(tb_.optimized, jb_.optimized, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb_.correct(recorded[0]), jb_.correct(recorded[0]),
                               rtol=0, atol=1e-6)
    assert not np.array_equal(tb_.correct(recorded[0]), recorded[0])


def test_device_chunks_equal_host_chunks(both, recorded):
    _, host = both
    dev = _feed(TBackend(_cfg(tcfg), device="cpu"), recorded, as_tensors=True)
    assert dev.kf_scan_idx == host.kf_scan_idx
    for a, b in zip(dev.kf_clouds, host.kf_clouds):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(dev.kf_cloud_masks, host.kf_cloud_masks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dev.optimized, host.optimized)


def test_keyframe_cloud_is_off_by_the_icp_correction(recorded):
    """Every scan a keyframe. Scan 1's initial guess is the identity (the
    first pose; no motion model yet), so its keypoints are its source in
    the sensor frame; the stored cloud is that source taken through the
    inverse of the FINAL pose instead, off by the scan's whole correction
    (JAX does the same)."""
    poses, clouds, masks = recorded
    kw = dict(keyframe_dist=0.0, keyframe_rot=0.0, optimize_every=10_000)
    stored = []
    for backend in (TBackend(_cfg(tcfg, **kw), device="cpu"), JBackend(_cfg(jcfg, **kw))):
        backend.observe_chunk([0, 1, 2], poses[:3], list(clouds[:3]), list(masks[:3]))
        assert backend.kf_scan_idx == [0, 1, 2]
        stored.append(backend.kf_clouds[1])
    np.testing.assert_array_equal(stored[0], stored[1])
    R, t = poses[1][:3, :3], poses[1][:3, 3]
    m = masks[1]
    want = np.where(m[:, None], ((clouds[1].astype(np.float64) - t) @ R).astype(np.float32), 0.0)
    np.testing.assert_array_equal(stored[0], want)
    off = np.abs(stored[0][m] - clouds[1][m]).max()
    assert np.linalg.norm(t) > 0.05 and off > 0.5 * np.linalg.norm(t), (off, t)


def test_thin_remaps_like_jax():
    """tests/test_backend_scale.py::test_thin_remaps_loop_edges, both
    packages: 24 keyframes a metre apart, a loop edge 3 -> 21, then the
    keyframe that triggers thinning."""
    kw = dict(max_keyframes=24, max_edges=96, keyframe_dist=0.8, keyframe_rot=10.0,
              optimize_every=10_000)
    cloud, mask = np.zeros((32, 3), np.float32), np.ones(32, bool)
    out = []
    for backend in (TBackend(_cfg(tcfg, **kw), device="cpu"), JBackend(_cfg(jcfg, **kw))):
        for i in range(24):
            T = np.eye(4)
            T[0, 3] = float(i)
            backend.observe_chunk([i], T[None], [cloud], [mask])
        meas = np.linalg.inv(backend.kf_poses[3]) @ backend.kf_poses[21]
        backend.loop_edges.append((3, 21, meas, 1.0))
        backend._checked_pairs |= {(3, 21), (1, 22), (2, 23)}
        T = np.eye(4)
        T[0, 3] = 25.0
        backend.observe_chunk([25], T[None], [cloud], [mask])
        out.append(backend)
    tb_, jb_ = out
    assert tb_.thin_events == jb_.thin_events == 1
    assert tb_.kf_scan_idx == jb_.kf_scan_idx and tb_.kf_scan_idx[-1] == 25
    assert tb_.dropped_keyframes == jb_.dropped_keyframes > 0
    (i, j, m, _), = tb_.loop_edges
    assert (tb_.kf_scan_idx[i], tb_.kf_scan_idx[j]) == (3, 21)
    assert [(a, b) for a, b, _, _ in tb_.loop_edges] == [(a, b) for a, b, _, _ in jb_.loop_edges]
    assert tb_._checked_pairs == jb_._checked_pairs
    assert tb_._kf_at_last_opt == jb_._kf_at_last_opt
    assert np.all(np.diff(tb_.kf_scan_idx) > 0)

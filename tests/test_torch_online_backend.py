"""The port's runners with the online loop-closure backend on, on the CPU
(the port's counterpart of tests/test_online_backend.py, with its circuit,
config and bars):

* a drifted circle with one perfect loop edge: dense LM pulls the chain's
  end back toward the start;
* `OdometryRunner` (classic f64 path) around the closed circuit: at least
  10 keyframes, an optimization, a verified loop edge with j - i >=
  `min_index_gap`, a finite corrected trajectory whose ATE is at most 1.05
  times the raw one; the raw poses bit-equal to the same run without the
  backend (the backend never feeds back into odometry);
* `LioRunner` on the same circuit (rolling-shutter scans, 100 Hz IMU):
  the same structural bars, and each keyframe's corrected pose is its
  optimized pose. The ATE bar does not hold there: the loop edges (ICP
  between 512-point keyframe clouds, ~0.5 degrees off) are less accurate
  than LIO's raw poses (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.host import synthetic
from lidar_imu_slam_tpu_torch.host.runner import LioRunner, OdometryRunner
from lidar_imu_slam_tpu_torch.models import backend as tb

from test_torch_keyframes import N_SCANS, _cfg, circuit

torch.set_num_threads(1)


def _ate(poses, gt, shift=0):
    ref = gt[np.minimum(np.arange(len(poses)) + shift, len(gt) - 1)]
    rel = np.linalg.inv(ref[0])[None] @ ref
    return float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - rel[:, :3, 3]) ** 2, axis=1))))


def _assert_backend_bars(r, cfg):
    b = r.backend
    assert b is not None
    assert len(b.kf_poses) >= 10
    assert b.num_optimizations >= 1
    assert len(b.loop_edges) >= 1, "no loop closure verified"
    for (i, j, _, _) in b.loop_edges:
        assert j - i >= cfg.backend.min_index_gap
    opt = r.optimized_poses()
    assert opt.shape == (N_SCANS, 4, 4) and np.isfinite(opt).all()
    # a keyframe's corrected pose is its optimized pose
    for k, s in enumerate(b.kf_scan_idx):
        np.testing.assert_allclose(opt[s], b.optimized[k], atol=1e-9)
    return opt


def test_pose_graph_closes_synthetic_loop():
    n = 40
    gt = []
    for k in range(n):
        th = 2 * np.pi * k / (n - 1)
        T = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [10 * np.sin(th), 10 * (1 - np.cos(th)), 0.0]
        gt.append(T)
    gt = np.stack(gt)
    drift = np.eye(4)
    drift[:3, :3] = [[np.cos(0.008), -np.sin(0.008), 0], [np.sin(0.008), np.cos(0.008), 0],
                     [0, 0, 1]]
    drift[:3, 3] = [0.02, 0.0, 0.0]
    drifted = [gt[0]]
    for k in range(1, n):
        drifted.append(drifted[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift)
    drifted = np.stack(drifted)
    g = tb.from_chain(drifted, 64, 256, device="cpu")
    g = tb.add_edge(g, 0, n - 1, np.linalg.inv(gt[0]) @ gt[-1], 50.0)
    opt = tb.optimize(g, iterations=15).poses.numpy()[:n]
    before = np.linalg.norm(drifted[-1][:3, 3] - gt[-1][:3, 3])
    after = np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3])
    assert before > 1.0 and after < 0.35 * before


@pytest.fixture(scope="module")
def circuit_msgs():
    return circuit()


def test_runner_online_loop_closure(circuit_msgs):
    gt, msgs = circuit_msgs
    cfg = _cfg(tcfg)
    r = OdometryRunner(cfg, device="cpu").run(iter(msgs))
    opt = _assert_backend_bars(r, cfg)
    raw = np.stack(r.poses)
    assert _ate(opt, gt) <= _ate(raw, gt) * 1.05 + 1e-6
    plain = OdometryRunner(cfg.replace(backend=tcfg.BackendConfig()), device="cpu")
    plain.run(iter(msgs))
    assert plain.backend is None
    np.testing.assert_array_equal(np.stack(plain.poses), raw)
    np.testing.assert_array_equal(plain.optimized_poses(), raw)


def test_lio_runner_online_loop_closure():
    gt, _ = circuit()
    world = synthetic.make_world(seed=11, n_points=80_000, extent=(36.0, 36.0, 5.0))
    msgs = []
    for i in range(N_SCANS):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[min(i + 1, N_SCANS - 1)], 0.1,
                                                 1600, 0.5, 25.0, noise=0.03, seed=i)
        msgs.append({"xyz": pts, "time": i * 0.1 + rel, "stamp": i * 0.1})
    t, gyro, acc = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)
    imu = np.column_stack([t + 1.3e-3, gyro, acc])
    cfg = _cfg(tcfg).replace(ekf=tcfg.EkfConfig(lidar_pose_trail=4),
                             imu=tcfg.ImuConfig(max_init_count=20, max_samples_per_scan=16))
    r = LioRunner(cfg, device="cpu").run_lio(iter(msgs), imu)
    opt = _assert_backend_bars(r, cfg)
    assert [rec["used_imu"] for rec in r.metrics.records][2:] == [1.0] * (N_SCANS - 2)
    raw = np.stack(r.poses)
    assert _ate(raw, gt, shift=1) < 0.1  # LIO poses at the scan end
    # pinned (ROADMAP queue 3): the correction costs LIO accuracy here
    assert _ate(opt, gt, shift=1) > _ate(raw, gt, shift=1)

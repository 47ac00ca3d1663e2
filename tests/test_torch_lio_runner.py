"""The port's `host/runner.LioRunner.run_lio` against the JAX package's, on
the CPU, on the same scan messages and 100 Hz IMU stream (rolling-shutter
scans of tests/test_torch_lio.py's drive at the tiny sizes of
`__graft_entry__._tiny_cfg`; static init completes at scan 1):

* a plain run, `frame_split_num=2` after `min_scan_count=3` scans (the
  port's test_lio_firstclass.py::test_frame_split_tracks), a stamp
  regression (::test_loop_back_resets_state), `sync_every=2`, an IMU clock
  50 s ahead (test_stream_sync.py::test_tracks_with_offset_imu_clock) and
  `max_samples_per_scan=4` (::test_overflow_surfaces_in_metrics), on the
  classic branch (gn_backend="xla": poses within 1e-4) and the plain run
  on the fast trunk (gn_backend="pallas": 1e-3). The classic bar is wider
  than the one-step bar of tests/test_torch_lio.py (1e-6): the two
  packages' f32 IMU deskew rounds differently, the EKF's velocity and
  gravity see that through the Kalman gain (up to 2.7e-6 a step, that
  file), and a free drive carries it on (1.3e-5 m after 10 scans here).
  For the same reason the ICP iteration count may differ by one (the
  stopping rule's step-norm test; 10 against 9 at scan 8 of the plain
  classic drive). `imu_initialized`, `used_imu` and `imu_overflow` equal
  scan by scan, the other metrics as in tests/test_torch_runner.py;
* the deferred fetch: poses and metrics bit-equal to a hand loop that
  makes the same calls and copies each scan's outputs at once;
* checkpoints: a `LioState` saved after 3 scans and restored with
  `weights_only=True` continues bit-equal.
"""

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.host.runner import LioRunner as JLio
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.host import runner as trunner
from lidar_imu_slam_tpu_torch.host.stream_sync import StreamSynchronizer
from lidar_imu_slam_tpu_torch.models import lio as tlio
from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

from test_torch_runner import _assert_metrics_match

torch.set_num_threads(1)

N_SCANS = 10
TOL = {"xla": 1e-4, "pallas": 1e-3}


def _cfg(c, backend, split=1, cap=16):
    return c.PipelineConfig(
        lidar=c.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                            frame_split_num=split),
        map=c.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                        store_points=backend == "xla"),
        icp=c.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend=backend, deskew=True),
        ekf=c.EkfConfig(lidar_pose_trail=4),
        imu=c.ImuConfig(max_init_count=20, max_samples_per_scan=cap),
        min_scan_count=3,
    )


def _inputs():
    world = jsyn.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = jsyn.make_trajectory(n_poses=N_SCANS, speed=3.0, yaw_rate=0.02, dt=0.1)
    t, gyro, acc = jsyn.make_imu_stream(gt, 0.1, imu_rate=100.0)
    # phase-shifted off the scan boundaries (test_stream_sync.py's reason)
    imu = np.column_stack([t + 1.3e-3, gyro, acc])
    msgs = []
    for i in range(N_SCANS):
        pts, rel = jsyn.render_scan_rolling(world, gt[i], gt[min(i + 1, N_SCANS - 1)], 0.1,
                                            1500, 0.5, 30.0, noise=0.01, seed=i)
        msgs.append({"xyz": pts, "time": i * 0.1 + rel, "stamp": i * 0.1})
    return msgs, imu


MSGS, IMU = _inputs()
OFFSET = IMU + np.r_[50.0, np.zeros(6)]
SCENARIOS = {  # name: (backend, frame_split_num, packet capacity, messages, imu, sync_every)
    "plain": ("xla", 1, 16, MSGS, IMU, 0),
    "split": ("xla", 2, 16, MSGS, IMU, 0),
    "loop_back": ("xla", 1, 16, MSGS[:6] + MSGS[:4], IMU, 0),
    "sync_every": ("xla", 1, 16, MSGS, IMU, 2),
    "offset_clock": ("xla", 1, 16, MSGS, OFFSET, 0),
    "overflow": ("xla", 1, 4, MSGS, IMU, 0),
    "plain_fast": ("pallas", 1, 16, MSGS, IMU, 0),
}


@pytest.fixture(scope="module", params=list(SCENARIOS))
def runs(request):
    backend, split, cap, msgs, imu, sync_every = SCENARIOS[request.param]
    rj = JLio(_cfg(jcfg, backend, split, cap)).run_lio(iter(msgs), imu, sync_every=sync_every)
    rt = trunner.LioRunner(_cfg(tcfg, backend, split, cap), device="cpu").run_lio(
        iter(msgs), imu, sync_every=sync_every)
    return request.param, backend, rj, rt


def test_lio_runner_matches_jax(runs):
    name, backend, rj, rt = runs
    pj, pt = np.stack(rj.poses), np.stack(rt.poses)
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0, atol=TOL[backend])
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], rtol=0, atol=TOL[backend])
    np.testing.assert_allclose(rt.stamps, rj.stamps, rtol=0, atol=1e-12)
    _assert_metrics_match(rt.metrics.records, rj.metrics.records, TOL[backend],
                          iteration_slack=1)


def test_lio_runner_scenarios(runs):
    name, _, _, rt = runs
    recs = rt.metrics.records
    used = [r["used_imu"] for r in recs]
    overflow = [r["imu_overflow"] for r in recs]
    if name == "overflow":
        assert any(o > 0 for o in overflow)
    else:
        assert not any(overflow)
    if name in ("plain", "plain_fast", "sync_every", "split"):
        assert recs[1]["imu_initialized"] == 1.0 and sum(used) == N_SCANS - 2
    if name == "offset_clock":
        # the latched offset shifts the packets by at most an IMU period:
        # the aligned run's branch flags, a pose within 0.1 m
        aligned = trunner.LioRunner(_cfg(tcfg, "xla"), device="cpu").run_lio(iter(MSGS), IMU)
        assert used == [r["used_imu"] for r in aligned.metrics.records]
        d = np.stack(aligned.poses)[:, :3, 3] - np.stack(rt.poses)[:, :3, 3]
        assert np.linalg.norm(d, axis=1).max() < 0.1
    if name == "loop_back":
        # the replay restarts the LIO state from identity
        np.testing.assert_array_equal(rt.poses[6], np.eye(4))
        moved = np.linalg.norm(rt.poses[5][:3, 3])
        assert moved > 0.25 and np.linalg.norm(rt.poses[6][:3, 3]) < 0.25 * moved


def _hand_loop(cfg, msgs, imu):
    """`run_lio`'s calls without its thread and deferred fetch: the same
    synchronizer bucketing, each scan's outputs copied to the host at once."""
    state = tlio.init_state(cfg, "cpu")
    sync = StreamSynchronizer(cfg.imu)
    cap, cursor = cfg.imu.max_samples_per_scan, 0
    poses, recs = [], []
    for m in msgs:
        t_end, stamp = trunner.LioRunner._host_t_end(m), m["stamp"]
        if not sync.offset_set:
            sync.push_imu(imu[cursor, 0], imu[cursor, 1:4], imu[cursor, 4:7])
            cursor += 1
        assert not sync.push_scan(stamp)
        while cursor < len(imu) and imu[cursor, 0] - sync.time_offset <= t_end:
            sync.push_imu(imu[cursor, 0], imu[cursor, 1:4], imu[cursor, 4:7])
            cursor += 1
        take = sync.take_until(t_end, cap)
        scan = preprocess_scan(pack_raw_scan(m["xyz"], time=m["time"], stamp=stamp,
                                             max_points=cfg.lidar.max_points, device="cpu"),
                               cfg.lidar)
        packet = tlio.pack_imu_packet(take[:, 0], take[:, 1:4], take[:, 4:7], cap, device="cpu")
        state, out = tlio.step_donated(state, scan, packet, cfg)
        tables = {t.untyped_storage().data_ptr() for t in state.odo.map}
        kept = [out.pose] + [getattr(out, f) for f in trunner.LIO_FIELDS]
        assert not tables & {t.untyped_storage().data_ptr() for t in kept}
        poses.append(out.pose.numpy().copy())
        recs.append({f: float(getattr(out, f)) for f in trunner.LIO_FIELDS})
    return np.stack(poses), recs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_deferred_fetch_bit_equal_to_hand_loop(backend):
    cfg = _cfg(tcfg, backend)
    r = trunner.LioRunner(cfg, device="cpu").run_lio(iter(MSGS), IMU)
    poses, recs = _hand_loop(cfg, MSGS, IMU)
    np.testing.assert_array_equal(np.stack(r.poses), poses)
    for got, want in zip(r.metrics.records, recs):
        assert {k: got[k] for k in want} == want


def test_checkpoint_resume_exact(tmp_path):
    cfg = _cfg(tcfg, "pallas")
    runner = trunner.LioRunner(cfg, checkpoint_dir=str(tmp_path), checkpoint_every=3,
                               device="cpu").run_lio(iter(MSGS[:3]), IMU)
    restored = trunner.checkpoint_restore(str(tmp_path), tlio.init_state(cfg, "cpu"), 3,
                                          device="cpu")
    assert type(restored) is tlio.LioState and bool(restored.imu_init.done)
    m = MSGS[3]
    scan = preprocess_scan(pack_raw_scan(m["xyz"], time=m["time"], stamp=m["stamp"],
                                         max_points=2048, device="cpu"), cfg.lidar)
    rows = IMU[(IMU[:, 0] > 0.3) & (IMU[:, 0] <= 0.4)]
    packet = tlio.pack_imu_packet(rows[:, 0], rows[:, 1:4], rows[:, 4:7], 16, device="cpu")
    _, o1 = tlio.step(runner.state, scan, packet, cfg)
    _, o2 = tlio.step(restored, scan, packet, cfg)
    assert bool(o1.used_imu) and torch.equal(o1.pose, o2.pose)
    assert torch.equal(o1.ekf_pose, o2.ekf_pose)

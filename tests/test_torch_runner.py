"""The port's `host/runner.OdometryRunner` against the JAX package's, on
the CPU, on the same scan messages (tiny sizes of
`__graft_entry__._tiny_cfg`; sorted scans with per-point time):

* a plain run, `frame_split_num=2` after `min_scan_count=3` scans (the
  port's test_runner_split.py), a stamp regression (the loop-back reset)
  and `sync_every=2`, on the classic f64 path (gn_backend="xla": poses
  within 1e-6 m / 1e-6 on R) and the plain run on the fast path
  (gn_backend="pallas": 1e-3, test_torch_kiss_icp.py's bar). Metrics
  records: the same keys, the integer fields equal, `residual_rms` within
  10 times the pose bar relative, `sigma` within (2 * max_range + 1) times
  the pose bar: sigma accumulates the model deviation's rotation angle
  times 2 * max_range (60 m here) plus its translation;
* the deferred fetch: the runner's poses and metrics bit-equal to a hand
  loop that makes the same calls and copies each scan's outputs to the
  host at once, and no kept output (the backend's keypoints included)
  shares storage with the map tables the next step rewrites in place;
* checkpoints: a `KissState` saved after 3 scans and restored with
  `weights_only=True` continues bit-equal (the port's
  test_pipeline.py::test_checkpoint_resume_exact);
* the loop-closure backend runs (one chunk of poses at a time; the raw
  poses unchanged by it), and the runner defaults to the card.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.host.runner import OdometryRunner as JRunner
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.host import runner as trunner
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

torch.set_num_threads(1)

N_SCANS = 8
TOL = {"xla": 1e-6, "pallas": 1e-3}
MAX_RANGE = 30.0


def _cfg(c, backend, split=1):
    return c.PipelineConfig(
        lidar=c.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                            frame_split_num=split),
        map=c.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                        store_points=backend == "xla"),
        icp=c.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend=backend),
        min_scan_count=3,
    )


def _messages():
    world = jsyn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = jsyn.make_trajectory(n_poses=N_SCANS, speed=1.2, yaw_rate=0.03, dt=0.1)
    msgs = []
    for i in range(N_SCANS):
        pts = jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i)
        msgs.append({"xyz": pts, "time": jsyn.azimuth_times(pts, i * 0.1), "stamp": i * 0.1})
    return msgs


MSGS = _messages()
SCENARIOS = {  # name: (backend, frame_split_num, messages, sync_every)
    "plain": ("xla", 1, MSGS, 0),
    "split": ("xla", 2, MSGS, 0),
    "loop_back": ("xla", 1, MSGS[:5] + MSGS[:4], 0),
    "sync_every": ("xla", 1, MSGS, 2),
    "plain_fast": ("pallas", 1, MSGS, 0),
}


@pytest.fixture(scope="module", params=list(SCENARIOS))
def runs(request):
    backend, split, msgs, sync_every = SCENARIOS[request.param]
    rj = JRunner(_cfg(jcfg, backend, split)).run(iter(msgs), sync_every=sync_every)
    rt = trunner.OdometryRunner(_cfg(tcfg, backend, split), device="cpu").run(
        iter(msgs), sync_every=sync_every)
    return request.param, backend, rj, rt


def _assert_metrics_match(recs_t, recs_j, pose_tol, iteration_slack=0):
    """Same keys in the same order; integer fields equal (icp_iterations
    within `iteration_slack`); residual_rms within 10 x `pose_tol`
    relative, sigma within (2 * max_range + 1) x `pose_tol` (module
    docstring)."""
    assert len(recs_t) == len(recs_j)
    bars = {"residual_rms": lambda v: 10.0 * pose_tol * abs(v),
            "sigma": lambda v: (2.0 * MAX_RANGE + 1.0) * pose_tol,
            "icp_iterations": lambda v: iteration_slack}
    for rt, rj in zip(recs_t, recs_j):
        assert list(rt) == list(rj)
        for k, v in rj.items():
            if k == "wall_time":
                continue
            if k in bars:
                assert abs(rt[k] - v) <= bars[k](v), (rt["scan"], k, rt[k], v)
            else:
                assert rt[k] == v, (rt["scan"], k, rt[k], v)


def test_runner_matches_jax(runs):
    name, backend, rj, rt = runs
    pj, pt = np.stack(rj.poses), np.stack(rt.poses)
    assert pt.shape == pj.shape and pt.dtype == np.float64
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0, atol=TOL[backend])
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], rtol=0, atol=TOL[backend])
    np.testing.assert_allclose(rt.stamps, rj.stamps, rtol=0, atol=1e-12)
    _assert_metrics_match(rt.metrics.records, rj.metrics.records, TOL[backend])
    assert len(rt.timer.samples) == len(pt) - 1


def test_runner_scenarios(runs):
    name, _, rj, rt = runs
    if name == "split":
        # after the warm-up gate, scans 3..7 register twice (2 segments)
        assert int(rt.state.num_poses) == 3 + (N_SCANS - 3) * 2
        assert int(rt.state.num_poses) == int(rj.state.num_poses)
    elif name == "loop_back":
        # the replay restarts from identity against a fresh map
        np.testing.assert_array_equal(rt.poses[5], np.eye(4))
        assert int(rt.state.num_poses) == 4
        np.testing.assert_allclose(np.stack(rt.poses[5:]), np.stack(rt.poses[:4]), atol=1e-12)
    else:
        assert int(rt.state.num_poses) == N_SCANS


def _hand_loop(cfg, msgs):
    """The runner's calls without its thread and deferred fetch: each
    scan's outputs copied to the host at once. Also checks, per scan, that
    no kept output shares storage with the map tables of the new state."""
    state = tk.init_state(cfg, "cpu")
    poses, recs = [], []
    for i, m in enumerate(msgs):
        scan = preprocess_scan(pack_raw_scan(m["xyz"], time=m.get("time"), stamp=m["stamp"],
                                             max_points=cfg.lidar.max_points, device="cpu"),
                               cfg.lidar)
        state, out = tk.register_frame_step(state, scan, cfg)
        tables = {t.untyped_storage().data_ptr() for t in state.map}
        kept = ([out.pose, out.keypoints, out.keypoints_mask]
                + [getattr(out, f) for f in trunner.ODOMETRY_FIELDS])
        assert not tables & {t.untyped_storage().data_ptr() for t in kept}
        poses.append(out.pose.numpy().copy())
        recs.append({f: float(getattr(out, f)) for f in trunner.ODOMETRY_FIELDS})
    return np.stack(poses), recs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_deferred_fetch_bit_equal_to_hand_loop(backend):
    cfg = _cfg(tcfg, backend)
    r = trunner.OdometryRunner(cfg, device="cpu").run(iter(MSGS))
    poses, recs = _hand_loop(cfg, MSGS)
    np.testing.assert_array_equal(np.stack(r.poses), poses)
    for got, want in zip(r.metrics.records, recs):
        assert {k: got[k] for k in want} == want


def test_checkpoint_resume_exact(tmp_path):
    cfg = _cfg(tcfg, "pallas")
    runner = trunner.OdometryRunner(cfg, checkpoint_dir=str(tmp_path), checkpoint_every=3,
                                    device="cpu").run(iter(MSGS[:3]))
    assert (tmp_path / "step_000003.pt").exists()
    restored = trunner.checkpoint_restore(str(tmp_path), tk.init_state(cfg, "cpu"), 3,
                                          device="cpu")
    assert type(restored) is tk.KissState
    for a, b in zip(trunner._flatten(runner.state).values(),
                    trunner._flatten(restored).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    scan = preprocess_scan(pack_raw_scan(MSGS[3]["xyz"], time=MSGS[3]["time"],
                                         stamp=MSGS[3]["stamp"], max_points=2048,
                                         device="cpu"), cfg.lidar)
    _, o1 = tk.register_frame(runner.state, scan, cfg)
    _, o2 = tk.register_frame(restored, scan, cfg)
    assert torch.equal(o1.pose, o2.pose)


def test_checkpoint_restore_checks_the_template(tmp_path):
    cfg = _cfg(tcfg, "xla")
    trunner.checkpoint_save(str(tmp_path), tk.init_state(cfg, "cpu"), 7)
    other = _cfg(tcfg, "xla").replace(map=tcfg.MapConfig(capacity=1 << 10))
    with pytest.raises(ValueError, match="map.keys"):
        trunner.checkpoint_restore(str(tmp_path), tk.init_state(other, "cpu"), 7, device="cpu")
    with pytest.raises(FileNotFoundError):
        trunner.checkpoint_restore(str(tmp_path), tk.init_state(cfg, "cpu"), 8, device="cpu")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_backend_enabled_runs(backend):
    """The loop-closure backend on: every scan a keyframe, two chunks and a
    final flush; the raw poses are the run's without the backend, the
    corrected ones the backend's re-anchoring of them."""
    bcfg = tcfg.BackendConfig(enabled=True, keyframe_dist=0.0, keyframe_rot=0.0, chunk=3,
                              optimize_every=4, min_index_gap=2, max_keyframes=16,
                              max_edges=32)
    # the verification's classic ICP needs the f32 slab on both paths
    base = _cfg(tcfg, backend)
    base = base.replace(map=dataclasses.replace(base.map, store_points=True))
    cfg = base.replace(backend=bcfg)
    r = trunner.OdometryRunner(cfg, device="cpu").run(iter(MSGS))
    plain = trunner.OdometryRunner(base, device="cpu").run(iter(MSGS))
    np.testing.assert_array_equal(np.stack(r.poses), np.stack(plain.poses))
    assert r.backend.kf_scan_idx == list(range(N_SCANS))
    assert r.backend.num_optimizations == 2  # at the second chunk's end, and the final round
    assert not r._chunk  # released
    np.testing.assert_array_equal(r.optimized_poses(), r.backend.correct(np.stack(r.poses)))
    assert all(c.dtype == np.float32 and c.shape == (512, 3) for c in r.backend.kf_clouds)


def test_backend_needs_the_point_slab():
    cfg = _cfg(tcfg, "pallas").replace(backend=tcfg.BackendConfig(enabled=True))
    for cls in (trunner.OdometryRunner, trunner.LioRunner):
        with pytest.raises(ValueError, match="store_points=True"):
            cls(cfg, device="cpu")


@pytest.mark.parametrize("fn", [trunner.OdometryRunner.__init__, trunner.LioRunner.__init__,
                                trunner.checkpoint_restore])
def test_runner_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_runner_without_device_does_not_drive_on_the_cpu():
    # no card here: the default device raises instead of falling back
    with pytest.raises((RuntimeError, AssertionError)):
        trunner.OdometryRunner(_cfg(tcfg, "pallas")).run(iter(MSGS[:1]))

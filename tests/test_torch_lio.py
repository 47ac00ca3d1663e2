"""The port's LIO step (`models/lio.py`) against the JAX package's, on the
CPU, over a drive on which the IMU static initialization completes (built
as tests/test_lio_firstclass.py builds its in-motion drive, at the tiny
sizes of `__graft_entry__._tiny_cfg`), on both registration branches:
the classic f64 `register_core` (gn_backend="xla") and the fast trunk
(gn_backend="pallas", packed map; the kernels' plain versions here).

Tolerances:
* shared-state step (the JAX state carried across with `interop`, one step
  each from it): pose 1e-6 m / 1e-6 rad on the classic branch and 1e-3 on
  the fast one (test_torch_kiss_icp.py's bar: the JAX trunk carries the
  pose in float-float, the port in f64); EKF position and orientation 1e-6, the
  whole mean 1e-5 (the f32 IMU deskew of the two packages rounds
  differently, ~1e-6 m on a point; registration turns that into ~1e-7 m
  of pose, and velocity and gravity see it over a scan period through the
  Kalman gain: measured up to 2.7e-6); the odometry velocities of the
  CV phase (pose differences over a scan period) 1e-5 likewise;
* free drive from the initial state: every pose within 5e-3 m, the branch
  flags equal, and the port's ATE (scan-end convention, `bench.py:_ate`
  with shift 1.0) no worse than JAX's + 1e-3 m;
* packing, the velocity-ring slope, the state round trip: exact or 1e-15.
"""

import numpy as np
import pytest
import torch

import jax

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic
from lidar_imu_slam_tpu.models import lio as jlio
from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan as jpack
from lidar_imu_slam_tpu.ops.preprocess import preprocess_scan as jpre
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.host import synthetic as tsyn
from lidar_imu_slam_tpu_torch.models import lio as tlio
from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan as tpack
from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan as tpre

torch.set_num_threads(1)

N_SCANS = 10
CAP = 16  # IMU packet capacity
POSE_TOL = {"xla": 1e-6, "pallas": 1e-3}


def _cfg(c, backend):
    return c.PipelineConfig(
        lidar=c.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=c.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                        store_points=backend == "xla"),
        icp=c.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend=backend, deskew=True),
        ekf=c.EkfConfig(lidar_pose_trail=4),
        imu=c.ImuConfig(max_init_count=20, max_samples_per_scan=CAP),
    )


def _inputs():
    """Rolling-shutter scans at 3 m/s and the 100 Hz IMU stream of the same
    trajectory, split into per-scan packets (times + 1 ms, at most 10)."""
    world = synthetic.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = synthetic.make_trajectory(n_poses=N_SCANS, speed=3.0, yaw_rate=0.02, dt=0.1)
    packets = tsyn.imu_packets(*synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0), N_SCANS)
    steps = []
    for i in range(N_SCANS):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[min(i + 1, N_SCANS - 1)], 0.1,
                                                 1500, 0.5, 30.0, noise=0.01, seed=i)
        steps.append(dict(pts=pts, time=i * 0.1 + rel, stamp=i * 0.1, imu=packets[i]))
    return gt, steps


def _port_inputs(s, cfg):
    scan = tpre(tpack(s["pts"], time=s["time"], stamp=s["stamp"], max_points=2048,
                      device="cpu"), cfg.lidar)
    return scan, tlio.pack_imu_packet(*s["imu"], CAP, device="cpu")


@pytest.fixture(scope="module")
def drive_inputs():
    return _inputs()


@pytest.fixture(scope="module", params=["xla", "pallas"])
def jax_drive(request, drive_inputs):
    """The JAX drive: the state before each step (numpy leaves) and each
    step's output."""
    backend = request.param
    cfg = _cfg(jcfg, backend)
    _, steps = drive_inputs
    step = jax.jit(jlio.step, static_argnames=("cfg",))
    state = jlio.init_state(cfg)
    before, outs = [], []
    for s in steps:
        before.append(jax.tree.map(np.asarray, state))
        scan = jpre(jpack(s["pts"], time=s["time"], stamp=s["stamp"], max_points=2048),
                    cfg.lidar)
        state, out = step(state, scan, jlio.pack_imu_packet(*s["imu"], CAP), cfg=cfg)
        outs.append(jax.tree.map(np.asarray, out))
    return backend, before, outs


def _ate(poses, gt, shift=1.0):
    """bench.py:_ate: translation RMS ATE against ground truth interpolated
    at `shift` scan periods (1.0: LIO poses are at scan end)."""
    n = poses.shape[0]
    pos = gt[:, :3, 3]
    t = np.minimum(np.arange(n, dtype=np.float64) + shift, len(gt) - 1.0)
    k = np.minimum(t.astype(int), len(gt) - 2)
    a = (t - k)[:, None]
    target = (1.0 - a) * pos[k] + a * pos[k + 1]
    target_rel = (target - target[0]) @ gt[0, :3, :3]
    d = (poses[:, :3, 3] - poses[0, :3, 3]) - target_rel
    return float(np.sqrt(np.mean(np.sum(d ** 2, axis=-1))))


def test_free_drive_matches_jax(jax_drive, drive_inputs):
    backend, _, j_outs = jax_drive
    gt, steps = drive_inputs
    cfg = _cfg(tcfg, backend)
    state = tlio.init_state(cfg, "cpu")
    poses, used, inited = [], [], []
    for s in steps:
        state, out = tlio.step(state, *_port_inputs(s, cfg), cfg)
        poses.append(out.pose.numpy())
        used.append(bool(out.used_imu))
        inited.append(bool(out.imu_initialized))
    poses = np.stack(poses)
    j_poses = np.stack([o.pose for o in j_outs])
    assert used == [bool(o.used_imu) for o in j_outs]
    assert inited == [bool(o.imu_initialized) for o in j_outs]
    assert inited[1] and sum(used) == N_SCANS - 2  # init completes at scan 1
    np.testing.assert_allclose(poses[:, :3, 3], j_poses[:, :3, 3], rtol=0, atol=5e-3)
    assert _ate(poses, gt) <= _ate(j_poses, gt) + 1e-3


@pytest.mark.parametrize("k", [0, 1, 2, 6])  # CV, just-done seed, first IMU step, steady
def test_shared_state_step_matches_jax(jax_drive, drive_inputs, k):
    backend, before, j_outs = jax_drive
    _, steps = drive_inputs
    cfg = _cfg(tcfg, backend)
    state = interop.lio_state_from_numpy(before[k], "cpu")
    new, out = tlio.step(state, *_port_inputs(steps[k], cfg), cfg)
    jo, tol = j_outs[k], POSE_TOL[backend]
    np.testing.assert_allclose(out.pose[:3, 3].numpy(), jo.pose[:3, 3], rtol=0, atol=tol)
    np.testing.assert_allclose(out.pose[:3, :3].numpy(), jo.pose[:3, :3], rtol=0, atol=tol)
    assert bool(out.used_imu) == bool(jo.used_imu)
    j_next = before[k + 1]
    m, jm = new.ekf.m.numpy(), j_next.ekf.m
    for sl in (slice(0, 3), slice(6, 10)):  # position, orientation
        np.testing.assert_allclose(m[sl], jm[sl], rtol=0, atol=1e-6)
    np.testing.assert_allclose(m, jm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.ekf_pose.numpy(), jo.ekf_pose, rtol=0, atol=1e-6)
    for f in ("last_imu", "vel_ring", "vel_ring_n", "init_v0", "init_t0", "scan_count"):
        # vel_ring / init_v0 are pose differences over a scan period: the
        # velocity bar
        np.testing.assert_allclose(getattr(new, f).numpy(), getattr(j_next, f), rtol=0,
                                   atol=1e-5, err_msg=f)
    for f in ("count", "done"):
        assert getattr(new.imu_init, f).numpy() == getattr(j_next.imu_init, f)


def test_state_round_trip_and_init_match(jax_drive):
    backend, before, _ = jax_drive
    for tree in (before[0], before[3]):
        back = interop.lio_state_to_numpy(interop.lio_state_from_numpy(tree, "cpu"))
        a, b = jax.tree.leaves(tree), jax.tree.leaves(tuple(back))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)
    fresh = interop.lio_state_to_numpy(tlio.init_state(_cfg(tcfg, backend), "cpu"))
    for x, y in zip(jax.tree.leaves(before[0]), jax.tree.leaves(tuple(fresh))):
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)


@pytest.mark.parametrize("n", [0, 3, 10])
def test_pack_imu_packet_and_prev_sample_match(n):
    rng = np.random.default_rng(n)
    t, g, a = np.sort(rng.uniform(1, 2, n)), rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    jp = jax.tree.map(np.asarray, jlio.pack_imu_packet(t, g, a, CAP))
    tp = tlio.pack_imu_packet(t, g, a, CAP, device="cpu")
    for f in tp._fields:
        assert np.array_equal(getattr(tp, f).numpy(), getattr(jp, f))
    last = rng.normal(size=7)
    last[0] = 0.5 if n else 0.0  # no previous sample: masked
    jf = jlio._with_prev_sample(jlio.pack_imu_packet(t, g, a, CAP), jax.numpy.asarray(last))
    tf = tlio._with_prev_sample(tp, torch.from_numpy(last))
    for f in tf._fields:
        assert np.array_equal(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)))
    with pytest.raises(ValueError):
        tlio.pack_imu_packet(np.zeros(CAP + 1), np.zeros((CAP + 1, 3)),
                             np.zeros((CAP + 1, 3)), CAP, device="cpu")


@pytest.mark.parametrize("n", [0, 2, 3, 5, 8, 12])
def test_ring_accel_matches(n):
    ring = np.random.default_rng(n).normal(size=(tlio.VEL_RING, 3))
    want = np.asarray(jlio._ring_accel(jax.numpy.asarray(ring), jax.numpy.int32(n), 0.1))
    got = tlio._ring_accel(torch.from_numpy(ring), torch.tensor(n, dtype=torch.int32), 0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_step_donated_matches_step(drive_inputs, backend):
    _, steps = drive_inputs
    cfg = _cfg(tcfg, backend)
    a = tlio.init_state(cfg, "cpu")
    b = tlio.init_state(cfg, "cpu")
    for s in steps[:4]:
        a, oa = tlio.step(a, *_port_inputs(s, cfg), cfg)
        b, ob = tlio.step_donated(b, *_port_inputs(s, cfg), cfg)
        assert torch.equal(oa.pose, ob.pose) and torch.equal(a.ekf.m, b.ekf.m)
    for x, y in zip(a.odo.map, b.odo.map):
        assert torch.equal(x, y)

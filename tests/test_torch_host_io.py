"""The port's host modules against the JAX package's, on the same inputs
(numpy, made from seeds):

* `host/stream_sync.StreamSynchronizer` on each scenario of
  tests/test_stream_sync.py and the overflow of test_lio_firstclass.py:
  the same buffers, offset, flags, counters, warnings and `take_until`
  rows (exact: the same float64 operations);
* `ops/preprocess.segment_ids` / `split_scan` / `split_scan_compact` on
  the same preprocessed scan: masks and xyz bit-equal, `rel_t`,
  `t_begin`, `t_end` within 1e-12 s (f64), `tau` within 1e-6 (f32);
* `utils/trajectory.write_tum` / `write_kitti` byte-equal files,
  `rpe_rmse` within 1e-12;
* `config_io.from_dict` / `from_yaml` / `to_dict`: equal dicts, unknown
  keys rejected;
* `host/kitti` on a sequence directory the test writes: equal arrays;
* `host/rosbag` on bags written by `tools/bag_writer.py` (unchunked,
  chunks stored as is, bz2 chunks): both packages' readers give the same
  arrays, equal to what was written;
* `utils/cloud_io.write_ply` / `read_ply` byte-equal and equal arrays;
  `export_map_ply` of a JAX map carried across with `interop`: the same
  bytes;
* every `host/adversarial` function: equal outputs for the same seed;
* `utils/metrics`: the same records, summary and JSONL lines (wall time
  aside), the same StepTimer percentiles; a tensor is refused (it would
  be a device read per value).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu import config_io as jcio
from lidar_imu_slam_tpu.host import adversarial as jadv
from lidar_imu_slam_tpu.host import kitti as jkitti
from lidar_imu_slam_tpu.host import rosbag as jbag
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.host.stream_sync import StreamSynchronizer as JSync
from lidar_imu_slam_tpu.models import kiss_icp as jk
from lidar_imu_slam_tpu.ops import preprocess as jpre
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.utils import cloud_io as jcloud
from lidar_imu_slam_tpu.utils import metrics as jmetrics
from lidar_imu_slam_tpu.utils import trajectory as jtraj
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import config_io as tcio
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.host import adversarial as tadv
from lidar_imu_slam_tpu_torch.host import kitti as tkitti
from lidar_imu_slam_tpu_torch.host import rosbag as tbag
from lidar_imu_slam_tpu_torch.host.stream_sync import StreamSynchronizer as TSync
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.tools import bag_writer
from lidar_imu_slam_tpu_torch.utils import cloud_io as tcloud
from lidar_imu_slam_tpu_torch.utils import metrics as tmetrics
from lidar_imu_slam_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)

G = [0, 0, 9.81]


# ---------------------------------------------------------------------------
# stream synchronizer
# ---------------------------------------------------------------------------


def _sync_offset(s):
    for k in range(5):
        s.push_imu(100.0 + 0.01 * k, np.zeros(3), G)
    flags = [s.push_scan(0.05)]
    s.push_imu(100.06, np.zeros(3), G)
    return flags, [s.take_until(0.2, 32)]


def _sync_small_offset(s):
    s.push_imu(0.01, np.zeros(3), G)
    return [s.push_scan(0.05)], [s.take_until(1.0, 32)]


def _sync_imu_loop_back(s):
    for k in range(4):
        s.push_imu(0.01 * k, np.zeros(3), G)
    s.push_imu(0.005, np.zeros(3), G)
    return [], [s.take_until(1.0, 32)]


def _sync_lidar_loop_back(s):
    return [s.push_scan(1.0), s.push_scan(0.5), s.push_scan(0.7)], []


def _sync_rate_warning(s):
    for k in range(8):
        s.push_imu(0.05 * k, np.zeros(3), G)
    return [], []


def _sync_running_mean(s):
    accs = np.random.default_rng(0).normal([0, 0, 9.8], 0.05, (50, 3))
    for k, a in enumerate(accs):
        s.push_imu(0.005 * k, np.zeros(3), a)
    return [], []


def _sync_overflow(s):
    for k in range(20):
        s.push_imu(0.005 * k, np.zeros(3), G)
    takes = [s.take_until(0.05, 8), s.take_until(1.0, 8)]
    return [], takes


def _sync_enu_stream(s):
    rng = np.random.default_rng(1)
    takes, flags = [], []
    for i in range(6):
        for k in range(10):
            t = 20.0 + i * 0.1 + k * 0.01 + 0.0013
            s.push_imu(t, rng.normal(0, 0.1, 3), rng.normal(G, 0.1))
        flags.append(s.push_scan(i * 0.1))
        takes.append(s.take_until(i * 0.1 + 0.1, 8))
    return flags, takes


SYNC_CASES = {"offset": (_sync_offset, 8, "ned"), "small_offset": (_sync_small_offset, 8, "ned"),
              "imu_loop_back": (_sync_imu_loop_back, 8, "ned"),
              "lidar_loop_back": (_sync_lidar_loop_back, 8, "ned"),
              "rate_warning": (_sync_rate_warning, 8, "ned"),
              "running_mean": (_sync_running_mean, 100, "ned"),
              "overflow": (_sync_overflow, 8, "ned"), "enu_offset_stream": (_sync_enu_stream, 30,
                                                                           "enu")}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_stream_synchronizer_matches_jax(case):
    drive, reset, coordinate = SYNC_CASES[case]
    seen = {}
    for name, cls, c in (("jax", JSync, jcfg), ("torch", TSync, tcfg)):
        warns = []
        s = cls(c.ImuConfig(reset=reset, coordinate=coordinate, max_samples_per_scan=32),
                warn=warns.append)
        flags, takes = drive(s)
        seen[name] = (s, flags, takes, warns)
    (sj, fj, tj, wj), (st, ft, tt, wt) = seen["jax"], seen["torch"]
    assert ft == fj and wt == wj and len(tt) == len(tj)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a, b)
    for attr in ("time_offset", "offset_set", "count", "period", "prev_scan_stamp",
                 "last_raw_imu_time", "last_overflow", "total_overflow"):
        assert getattr(st, attr) == getattr(sj, attr), attr
    np.testing.assert_array_equal(st.mean_acc, sj.mean_acc)
    np.testing.assert_array_equal(np.asarray(st.buffer), np.asarray(sj.buffer))
    if case in ("offset", "imu_loop_back", "rate_warning", "overflow"):
        assert wt  # the scenario's warning fired in both packages


# ---------------------------------------------------------------------------
# frame splitting
# ---------------------------------------------------------------------------


def _scan_pair(n_points, cap, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-20, 20, (n_points, 3)).astype(np.float32)
    xyz[rng.uniform(size=n_points) < 0.05] *= 100.0  # beyond max_range: masked
    t = 5.0 + rng.uniform(0, 0.1, n_points)
    t[rng.choice(n_points, 8)] = 5.05  # equal times
    raw = tpre.pack_raw_scan(xyz, time=t, stamp=5.0, max_points=cap, device="cpu")
    scan = tpre.preprocess_scan(raw, tcfg.LidarConfig(max_range=50.0, min_range=1.0,
                                                      max_points=cap))
    jscan = jpre.Scan(*(jnp.asarray(f.numpy()) for f in scan))
    return scan, jscan


def _assert_scans_match(t, j):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.xyz.numpy(), np.asarray(j.xyz))
    np.testing.assert_allclose(t.rel_t.numpy(), np.asarray(j.rel_t), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.tau.numpy(), np.asarray(j.tau), rtol=0, atol=1e-6)
    for f in ("t_begin", "t_end"):
        assert abs(float(getattr(t, f)) - float(getattr(j, f))) <= 1e-12, f


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_points,cap", [(100, 128), (1000, 1024), (7, 64)])
def test_split_functions_match_jax(k, n_points, cap):
    scan, jscan = _scan_pair(n_points, cap, seed=k + n_points)
    np.testing.assert_array_equal(tpre.segment_ids(scan, k).numpy(),
                                  np.asarray(jpre.segment_ids(jscan, k)))
    for fn_t, fn_j in ((tpre.split_scan, jpre.split_scan),
                       (tpre.split_scan_compact, jpre.split_scan_compact)):
        segs_t, segs_j = fn_t(scan, k), fn_j(jscan, k)
        assert len(segs_t) == len(segs_j) == k
        for t, j in zip(segs_t, segs_j):
            assert t.xyz.shape == j.xyz.shape and t.tau.dtype == torch.float32
            _assert_scans_match(t, j)
    # the compact segments hold every valid point once
    assert sum(int(s.mask.sum()) for s in tpre.split_scan_compact(scan, k)) == int(scan.mask.sum())


# ---------------------------------------------------------------------------
# trajectory writers, RPE
# ---------------------------------------------------------------------------


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        # rotations that reach every branch of the quaternion conversion
        angle = [0.3, np.pi - 0.01, np.pi - 0.02, np.pi - 0.03][i % 4]
        axis = [rng.normal(size=3), [1, 0.01, 0], [0.01, 1, 0], [0, 0.01, 1]][i % 4]
        axis = np.asarray(axis, float) / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
        T[:3, 3] = rng.normal(0, 20, 3)
        out.append(T)
    return np.stack(out)


def test_trajectory_writers_byte_equal(tmp_path):
    poses = _poses(12, 0)
    stamps = 1e9 + np.arange(12) * 0.1
    for name, write_t, write_j, args in (
            ("tum", ttraj.write_tum, jtraj.write_tum, (stamps, poses)),
            ("kitti", ttraj.write_kitti, jtraj.write_kitti, (poses,))):
        a, b = tmp_path / f"t.{name}", tmp_path / f"j.{name}"
        write_t(str(a), *args)
        write_j(str(b), *args)
        assert a.read_bytes() == b.read_bytes() and len(a.read_text().splitlines()) == 12
    for R in poses[:4, :3, :3]:
        np.testing.assert_array_equal(ttraj._rot_to_quat_np(R), jtraj._rot_to_quat_np(R))


def test_rpe_matches_jax():
    est, gt = _poses(15, 1), _poses(15, 2)
    for delta in (1, 3):
        np.testing.assert_allclose(ttraj.rpe_rmse(est, gt, delta), jtraj.rpe_rmse(est, gt, delta),
                                   rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# config I/O
# ---------------------------------------------------------------------------

OVERRIDES = {"map": {"voxel_size": 0.25, "capacity": 4096.0}, "icp": {"deskew": True},
             "lidar": {"frame_split_num": 2}, "ekf": {"lidar_pose_trail": 6},
             "min_scan_count": 3}


def test_config_io_matches_jax(tmp_path):
    for base_t, base_j in ((None, None), (tcfg.kitti_64beam(), jcfg.kitti_64beam())):
        ct, cj = tcio.from_dict(OVERRIDES, base_t), jcio.from_dict(OVERRIDES, base_j)
        assert tcio.to_dict(ct) == jcio.to_dict(cj)
        assert isinstance(ct.map.capacity, int) and ct.ekf.state_dim == cj.ekf.state_dim
    p = tmp_path / "cfg.yaml"
    p.write_text("map:\n  voxel_size: 2.0\nekf:\n  lidar_pose_trail: 6\nicp:\n  gn_backend: pallas\n")
    assert tcio.to_dict(tcio.from_yaml(str(p))) == jcio.to_dict(jcio.from_yaml(str(p)))
    assert tcio.to_dict(tcfg.PipelineConfig()) == jcio.to_dict(jcfg.PipelineConfig())


@pytest.mark.parametrize("bad", [{"map": {"voxelsize": 0.25}}, {"nope": 1}])
def test_config_io_rejects_unknown_keys(bad):
    for mod in (tcio, jcio):
        with pytest.raises(KeyError, match="unknown config key"):
            mod.from_dict(bad)


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------


def test_kitti_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    seq = tmp_path / "00"
    (seq / "velodyne").mkdir(parents=True)
    for i in range(3):
        rng.uniform(-50, 50, (200 + i, 4)).astype(np.float32).tofile(
            str(seq / "velodyne" / f"{i:06d}.bin"))
    np.savetxt(str(seq / "times.txt"), np.arange(3) * 0.1037)
    gt = _poses(3, 4)
    np.savetxt(str(tmp_path / "poses.txt"), gt[:, :3, :4].reshape(3, 12))
    tr = np.eye(4)
    tr[:3, :3] = _poses(1, 5)[0, :3, :3]
    tr[:3, 3] = [0.3, -0.1, 0.2]
    (seq / "calib.txt").write_text(
        "P0: " + " ".join(map(str, np.arange(12.0))) + "\nTr: "
        + " ".join(f"{v:.12e}" for v in tr[:3, :4].reshape(-1)) + "\n")
    st = tkitti.KittiSequence(str(seq), poses_file=str(tmp_path / "poses.txt"))
    sj = jkitti.KittiSequence(str(seq), poses_file=str(tmp_path / "poses.txt"))
    assert len(st) == len(sj) == 3
    np.testing.assert_array_equal(st.times, sj.times)
    np.testing.assert_array_equal(st.gt_poses, sj.gt_poses)
    assert st.calib.keys() == sj.calib.keys()
    for k in st.calib:
        np.testing.assert_array_equal(st.calib[k], sj.calib[k])
    for mt, mj in zip(st, sj):
        assert mt.keys() == mj.keys() and mt["stamp"] == mj["stamp"]
        for k in ("xyz", "intensity", "ring"):
            np.testing.assert_array_equal(mt[k], mj[k])
    np.testing.assert_array_equal(tkitti.velo_to_cam_poses(gt, st.calib),
                                  jkitti.velo_to_cam_poses(gt, sj.calib))


# ---------------------------------------------------------------------------
# rosbag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, "none", "bz2"])
def test_rosbag_reader_matches_jax(tmp_path, compression):
    rng = np.random.default_rng(6)
    scans = [{"xyz": rng.uniform(-10, 10, (40 + i, 3)).astype(np.float32),
              "time": 10.0 + i * 0.1 + np.linspace(0, 0.09, 40 + i), "stamp": 10.0 + i * 0.1}
             for i in range(4)]
    scans.append({"xyz": rng.uniform(-10, 10, (30, 3)).astype(np.float32), "stamp": 10.4})
    imu = np.column_stack([10.0 + np.arange(45) * 0.01 + 0.0013, rng.normal(0, 0.1, (45, 6))])
    path = str(tmp_path / "drive.bag")
    bag_writer.write_bag(path, scans, imu, compression=compression, chunk_messages=7)
    lt, it = tbag.read_sensor_streams(path)
    lj, ij = jbag.read_sensor_streams(path)
    assert len(lt) == len(lj) == 5 and len(it) == len(ij) == 45
    for mt, mj, s in zip(lt, lj, scans):
        assert mt["stamp"] == mj["stamp"] and abs(mt["stamp"] - s["stamp"]) < 1e-9
        assert mt["fields"].keys() == mj["fields"].keys()
        for k in mt["fields"]:
            np.testing.assert_array_equal(mt["fields"][k], mj["fields"][k])
        np.testing.assert_array_equal(np.stack([mt["fields"][c] for c in "xyz"], 1), s["xyz"])
        if "time" in s:
            np.testing.assert_array_equal(mt["fields"]["time"], s["time"])
    for mt, mj, row in zip(it, ij, imu):
        assert mt["stamp"] == mj["stamp"] and abs(mt["stamp"] - row[0]) < 1e-9
        for k in ("orientation", "gyro", "acc"):
            np.testing.assert_array_equal(mt[k], mj[k])
        np.testing.assert_array_equal(np.r_[mt["gyro"], mt["acc"]], row[1:])
    # the lidar topic filter
    assert tbag.read_sensor_streams(path, lidar_topic="/other")[0] == []


def test_rosbag_rejects_other_files(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"#ROSBAG V1.2\n")
    with pytest.raises(ValueError, match="not a rosbag 2.0"):
        tbag.read_sensor_streams(str(p))


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------


def test_ply_byte_equal(tmp_path):
    pts = np.random.default_rng(7).normal(0, 10, (100, 3)).astype(np.float32)
    tcloud.write_ply(str(tmp_path / "t.ply"), pts)
    jcloud.write_ply(str(tmp_path / "j.ply"), pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tcloud.read_ply(str(tmp_path / "t.ply")),
                                  jcloud.read_ply(str(tmp_path / "j.ply")))
    np.testing.assert_allclose(tcloud.read_ply(str(tmp_path / "t.ply")), pts, atol=1e-4)


@pytest.mark.parametrize("store_points", [True, False])
def test_export_map_ply_matches_jax(tmp_path, store_points):
    kw = dict(voxel_size=0.5, max_range=30.0, capacity=1 << 12, store_points=store_points)
    cj = jcfg.PipelineConfig(map=jcfg.MapConfig(**kw))
    mc = tcfg.MapConfig(**kw)
    world = jsyn.make_world(seed=8, n_points=20000, extent=(20.0, 8.0, 4.0))
    pts = jsyn.render_scan(world, np.eye(4), 1500, 0.5, 30.0, seed=8).astype(np.float32)
    state = jk.init_state(cj)
    m = jvm.insert(state.map, jnp.asarray(pts), jnp.ones(len(pts), bool), cj.map)
    tree = jk.KissState(*(np.asarray(a) if not hasattr(a, "_fields") else
                          type(a)(*map(np.asarray, a)) for a in state._replace(map=m)))
    st = interop.kiss_state_from_numpy(tree, "cpu")
    tcloud.export_map_ply(str(tmp_path / "t.ply"), st.map, mc)
    jcloud.export_map_ply(str(tmp_path / "j.ply"), m, cj.map)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert len(tcloud.read_ply(str(tmp_path / "t.ply"))) > 1000


# ---------------------------------------------------------------------------
# adversarial injectors
# ---------------------------------------------------------------------------


def _msg(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-20, 20, (500, 3))
    return {"xyz": xyz, "time": 3.0 + np.linspace(0, 0.09, 500), "stamp": 3.0}


ADVERSARIAL = {
    "assign_rings": lambda mod, m: mod.assign_rings(m, 16),
    "drop_rings": lambda mod, m: mod.drop_rings(mod.assign_rings(m, 16), [1, 5, 9]),
    "wrap_timestamps": lambda mod, m: mod.wrap_timestamps(m, 0.1),
    "jitter_clock": lambda mod, m: {"time": mod.jitter_clock(m["time"], 2e-3, 0.5, seed=3)},
    "add_moving_outliers": lambda mod, m: mod.add_moving_outliers(
        mod.assign_rings(m), 50, scan_index=4, seed=4),
    "add_reflective_ghosts": lambda mod, m: mod.add_reflective_ghosts(
        mod.assign_rings(m), 0.1, seed=5),
    "drop_random_points": lambda mod, m: mod.drop_random_points(m, 0.3, seed=6),
}


@pytest.mark.parametrize("fn", list(ADVERSARIAL))
def test_adversarial_matches_jax(fn):
    out_t = ADVERSARIAL[fn](tadv, _msg(9))
    out_j = ADVERSARIAL[fn](jadv, _msg(9))
    assert out_t.keys() == out_j.keys()
    for k in out_t:
        a, b = out_t[k], out_j[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b



# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_metrics_match_jax(tmp_path):
    logs, timers = [], []
    for mod in (tmetrics, jmetrics):
        log, timer = mod.MetricsLog(), mod.StepTimer()
        for i in range(7):
            log.append(i, icp_iterations=np.int32(i + 3), sigma=np.float64(0.1 * i),
                       icp_converged=bool(i % 2), imu_overflow=i, note="x")
            timer.record(0.01 * ((i * 5) % 7))
        log.dump_jsonl(str(tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"))
        logs.append(log)
        timers.append(timer)
    strip = [[{k: v for k, v in r.items() if k != "wall_time"} for r in log.records]
             for log in logs]
    assert strip[0] == strip[1] and logs[0].summary() == logs[1].summary()
    lines = [[{k: v for k, v in json.loads(line).items() if k != "wall_time"}
              for line in p.read_text().splitlines()] for p in sorted(tmp_path.glob("*.jsonl"))]
    assert lines[0] == lines[1] == strip[0]
    for p in (50, 95, 100):
        assert timers[0].percentile(p) == timers[1].percentile(p)
    assert np.isnan(tmetrics.StepTimer().p50)
    with pytest.raises(TypeError, match="tensor"):
        tmetrics.MetricsLog().append(0, sigma=torch.tensor(1.0))

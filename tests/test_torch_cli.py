"""The port's CLI (`lidar_imu_slam_tpu_torch.cli`) against the JAX
package's, on the CPU (`main(argv, device="cpu")`):

* `--synthetic 6 --preset default --config small.yaml`: the summary line
  has JAX's keys, `scans` 6, ATE within 1e-3 m of JAX's CLI on the same
  arguments (both run the classic f64 path: their poses agree to ~1e-6,
  tests/test_torch_runner.py), and the TUM file 6 lines of 8 columns;
* `--save-clouds` (the port's test_cloud_io.py::test_cli_save_clouds);
* `--bag f --lio` on a bag written by `tools/bag_writer.py`: one pose a
  scan, the IMU branch after static init;
* `--loop-closure` runs the backend and writes `<out>.optimized`;
* no fallback and no JAX: every module of the port's runners, CLI and
  backend (and the oracle, profiling and native packer) imports with
  `jax` and `lidar_imu_slam_tpu` blocked, and `main` without a device
  targets the card, which this box does not have.
"""

import contextlib
import inspect
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import cli as jcli
from lidar_imu_slam_tpu_torch import cli as tcli
from lidar_imu_slam_tpu_torch.host import synthetic as tsyn
from lidar_imu_slam_tpu_torch.tools import bag_writer
from lidar_imu_slam_tpu_torch.utils import cloud_io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("cli", "config_io", "host.runner", "host.stream_sync", "host.adversarial",
               "host.kitti", "host.rosbag", "utils.metrics", "utils.cloud_io",
               "utils.trajectory", "ops.preprocess", "tools.bag_writer",
               "models.backend", "host.keyframes", "validation", "validation.oracle",
               "utils.profiling", "host.native", "interop", "parallel.mesh",
               "parallel.sharded_map", "parallel.dryrun")


def _small_yaml(tmp_path, extra=""):
    p = tmp_path / "small.yaml"
    p.write_text(
        "lidar:\n  max_points: 8192\n  min_range: 0.5\n  max_range: 30.0\n"
        "map:\n  voxel_size: 0.5\n  capacity: 16384\n  max_range: 30.0\n"
        "icp:\n  max_map_points: 8192\n  max_source_points: 2048\n" + extra
    )
    return str(p)


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _small_yaml(tmp)
    runs = {}
    for name, main, kw in (("jax", jcli.main, {}), ("torch", tcli.main, {"device": "cpu"})):
        out = tmp / f"{name}.tum"
        metrics = tmp / f"{name}.jsonl"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--synthetic", "6", "--preset", "default", "--config", cfg,
                       "--out", str(out), "--metrics-out", str(metrics)], **kw)
        runs[name] = dict(rc=rc, summary=_summary(buf.getvalue()), tum=out.read_text(),
                          metrics=[json.loads(line) for line in metrics.read_text().splitlines()])
    return runs


def test_cli_synthetic_matches_jax(synthetic_runs):
    j, t = synthetic_runs["jax"], synthetic_runs["torch"]
    assert t["rc"] == j["rc"] == 0
    assert list(t["summary"]) == list(j["summary"])
    assert t["summary"]["scans"] == 6
    assert abs(t["summary"]["ate_rmse_m"] - j["summary"]["ate_rmse_m"]) <= 1e-3
    lines = t["tum"].strip().splitlines()
    assert len(lines) == 6 and all(len(line.split()) == 8 for line in lines)
    tum_t = np.loadtxt(lines)
    tum_j = np.loadtxt(j["tum"].strip().splitlines())
    np.testing.assert_allclose(tum_t[:, :4], tum_j[:, :4], rtol=0, atol=1e-5)
    assert [list(r) for r in t["metrics"]] == [list(r) for r in j["metrics"]]


def test_cli_save_clouds(tmp_path):
    clouds = tmp_path / "clouds"
    rc = tcli.main(["--synthetic", "6", "--preset", "default",
                    "--config", _small_yaml(tmp_path), "--out", str(tmp_path / "traj.tum"),
                    "--save-clouds", str(clouds), "--save-clouds-every", "2"], device="cpu")
    assert rc == 0
    frames = sorted(clouds.glob("frame_*.ply"))
    assert len(frames) == 3 and len(sorted(clouds.glob("keypoints_*.ply"))) == 3
    pts = cloud_io.read_ply(str(frames[-1]))
    assert len(pts) > 100 and np.isfinite(pts).all()
    m = cloud_io.read_ply(str(clouds / "local_map.ply"))
    assert len(m) > 1000 and np.isfinite(m).all()


def test_cli_bag_lio(tmp_path, capsys):
    n = 8
    world = tsyn.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = tsyn.make_trajectory(n_poses=n, speed=3.0, yaw_rate=0.02, dt=0.1)
    t, gyro, acc = tsyn.make_imu_stream(gt, 0.1, imu_rate=100.0)
    scans = []
    for i in range(n):
        pts, rel = tsyn.render_scan_rolling(world, gt[i], gt[min(i + 1, n - 1)], 0.1, 1500,
                                            0.5, 30.0, noise=0.01, seed=i)
        scans.append({"xyz": pts, "time": 100.0 + i * 0.1 + rel, "stamp": 100.0 + i * 0.1})
    bag = str(tmp_path / "drive.bag")
    bag_writer.write_bag(bag, scans, np.column_stack([100.0 + t + 1.3e-3, gyro, acc]),
                         compression="bz2")
    cfg = _small_yaml(tmp_path, "imu:\n  max_init_count: 20\n  max_samples_per_scan: 16\n"
                      "ekf:\n  lidar_pose_trail: 4\n")
    rc = tcli.main(["--bag", bag, "--lio", "--preset", "default", "--config", cfg,
                    "--out", str(tmp_path / "traj.tum"),
                    "--metrics-out", str(tmp_path / "m.jsonl")], device="cpu")
    assert rc == 0
    summary = _summary(capsys.readouterr().out)
    assert summary["scans"] == n
    assert len((tmp_path / "traj.tum").read_text().splitlines()) == n
    recs = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["used_imu"] for r in recs][2:] == [1.0] * (n - 2)
    assert not any(r["imu_overflow"] for r in recs)


def test_cli_loop_closure_writes_optimized(tmp_path, capsys):
    """`--loop-closure` runs the backend (a keyframe every 0.1 m, an
    optimization every 2) and writes `<out>.optimized` beside `<out>`: one
    TUM line a scan, the same stamps; with no loop on this straight drive
    the correction is the identity up to the rotations' re-projection."""
    cfg = _small_yaml(tmp_path, "backend:\n  keyframe_dist: 0.1\n  optimize_every: 2\n"
                                "  chunk: 2\n")
    out = tmp_path / "traj.tum"
    rc = tcli.main(["--synthetic", "12", "--preset", "default", "--config", cfg,
                    "--loop-closure", "--out", str(out)], device="cpu")
    assert rc == 0 and _summary(capsys.readouterr().out)["scans"] == 12
    raw = np.loadtxt(out)
    opt = np.loadtxt(str(out) + ".optimized")
    assert raw.shape == opt.shape == (12, 8)
    np.testing.assert_array_equal(opt[:, 0], raw[:, 0])
    np.testing.assert_allclose(opt[:, 1:4], raw[:, 1:4], atol=1e-9)
    np.testing.assert_allclose(np.abs(opt[:, 4:]), np.abs(raw[:, 4:]), atol=1e-6)


def test_cli_defaults_to_the_card(tmp_path):
    assert inspect.signature(tcli.main).parameters["device"].default == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        tcli.main(["--synthetic", "3", "--preset", "default", "--config",
                   _small_yaml(tmp_path), "--out", str(tmp_path / "t.tum")])


@pytest.fixture(scope="module")
def blocked_imports():
    """Each new module imported in one child process with `jax` and
    `lidar_imu_slam_tpu` blocked: {module: "ok" or the error}."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\nsys.modules['lidar_imu_slam_tpu'] = None\n"
        "out = {}\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    try:\n"
        "        importlib.import_module('lidar_imu_slam_tpu_torch.' + name)\n"
        "        bad = [m for m in sys.modules if sys.modules[m] is not None and"
        " (m == 'jax' or m.startswith(('jax.', 'lidar_imu_slam_tpu.')))]\n"
        "        out[name] = 'ok' if not bad else f'imported {bad}'\n"
        "    except Exception as e:\n"
        "        out[name] = repr(e)\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_without_jax(blocked_imports, module):
    assert blocked_imports[module] == "ok"

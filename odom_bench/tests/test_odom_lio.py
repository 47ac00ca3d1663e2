"""The LiDAR-inertial ensemble driver (`drivers/lio_ensemble.py`) at a small
shape on the CPU (the port's plain kernel versions): against its plain
reference (`reference/lio.py`) on three seeds, the f32 control and the four
faults of `lio_faults.py` each not correct, the two filter readers on a
hand-made trace and on a traced small cell, and the reference loading
nothing of the port. The small cell is built with `tests/cells.py`'s
helpers: the configuration's pipeline at a 4096-point buffer, 2 ensembles
of 2 streams, an IMU initialization of 100 samples (the 3rd scan)."""

import json
import os
import subprocess
import sys
import types

import pytest

from odom_bench import harness, lio_faults
from odom_bench.common import manifest, spans, trace
from odom_bench.tests import cells

STEPS = 10
WARMUP = 4  # cells._write's
READERS = ("ekf_device_ms", "imu_deskew_device_ms")
SMALL = {**cells.SMALL_MC, "icp": {**cells.SMALL_MC["icp"], "deskew": True},
         "imu": {"max_init_count": 100}}
LIMITS = {"pose_gap_m": 0.01, "pose_gap_rad": 0.001, "sigma_gap_rel": 1e-9,
          "map_off_share": 0.01, "ref_out_of_box": 0, "scans_compared": 5, "scan_gap": 0,
          "imu_gap": 0, "deskew_gap_m": 1e-4, "filter_mean_gap": 1e-9,
          "filter_cov_gap_rel": 1e-12}


def build(tmp: str, streams: int = 4, ensembles: int = 2, compare: int = 2) -> str:
    """configs/vlp16_lio_mc.json at a 4096-point buffer in a 40,000-point
    world, as the cell `small.s<streams>`."""
    with open(os.path.join(manifest.BENCH_DIR, "configs", "vlp16_lio_mc.json")) as f:
        config = json.load(f)
    config.update(name="small", overrides=SMALL, pipeline=cells.pipeline("default", SMALL),
                  limits=dict(LIMITS))
    config["world"] = dict(config["world"], n_points=40000)
    config["drive"] = dict(config["drive"], points=4096)
    with open(os.path.join(manifest.BENCH_DIR, "mixes", "imu_ensembles16x256.json")) as f:
        mix = json.load(f)
    mix = {k: mix[k] for k in ("noise_sigma", "gyro_sigma", "acc_sigma", "imu_rate")}
    mix.update(ensembles=ensembles, members=streams // ensembles)
    return cells._write(tmp, config, mix, streams, compare)


def _run(tmp_path, seed, wrap=None, compare=2, trace_=False):
    name = build(str(tmp_path), compare=compare)
    return harness.run_cell(str(tmp_path), name, seed, 0.0, trace_, device="cpu",
                            bench_dir=str(tmp_path), steps=None if trace_ else STEPS,
                            wrap_step=wrap, log=lambda *a, **k: None)


@pytest.mark.parametrize("seed", [5, 2**31 + 29, 7373737373])
def test_lio_ensemble_follows_reference(tmp_path, seed):
    res = _run(tmp_path, seed)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] == (STEPS + WARMUP) * 4
    assert checks["scan_gap"] == 0.0 and checks["imu_gap"] == 0.0
    assert checks["scans_compared"] == 2 * (STEPS + WARMUP)
    assert checks["filter_mean_gap"] < 1e-11 and checks["filter_cov_gap_rel"] < 1e-13


@pytest.mark.parametrize("kind", ["control_f32", "imu_sample_dropped", "cv_deskew",
                                  "filter_moved", "half_batch"])
def test_lio_control_and_faults_are_not_correct(tmp_path, kind):
    mid = WARMUP + STEPS // 2
    wrap = {"control_f32": lio_faults.control(),
            "imu_sample_dropped": lio_faults.imu_sample_dropped(mid),
            "cv_deskew": lio_faults.cv_deskew, "filter_moved": lio_faults.filter_moved(mid),
            "half_batch": lio_faults.half_batch}[kind]
    res = _run(tmp_path, 81, wrap=wrap, compare=4)
    assert not res["correct"], res["checks"]
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    assert numbers["scan_gap"] == 0.0 and numbers["imu_gap"] == 0.0
    if kind in ("control_f32", "imu_sample_dropped", "filter_moved"):
        assert numbers["filter_mean_gap"] > 1e-7
    if kind == "control_f32":  # the poses and maps alike; the filter apart
        assert numbers["pose_gap_m"] < LIMITS["pose_gap_m"]
    if kind == "cv_deskew":
        assert numbers["deskew_gap_m"] > 0.01


RANGES = [("odom_bench.register", 0, 900), ("lio.step", 5, 890), ("imu.init", 10, 40),
          ("ekf.predict", 40, 100), ("ekf.deskew", 100, 200), ("voxel_map.downsample", 200, 300),
          ("icp.register", 300, 600), ("icp.gn", 310, 400), ("ekf.update", 700, 800)]
OPS = [(20, 3), (50, 7), (60, 4), (150, 11), (250, 13), (350, 17), (500, 19), (750, 23),
       (850, 29)]  # (launch µs, device µs)


def _ctx(with_device=True, names=None):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "pid": 1,
           "tid": 1, "ts": 0.0, "dur": 1000.0}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": 1,
            "ts": float(s), "dur": float(e - s)} for n, s, e in RANGES
           if names is None or n in names]
    for corr, (t, dur) in enumerate(OPS, start=10):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                   "tid": 1, "ts": float(t), "dur": 1.0, "args": {"correlation": corr}})
        if with_device:
            ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": 7,
                       "ts": t + 2.0, "dur": float(dur), "args": {"correlation": corr}})
    return types.SimpleNamespace(trace=object(), profiled_steps=2, spans=spans.attribute(ev))


def _read(name, ctx):
    return harness._load_metric(name, manifest.BENCH_DIR).read(ctx)


def test_readers_on_a_hand_made_trace():
    got = {name: _read(name, _ctx()) for name in READERS}
    # imu.init 3 + ekf.predict 7 + 4 + ekf.update 23; ekf.deskew 11
    assert got == {"ekf_device_ms": pytest.approx(37e-3 / 2),
                   "imu_deskew_device_ms": pytest.approx(11e-3 / 2)}


@pytest.mark.parametrize("case", ["no_device_time", "no_filter_spans"])
def test_readers_return_none(case):
    ctx = (_ctx(with_device=False) if case == "no_device_time"
           else _ctx(names={"odom_bench.register", "voxel_map.downsample", "icp.register",
                            "icp.gn"}))  # a program without the filter's spans
    assert {name: _read(name, ctx) for name in READERS} == dict.fromkeys(READERS)


def test_traced_small_cell_opens_the_filter_spans(tmp_path, monkeypatch):
    kept = []
    of = spans.of

    def keep(ctx):
        kept.append(of(ctx))
        return kept[-1]

    monkeypatch.setattr(spans, "of", keep)
    res = _run(tmp_path, 2**31 + 77, trace_=True)
    assert res["correct"], res["checks"]
    sp = kept[0]
    steps = 3  # cells._write's profile_steps
    for name in ("lio.step", "ekf.predict", "ekf.deskew", "ekf.update", "icp.register"):
        assert sp.opened[name] == steps, (name, sp.opened)
    assert sp.parents["ekf.deskew"] == {"lio.step"}
    assert sp.parents["lio.step"] == {"odom_bench.register"}
    assert "imu.init" not in sp.opened  # every stream initialized before the window
    assert sp.device_s == 0.0
    assert not set(READERS) & set(res["metrics"])  # no device time on the CPU


def test_reference_loads_nothing_of_the_port():
    root = os.path.dirname(manifest.BENCH_DIR)
    code = (f"import sys; sys.path.insert(0, {root!r}); import odom_bench.reference.lio; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert not loaded & {"jax", "jaxlib", "lidar_imu_slam_tpu", "lidar_imu_slam_tpu_torch"}


@pytest.mark.cuda
def test_small_lio_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no interpret mode")
    name = build(str(tmp_path), compare=4)
    res = harness.run_cell(str(tmp_path), name, 31337, 0.0, False, device="cuda:0",
                           bench_dir=str(tmp_path), steps=16, log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["device"]["platform"] == "gpu"

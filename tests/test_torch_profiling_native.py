"""The port's profiling helpers (`lidar_imu_slam_tpu_torch/utils/
profiling.py`) and native scan packer (`host/native.py`), on the CPU:

* `device_trace` writes a Chrome trace that names an `annotate` range
  (tests/test_torch_spans.py holds the spans on the step's path);
* the native packer, built into the port's build directory, is bit-equal
  to the JAX package's `host/native` on tests/test_native.py's cases and
  matches the port's `preprocess_scan` there (masks equal, xyz 1e-6,
  `rel_t` 1e-9 + 1e-7 relative, `assert_allclose`'s default rtol, as
  tests/test_native.py: the sorted path keeps the time in f32);
  `voxel_downsample_native` keeps the first point of a
  voxel. These skip, as JAX's do, when there is no g++.
"""

import json
import os

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.config import LidarConfig as JLidarConfig
from lidar_imu_slam_tpu.host import native as jnative
from lidar_imu_slam_tpu_torch.config import LidarConfig
from lidar_imu_slam_tpu_torch.host import native
from lidar_imu_slam_tpu_torch.ops import preprocess
from lidar_imu_slam_tpu_torch.utils import profiling

torch.set_num_threads(1)

KW = dict(max_range=50.0, min_range=1.0, max_points=256, frame_rate=10.0)
CFG = LidarConfig(**KW)


def test_device_trace_names_annotated_ranges(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("backend.optimize"):
            (x @ x).sum()
        with profiling.annotate("runner.step"):
            torch.relu(x)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"backend.optimize", "runner.step"} <= names
    assert "backend.optimize" in {e.key for e in prof.key_averages()}


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("native toolchain unavailable (no g++)")
    return native.get_lib()


def test_builds_into_the_ports_build_dir(lib):
    built = os.path.abspath(native._LIB_PATH)
    assert built.startswith(os.path.abspath(os.path.join(os.path.dirname(native.__file__),
                                                         "..", "build")))
    with open(built + ".srchash") as f:
        assert f.read().strip() == native._src_hash()
    assert os.path.abspath(native._SRC) == os.path.abspath(jnative._SRC)


def _cases():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-40, 40, (200, 3)).astype(np.float32)
    gate = np.array([[0.5, 0, 0], [10, 0, 0], [60, 0, 0], [np.nan, 0, 0], [3, 4, 0]],
                    np.float32)
    n = 64
    az = np.linspace(0, -2 * np.pi * 0.9, n)
    ring = np.stack([10 * np.cos(az), 10 * np.sin(az), np.zeros(n)], 1).astype(np.float32)
    return {  # tests/test_native.py's cases: (xyz, time, ring, stamp)
        "with_times": (xyz, 100.0 + rng.uniform(0, 0.1, 200), None, 100.0),
        "range_gate_and_nan": (gate, None, None, 0.0),
        "rotation_fallback": (ring, None, np.zeros(n, np.int32), 0.0),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_pack_bit_equal_to_jax_native(lib, case):
    xyz, t, ring, stamp = _cases()[case]
    got = native.pack_scan_native(xyz, t, ring, stamp, CFG)
    want = jnative.pack_scan_native(xyz, t, ring, stamp, JLidarConfig(**KW))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(_cases()))
def test_pack_matches_preprocess_scan(lib, case):
    xyz, t, ring, stamp = _cases()[case]
    n_xyz, n_tau, n_rel, n_mask, tb, te = native.pack_scan_native(xyz, t, ring, stamp, CFG)
    scan = preprocess.preprocess_scan(preprocess.pack_raw_scan(
        xyz, time=t, ring=ring, stamp=stamp, max_points=256, device="cpu"), CFG)
    mask = scan.mask.numpy()
    np.testing.assert_array_equal(n_mask, mask)
    np.testing.assert_allclose(n_xyz[n_mask], scan.xyz.numpy()[mask], atol=1e-6)
    atol_t = 1e-6 if case == "rotation_fallback" else 1e-9  # test_native.py's bars
    np.testing.assert_allclose(n_rel[n_mask], scan.rel_t.numpy()[mask], atol=atol_t)
    if case == "with_times":
        np.testing.assert_allclose(n_tau[n_mask], scan.tau.numpy()[mask], atol=1e-6)
        np.testing.assert_allclose(tb, float(scan.t_begin), atol=1e-9)
        np.testing.assert_allclose(te, float(scan.t_end), atol=1e-9)
    if case == "range_gate_and_nan":
        assert n_mask.sum() == 2


def test_voxel_downsample_first_wins(lib):
    xyz = np.array([[0.7, 0.7, 0.7], [0.1, 0.1, 0.1], [1.5, 0.1, 0.1]], np.float32)
    out = native.voxel_downsample_native(xyz, 1.0, 8)
    assert len(out) == 2
    np.testing.assert_array_equal(out[0], xyz[0])
    np.testing.assert_array_equal(out, jnative.voxel_downsample_native(xyz, 1.0, 8))

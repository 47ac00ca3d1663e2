"""Guards for the port's no-fallback rule: without a card `chip_smoke.py`
fails and prints no result; a kernel wrapper given non-CPU tensors builds /
loads its kernel or raises — it never runs the plain version; the lean
wrappers (the gathers, K2 / K3) check dtype, shape, contiguity and devices
before they load the library and launch only on one CUDA device; the
build raises with nvcc's stderr. A whole batched step on non-CPU tensors
runs up to its first kernel, the ICP candidate fetch, and raises there
(and, on `meta` tensors, shows that nothing before it reads the device
from the host)."""

import ctypes
import os
import shutil
import stat
import subprocess
import sys

import pytest
import torch

from lidar_imu_slam_tpu_torch import config as cfgmod
from lidar_imu_slam_tpu_torch.models import ekf
from lidar_imu_slam_tpu_torch.ops import voxel_map
from lidar_imu_slam_tpu_torch.ops.kernels import (_build, _common, candidate_fetch, icp_gn,
                                                  imu_deskew, nn_bruteforce, pose_chain, probes)
from lidar_imu_slam_tpu_torch.ops.preprocess import Scan
from lidar_imu_slam_tpu_torch.parallel import streams

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _fail_load():
    raise _build.KernelBuildError("no kernel library (test)")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def no_library(monkeypatch):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(pose_chain, "_fns", {})
    monkeypatch.setattr(icp_gn, "_fn", None)
    monkeypatch.setattr(nn_bruteforce, "_fns", {})
    monkeypatch.setattr(probes, "_fns", {})
    monkeypatch.setattr(candidate_fetch, "_fns", {})
    monkeypatch.setattr(imu_deskew, "_fns", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(voxel_map, "gather_candidate_planes_packed_plain", forbidden)
    monkeypatch.setattr(ekf, "deskew_points_plain", forbidden)
    monkeypatch.setattr(pose_chain, "pose_pre_ref", forbidden)
    monkeypatch.setattr(pose_chain, "pose_post_ref", forbidden)
    monkeypatch.setattr(icp_gn, "fused_gn_carry_ref", forbidden)
    monkeypatch.setattr(icp_gn, "fused_gn_batched_ref", forbidden)
    monkeypatch.setattr(nn_bruteforce, "nn_bruteforce_plain", forbidden)
    for name in ("take_rows_plain", "take_lanes_plain", "gn_proto_plain"):
        monkeypatch.setattr(probes, name, forbidden)


@pytest.mark.parametrize("kernel", ["pose_pre", "pose_post", "fused_gn_carry", "fused_gn",
                                    "fused_gn_batched", "nn_bruteforce", "take_rows",
                                    "take_lanes", "gn_proto", "imu_deskew"])
def test_wrapper_raises_instead_of_falling_back(no_library, kernel):
    f64, f32, i32 = torch.float64, torch.float32, torch.int32
    before = dict(_common.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        if kernel == "pose_pre":
            pose_chain.pose_pre(
                _meta((4, 4), f64), _meta((4, 4), f64), _meta((4, 4), f64), _meta((), f64),
                _meta((4, 4), f64), _meta((), i32), _meta((), i32), min_motion_th=0.1,
                initial_threshold=2.0, max_range=30.0, deskew_on=True)
        elif kernel == "pose_post":
            pose_chain.pose_post(_meta((15,), f64), _meta((32,), f64), _meta((4, 4), f64),
                                 _meta((4, 4), f64), _meta((), i32), max_model_deviation=1.0)
        elif kernel == "fused_gn_carry":
            icp_gn.fused_gn_carry(_meta((3, 256), f32), _meta((256,), f32),
                                  _meta((3, 80, 256), f32), _meta((8,), f64),
                                  _meta((15,), f64), 6)
        elif kernel == "fused_gn":
            icp_gn.fused_gn(_meta((3, 256), f32), _meta((256,), f32),
                            _meta((3, 80, 256), f32), _meta((8,), f64), 4)
        elif kernel == "fused_gn_batched":
            icp_gn.fused_gn_batched(_meta((8, 3, 256), f32), _meta((8, 256), f32),
                                    _meta((8, 3, 80, 256), f32), _meta((8, 8), f64), 4)
        elif kernel == "nn_bruteforce":
            nn_bruteforce.nn_bruteforce(_meta((4096, 3), f32), _meta((3, 8192), f32))
        elif kernel == "take_rows":
            probes.take_rows(_meta((8192, 128), f32), _meta((2048, 1), i32))
        elif kernel == "take_lanes":
            probes.take_lanes(_meta((8, 8192), f32), _meta((8, 2048), i32))
        elif kernel == "imu_deskew":  # through the dispatch, as the LIO step calls it
            ekf.deskew_points(_meta((8, 1024, 3), f32), _meta((8, 1024), f64),
                              _meta((8, 1024), torch.bool), _meta((8, 65), f32),
                              _meta((8, 65, 21), f32), _meta((8, 3), f32), _meta((8, 3), f32),
                              _meta((8, 3, 3), f32))
        else:
            probes.gn_proto(_meta((3, 256), f32), _meta((256,), torch.bool),
                            _meta((3, 16, 256), f32), _meta((2,), f32), 8)
    assert _common.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["take_rows", "take_lanes", "gn_proto"])
def test_probe_wrappers_take_the_plain_version_on_cpu(monkeypatch, kernel):
    # the library is never loaded for CPU tensors, and nothing is counted
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(probes, "_fns", {})
    before = dict(_common.LAUNCHES)
    if kernel == "take_rows":
        table = torch.arange(32, dtype=torch.int32).reshape(8, 4)
        out = probes.take_rows(table, torch.tensor([[3], [0], [7]], dtype=torch.int32))
        assert out.tolist() == [table[3].tolist(), table[0].tolist(), table[7].tolist()]
    elif kernel == "take_lanes":
        table = torch.arange(16, dtype=torch.float32).reshape(2, 8)
        out = probes.take_lanes(table, torch.tensor([[7, 1], [0, 5]], dtype=torch.int32))
        assert out.tolist() == [[7.0, 1.0], [8.0, 13.0]]
    else:
        q = torch.zeros(3, 32)
        cand = torch.zeros(3, 4, 32)
        out = probes.gn_proto(q, torch.ones(32, dtype=torch.bool), cand,
                              torch.tensor([0.5, 4.0]), 2)
        assert out.shape == (13,) and bool(torch.isfinite(out).all())
    assert _common.LAUNCHES == before


def _gather_args(kernel, fault):
    """Meta arguments of a gather wrapper with one fault (or none)."""
    f32, i32 = torch.float32, torch.int32
    rows = kernel == "take_rows"
    table = _meta((64, 8) if rows else (4, 64), f32)
    idx = _meta((16, 1) if rows else (4, 16), i32)
    if fault == "table_dtype":
        table = _meta(table.shape, torch.float64)
    elif fault == "idx_dtype":
        idx = _meta(idx.shape, torch.int64)
    elif fault == "shape":
        idx = _meta((16, 3) if rows else (5, 16), i32)
    elif fault == "non_contiguous":
        table = _meta(tuple(reversed(table.shape)), f32).t()
    elif fault == "mixed_devices":
        table = torch.zeros(table.shape, dtype=f32)
    return table, idx


@pytest.mark.parametrize("kernel", ["take_rows", "take_lanes"])
@pytest.mark.parametrize("fault,error", [("table_dtype", TypeError), ("idx_dtype", TypeError),
                                         ("shape", ValueError), ("non_contiguous", ValueError),
                                         ("mixed_devices", ValueError)])
def test_lean_gather_wrappers_check_before_loading(no_library, kernel, fault, error):
    # the lean wrappers' direct checks run before the library is loaded:
    # each fault raises its own error, not the (patched) build failure
    before = dict(_common.LAUNCHES)
    with pytest.raises(error, match="mixed" if fault == "mixed_devices" else None):
        getattr(probes, kernel)(*_gather_args(kernel, fault))
    assert _common.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["take_rows", "take_lanes"])
def test_lean_gather_wrappers_launch_only_on_cuda(monkeypatch, kernel):
    # with a library that loads, non-CPU tensors off the card (meta) stop at
    # the device check: no launch, no stream read, no plain version
    entered = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                entered.append(name)
                return 0
            return entry

    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(probes, "_fns", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(probes, f"{kernel}_plain", forbidden)
    before = dict(_common.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(probes, kernel)(*_gather_args(kernel, None))
    assert entered == [] and _common.LAUNCHES == before
    assert set(probes._fns) == {f"lis_{kernel}"}  # bound once, with its argtypes
    assert probes._fns[f"lis_{kernel}"].restype is ctypes.c_int


@pytest.mark.parametrize("kernel", ["nn_bruteforce", "gn_proto"])
def test_lean_k6_and_gn_proto_launch_only_on_cuda(monkeypatch, kernel):
    # K6 and gn_proto take the lean path too: with a library that loads,
    # non-CPU tensors off the card (meta) stop at the device check, with no
    # launch, no cluster check and no plain version
    entered = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                entered.append(name)
                return 0
            return entry

    monkeypatch.setattr(_build, "load", Library)
    mod = nn_bruteforce if kernel == "nn_bruteforce" else probes
    monkeypatch.setattr(mod, "_fns", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(mod, f"{kernel}_plain", forbidden)
    f32 = torch.float32
    before = dict(_common.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        if kernel == "nn_bruteforce":
            nn_bruteforce.nn_bruteforce(_meta((4096, 3), f32), _meta((3, 8192), f32))
        else:
            probes.gn_proto(_meta((3, 256), f32), _meta((256,), torch.bool),
                            _meta((3, 16, 256), f32), _meta((2,), f32), 8)
    assert entered == [] and _common.LAUNCHES == before
    assert set(mod._fns) == {f"lis_{kernel}"}  # bound once, with its argtypes
    assert mod._fns[f"lis_{kernel}"].restype is ctypes.c_int


def _pose_args(kernel, fault):
    """Meta arguments of K2 (`pose_pre`) or K3 (`pose_post`) with one fault
    (or none), and the keyword options."""
    f64, i32 = torch.float64, torch.int32
    if kernel == "pose_pre":
        args = [_meta((4, 4), f64), _meta((4, 4), f64), _meta((4, 4), f64), _meta((), f64),
                _meta((4, 4), f64), _meta((), i32), _meta((), i32)]
        kw = dict(min_motion_th=0.1, initial_threshold=2.0, max_range=30.0, deskew_on=True)
        pose, count = 0, 5
    else:
        args = [_meta((48,), f64), _meta((32,), f64), _meta((4, 4), f64), _meta((4, 4), f64),
                _meta((), i32)]
        kw = dict(max_model_deviation=1.0)
        pose, count = 2, 4
    if fault == "pose_dtype":
        args[pose] = _meta((4, 4), torch.float32)
    elif fault == "count_dtype":
        args[count] = _meta((), torch.int64)
    elif fault == "shape":
        args[pose] = _meta((3, 4), f64)
    elif fault == "short_row":
        args[0] = _meta((11,), f64) if kernel == "pose_post" else _meta((16,), f64)
    elif fault == "non_contiguous":
        args[pose] = _meta((4, 4), f64).t()
    elif fault == "mixed_devices":
        args[pose] = torch.zeros((4, 4), dtype=f64)
    return args, kw


@pytest.mark.parametrize("kernel", ["pose_pre", "pose_post"])
@pytest.mark.parametrize("fault,error", [("pose_dtype", TypeError), ("count_dtype", TypeError),
                                         ("shape", ValueError), ("short_row", ValueError),
                                         ("non_contiguous", ValueError),
                                         ("mixed_devices", ValueError)])
def test_lean_pose_wrappers_check_before_loading(no_library, kernel, fault, error):
    # K2's and K3's direct checks run before the library is loaded: each
    # fault raises its own error, not the (patched) build failure
    args, kw = _pose_args(kernel, fault)
    before = dict(_common.LAUNCHES)
    with pytest.raises(error, match="mixed" if fault == "mixed_devices" else None):
        getattr(pose_chain, kernel)(*args, **kw)
    assert _common.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["pose_pre", "pose_post"])
def test_lean_pose_wrappers_launch_only_on_cuda(monkeypatch, kernel):
    # with a library that loads, non-CPU tensors off the card (meta) stop at
    # the device check: no launch, no stream read, no plain version
    entered = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                entered.append(name)
                return 0
            return entry

    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(pose_chain, "_fns", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(pose_chain, f"{kernel}_ref", forbidden)
    args, kw = _pose_args(kernel, None)
    before = dict(_common.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(pose_chain, kernel)(*args, **kw)
    assert entered == [] and _common.LAUNCHES == before
    assert set(pose_chain._fns) == {f"lis_{kernel}"}  # bound once, with its argtypes
    assert pose_chain._fns[f"lis_{kernel}"].restype is ctypes.c_int


def test_batched_step_raises_at_the_kernel(no_library):
    cfg = streams.batch_config(cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=False, max_insert_voxels=700),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             gn_backend="pallas", deskew=True),
    ))
    states = streams.init_batched_state(cfg, 3, "meta")
    f32, f64 = torch.float32, torch.float64
    scans = Scan(_meta((3, 2048, 3), f32), _meta((3, 2048), f32), _meta((3, 2048), f64),
                 _meta((3, 2048), torch.bool), _meta((3,), f64), _meta((3,), f64))
    before = dict(_common.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        streams.batched_register_frame_step(states, scans, cfg)
    assert _common.LAUNCHES == before


def test_mixed_devices_rejected():
    with pytest.raises(ValueError, match="mixed"):
        _common.on_cpu(torch.zeros(1), _meta((1,), torch.float32))


def test_build_raises_when_nvcc_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


def test_build_raises_with_compiler_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'csrc/icp_gn.cu(1): error: fake failure' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError, match="fake failure") as exc:
        _build.build()
    assert "exit 2" in str(exc.value)
    assert not any(p.endswith(".so") for p in os.listdir(tmp_path / "build"))


def test_build_is_keyed_on_the_sources(monkeypatch, tmp_path):
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.sources():
        shutil.copy(p, src)
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    assert _build.source_hash() == h
    with open(src / "icp_gn.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.source_hash() != h

"""The ICP candidate fetch's dispatch on the CPU
(`voxel_map.gather_candidate_planes_packed`): CPU tensors take the plain
version and never load the kernel library; a mix of devices raises; on
non-CPU tensors the wrapper checks dtypes, shapes and contiguity before it
loads the library, and launches only on one CUDA device (here `meta`
tensors stop at that check). The kernel itself is held bit-equal to the
plain version on the card (tests/test_torch_cuda_kernels.py), on the
cases of tools/fetch_cases.py, which are checked here for what they
cover."""

import ctypes

import pytest
import torch

from lidar_imu_slam_tpu_torch import config as cfgmod
from lidar_imu_slam_tpu_torch.ops import voxel_map
from lidar_imu_slam_tpu_torch.ops.kernels import _build, _common, candidate_fetch
from lidar_imu_slam_tpu_torch.tools import fetch_cases

torch.set_num_threads(1)


def _fail_load():
    raise _build.KernelBuildError("no kernel library (test)")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", fetch_cases.CASES)
def test_cpu_tensors_take_the_plain_version(monkeypatch, case):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(candidate_fetch, "_fns", {})
    m, q, qm, cfg, anchor = fetch_cases.case(case, "cpu", small=True)
    before = dict(_common.LAUNCHES)
    out = voxel_map.gather_candidate_planes_packed(m, q, qm, cfg, anchor)
    ref = voxel_map.gather_candidate_planes_packed_plain(m, q, qm, cfg, anchor)
    assert _common.LAUNCHES == before and candidate_fetch._fns == {}
    assert torch.equal(_bits(out), _bits(ref))
    nb, kp = cfg.neighborhood, cfg.packed_width
    assert out.shape == q.shape[:-2] + (3, kp * nb, q.shape[-2])
    # what the case covers: found and absent candidates (none in an empty
    # map), masked queries with none, the anchor's dtype, wrapped keys
    found = torch.isfinite(out).all(dim=-3)
    assert bool(torch.isinf(out).any())
    assert bool(found.any()) == (case != "empty_map")
    assert not bool(found.transpose(-1, -2)[~qm].any())
    assert (case == "third_masked") == (not bool(qm.all()))
    assert anchor.dtype == (torch.float32 if case == "anchor_f32" else torch.float64)
    if case == "far_negative":
        vox = voxel_map.voxel_of(q, cfg.voxel_size)
        assert bool((vox[..., 0] > 1023).all()) and bool((vox[..., 1] < -1023).all())


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_args(fault=None):
    """A two-stream map and queries on `meta` with one fault (or none)."""
    cfg = cfgmod.MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 12, neighborhood=8)
    m = voxel_map.create(cfg, "meta", streams=2)
    q, qm, anchor = _meta((2, 256, 3), torch.float32), _meta((2, 256), torch.bool), _meta(
        (2, 3), torch.float64)
    if fault == "qmask_dtype":
        qm = _meta((2, 256), torch.float32)
    elif fault == "grid_dtype":
        m = m._replace(grid=_meta(m.grid.shape, torch.int64))
    elif fault == "packed_dtype":
        m = m._replace(packed=_meta(m.packed.shape, torch.int64))
    elif fault == "shape":
        m = m._replace(grid=_meta((3,) + m.grid.shape[1:], torch.int32))
    elif fault == "non_contiguous":
        m = m._replace(packed=_meta(m.packed.shape[::-1], torch.int32).transpose(0, 2))
    elif fault == "mixed_devices":
        q = torch.zeros((2, 256, 3))
    elif fault == "queries_f64":  # taken: the dispatcher casts to f32
        q = _meta((2, 256, 3), torch.float64)
    elif fault == "qmask_strided":  # taken: the dispatcher makes it contiguous
        qm = _meta((256, 2), torch.bool).t()
    return m, q, qm, cfg, anchor


@pytest.mark.parametrize("fault,error", [
    ("qmask_dtype", TypeError), ("grid_dtype", TypeError), ("packed_dtype", TypeError),
    ("shape", ValueError), ("non_contiguous", ValueError), ("mixed_devices", ValueError)])
def test_non_cpu_tensors_are_checked_before_loading(monkeypatch, fault, error):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(candidate_fetch, "_fns", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(voxel_map, "gather_candidate_planes_packed_plain", forbidden)
    before = dict(_common.LAUNCHES)
    with pytest.raises(error, match="mixed" if fault == "mixed_devices" else None):
        voxel_map.gather_candidate_planes_packed(*_meta_args(fault))
    assert _common.LAUNCHES == before


def test_non_cpu_tensors_raise_without_the_library(monkeypatch):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(candidate_fetch, "_fns", {})
    before = dict(_common.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        voxel_map.gather_candidate_planes_packed(*_meta_args())
    assert _common.LAUNCHES == before


@pytest.mark.parametrize("layout", [None, "queries_f64", "qmask_strided"])
def test_launches_only_on_one_cuda_device(monkeypatch, layout):
    # with a library that loads, non-CPU tensors off the card (meta) stop at
    # the device check: no launch, no stream read, no plain version; f64
    # queries and a strided mask, which the plain version takes, pass the
    # wrapper's checks
    entered = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                entered.append(name)
                return 0
            return entry

    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(candidate_fetch, "_fns", {})
    before = dict(_common.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        voxel_map.gather_candidate_planes_packed(*_meta_args(layout))
    assert entered == [] and _common.LAUNCHES == before
    assert set(candidate_fetch._fns) == {"lis_candidate_fetch"}  # bound once, with argtypes
    assert candidate_fetch._fns["lis_candidate_fetch"].restype is ctypes.c_int

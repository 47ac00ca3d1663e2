"""The IMU deskew's per-point dispatch on the CPU (`ekf.deskew_points`):
CPU tensors take the plain version and never load the kernel library; a
mix of devices raises; on non-CPU tensors the wrapper checks dtypes,
shapes and contiguity before it loads the library, and launches only on
one CUDA device (here `meta` tensors stop at that check). The LIO step's
`motion_compensation_with_imu` reaches the plain version through the
dispatch on the CPU. The kernel itself is held bit-equal to the plain
version on the card (tests/test_torch_cuda_kernels.py), on the cases of
tools/deskew_cases.py, which are checked here for what they cover."""

import ctypes

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu_torch.models import ekf
from lidar_imu_slam_tpu_torch.ops.kernels import _build, _common, imu_deskew
from lidar_imu_slam_tpu_torch.tools import deskew_cases

torch.set_num_threads(1)


def _fail_load():
    raise _build.KernelBuildError("no kernel library (test)")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", deskew_cases.CASES)
def test_cpu_tensors_take_the_plain_version(monkeypatch, case):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(imu_deskew, "_fns", {})
    args = deskew_cases.case(case, "cpu", small=True)
    before = dict(_common.LAUNCHES)
    out = ekf.deskew_points(*args)
    ref = ekf.deskew_points_plain(*args)
    assert _common.LAUNCHES == before and imu_deskew._fns == {}
    assert torch.equal(_bits(out), _bits(ref))
    points, _, mask = args[:3]
    assert out.shape == points.shape and out.dtype == torch.float32
    # masked points pass through bit for bit; the others are moved
    assert torch.equal(_bits(out[~mask]), _bits(points[~mask]))
    assert bool(torch.isfinite(out[mask]).all()) and not torch.equal(out[mask], points[mask])
    # what the case covers
    cov = deskew_cases.coverage(*args)
    assert cov["small"] > 0 and cov["large"] > 0 and cov["masked"] > 0
    assert (cov["ties"] > 0) == (case == "ties")
    assert (cov["past_last"] > 0) == (case in ("past_last", "few_samples"))
    assert (points.dim() == 2) == (case in ("lead_none", "lio_slice"))
    if case == "masked":
        assert bool(torch.isnan(points[~mask]).all()) and cov["masked"] > points.numel() // 12
    if case == "small_angle":
        assert cov["small"] > cov["large"] // 4
    if case == "few_samples":
        assert int(torch.isfinite(args[3]).sum(-1).max()) == 3  # the head and two pairs
    if case == "lio_slice":  # 16-sample packets at 100 Hz: the head, 10 pairs, padding
        assert args[3].shape == (17,) and int(torch.isfinite(args[3]).sum()) == 11


def test_motion_compensation_reaches_the_plain_version_on_cpu(monkeypatch):
    monkeypatch.setattr(_build, "load", _fail_load)
    calls = []
    plain = ekf.deskew_points_plain

    def counted(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(ekf, "deskew_points_plain", counted)
    points, rel, mask = deskew_cases.case("drive", "cpu", small=True)[:3]
    rng = np.random.default_rng(0)
    state, cfg = deskew_cases._state(rng, points.shape[0], 12.3)
    packet = deskew_cases._packet(rng, points.shape[0], 50, deskew_cases.RATE, 12.3)
    s = points.shape[0]
    norm = torch.full((s,), 9.83, dtype=torch.float64)
    beg = torch.full((s,), 12.3, dtype=torch.float64)
    before = dict(_common.LAUNCHES)
    _, out, _ = ekf.motion_compensation_with_imu(state, packet, points, rel, mask, norm, beg,
                                                  cfg)
    assert len(calls) == 1 and _common.LAUNCHES == before
    terms = ekf.imu_trail(state, packet, rel, mask, norm, beg, cfg)[2]
    assert torch.equal(_bits(out), _bits(plain(points, rel, mask, *terms)))


def _f64_bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)


def _ulps(new, old):
    """The largest |new - old| in ulps of old's largest magnitude."""
    big = old[torch.isfinite(old)].abs().amax()
    ulp = torch.nextafter(big, torch.tensor(float("inf"), dtype=old.dtype)) - big
    return float(((new - old)[torch.isfinite(old)].abs() / ulp).max())


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("lead", ["none", "streams"])
def test_trail_small_products_match_the_matmul_form(monkeypatch, lead, batched):
    # the trail and the scan-end extrapolation multiply their small
    # matrices as broadcast sums (`ekf._small_mm`, `_small_mv`); the same
    # trail with torch.matmul and `_mv` (the `@` form they replaced) agrees
    # within 4 f64 ulps of each array's magnitude, and its f32 terms and
    # points within 1 f32 ulp (PyTorch's CPU kernels sum both forms in the
    # same order and read 0; the bound leaves room for another order)
    import dataclasses
    import math

    s = 1 if lead == "none" else 8
    rng = np.random.default_rng(3)
    state, cfg = deskew_cases._state(rng, s, 12.3)
    cfg = dataclasses.replace(cfg, batched_deskew=batched)
    packet = deskew_cases._packet(rng, s, 50, deskew_cases.RATE, 12.3)
    points, rel, mask = deskew_cases._points(rng, s, 1000)
    norm = torch.full((s,), 9.83, dtype=torch.float64)
    beg = torch.full((s,), 12.3, dtype=torch.float64)
    args = (state, packet, points, rel, mask, norm, beg)
    if lead == "none":
        args = tuple(type(a)(*(f[0] for f in a)) if isinstance(a, tuple) else a[0]
                     for a in args)
    st_new, out_new, diag_new = ekf.motion_compensation_with_imu(*args, cfg)
    terms_new = ekf.imu_trail(*args[:2], *args[3:], cfg)[2]
    monkeypatch.setattr(ekf, "_small_mm", torch.matmul)
    monkeypatch.setattr(ekf, "_small_mv", ekf._mv)
    st_old, out_old, diag_old = ekf.motion_compensation_with_imu(*args, cfg)
    terms_old = ekf.imu_trail(*args[:2], *args[3:], cfg)[2]
    for k in ("vel_end", "pos_end", "rot_end"):
        assert _ulps(diag_new[k], diag_old[k]) <= 4, k
    for a, b in zip(terms_new, terms_old):
        assert a.dtype == torch.float32 and _ulps(a, b) <= 1
    assert torch.equal(diag_new["n_pairs"], diag_old["n_pairs"])
    assert torch.equal(st_new.last_lidar_end_time, st_old.last_lidar_end_time)
    on = args[4]
    assert torch.equal(_f64_bits(out_new[~on]), _f64_bits(out_old[~on]))
    gap = (out_new - out_old)[on].abs().amax(-1)
    ulp = torch.linalg.norm(out_old[on], dim=-1)
    ulp = torch.nextafter(ulp, torch.full_like(ulp, math.inf)) - ulp
    assert float((gap / ulp).max()) <= 1


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_args(fault=None):
    """Two streams' pass on `meta` with one fault (or none)."""
    f32, f64 = torch.float32, torch.float64
    args = dict(points=_meta((2, 256, 3), f32), rel_t=_meta((2, 256), f64),
                pts_mask=_meta((2, 256), torch.bool), offsets=_meta((2, 65), f32),
                table=_meta((2, 65, 21), f32), t_il=_meta((2, 3), f32),
                pos_lidar_end=_meta((2, 3), f32), rot_end=_meta((2, 3, 3), f32))
    if fault == "points_f64":
        args["points"] = _meta((2, 256, 3), f64)
    elif fault == "rel_t_f32":
        args["rel_t"] = _meta((2, 256), f32)
    elif fault == "mask_dtype":
        args["pts_mask"] = _meta((2, 256), torch.uint8)
    elif fault == "table_width":
        args["table"] = _meta((2, 65, 20), f32)
    elif fault == "offsets_shape":
        args["offsets"] = _meta((2, 64), f32)
    elif fault == "streams":
        args["rot_end"] = _meta((3, 3, 3), f32)
    elif fault == "mixed_devices":
        args["t_il"] = torch.zeros((2, 3))
    elif fault == "table_strided":  # taken: the dispatcher makes it contiguous
        args["table"] = _meta((2, 21, 65), f32).transpose(1, 2)
    return tuple(args.values())


@pytest.mark.parametrize("fault,error", [
    ("points_f64", TypeError), ("rel_t_f32", TypeError), ("mask_dtype", TypeError),
    ("table_width", ValueError), ("offsets_shape", ValueError), ("streams", ValueError),
    ("mixed_devices", ValueError)])
def test_non_cpu_tensors_are_checked_before_loading(monkeypatch, fault, error):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(imu_deskew, "_fns", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(ekf, "deskew_points_plain", forbidden)
    before = dict(_common.LAUNCHES)
    with pytest.raises(error, match="mixed" if fault == "mixed_devices" else None):
        ekf.deskew_points(*_meta_args(fault))
    assert _common.LAUNCHES == before


def test_unchecked_wrapper_rejects_a_strided_table(monkeypatch):
    # the wrapper itself takes contiguous tensors only; the dispatch makes
    # them so
    monkeypatch.setattr(_build, "load", _fail_load)
    with pytest.raises(ValueError, match="contiguous"):
        imu_deskew.imu_deskew(*_meta_args("table_strided"))


def test_non_cpu_tensors_raise_without_the_library(monkeypatch):
    monkeypatch.setattr(_build, "load", _fail_load)
    monkeypatch.setattr(imu_deskew, "_fns", {})
    before = dict(_common.LAUNCHES)
    with pytest.raises(_build.KernelBuildError):
        ekf.deskew_points(*_meta_args())
    assert _common.LAUNCHES == before


@pytest.mark.parametrize("layout", [None, "table_strided"])
def test_launches_only_on_one_cuda_device(monkeypatch, layout):
    # with a library that loads, non-CPU tensors off the card (meta) stop at
    # the device check: no launch, no stream read, no plain version; a
    # strided table, which the plain version takes, passes the checks
    entered = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                entered.append(name)
                return 0
            return entry

    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(imu_deskew, "_fns", {})
    before = dict(_common.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        ekf.deskew_points(*_meta_args(layout))
    assert entered == [] and _common.LAUNCHES == before
    assert set(imu_deskew._fns) == {"lis_imu_deskew"}  # bound once, with argtypes
    assert imu_deskew._fns["lis_imu_deskew"].restype is ctypes.c_int

"""The plain reference against the port at tiny shapes on the CPU (the
port's plain kernel versions), over several seeds of both presets, and
the comparison's control and faults: each must make `correct` false."""

import pytest

from odom_bench import faults, harness
from odom_bench.tests import cells

STEPS = 12


def _run(tmp_path, preset, seed, wrap=None, streams=4, compare=2, steps=STEPS):
    name = cells.build(str(tmp_path), preset, streams, compare)
    return harness.run_cell(str(tmp_path), name, seed, 0.0, False, device="cpu",
                            bench_dir=str(tmp_path), steps=steps, wrap_step=wrap,
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("preset", ["kitti_64beam", "livox_dense"])
@pytest.mark.parametrize("seed", [1, 2**31 + 11, 4242424242])
def test_port_follows_reference(tmp_path, preset, seed):
    res = _run(tmp_path, preset, seed)
    checks = res["checks"]
    assert res["correct"], checks
    assert res["failed"] == 0
    assert res["attempted"] == (STEPS + 4) * 4
    assert checks["sigma_gap_rel"]["value"] < 1e-12
    assert checks["map_off_share"]["value"] < 1e-3
    assert checks["scans_compared"]["value"] == 2 * (STEPS + 4)


@pytest.mark.parametrize("preset", ["kitti_64beam", "livox_dense"])
def test_control_is_not_correct(tmp_path, preset):
    res = _run(tmp_path, preset, 77, wrap=faults.control())
    assert not res["correct"]
    assert res["checks"]["sigma_gap_rel"]["value"] > 1e-9


def test_control_at_the_configured_precision_is_correct(tmp_path):
    import torch

    res = _run(tmp_path, "kitti_64beam", 78, wrap=faults.control(torch.float64))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_pose"])
def test_fault_is_not_correct(tmp_path, fault):
    wrap = faults.altered_pose(8) if fault == "altered_pose" else getattr(faults, fault)
    res = _run(tmp_path, "kitti_64beam", 79, wrap=wrap, compare=4)
    assert not res["correct"], res["checks"]
    assert res["checks"]["pose_gap_m"]["value"] > 0.05

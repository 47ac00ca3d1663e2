"""Drivers by name: the Monte-Carlo ensemble driver at a small shape on the
CPU (the port's plain kernel versions) against the reference, with its
control and a fault, the reference's points against the timed step's, and
a driver that only new files add."""

import json
import textwrap

import pytest
import torch

from odom_bench import faults, harness
from odom_bench.common import manifest
from odom_bench.tests import cells

STEPS = 12


def _run(tmp_path, seed, wrap=None, streams=4, compare=2, trace=False):
    name = cells.build(str(tmp_path), streams=streams, compare=compare, driver="ensemble")
    return harness.run_cell(str(tmp_path), name, seed, 0.0, trace, device="cpu",
                            bench_dir=str(tmp_path), steps=None if trace else STEPS,
                            wrap_step=wrap, log=lambda *a, **k: None)


@pytest.mark.parametrize("seed", [3, 2**31 + 19, 5151515151])
def test_ensemble_follows_reference(tmp_path, seed):
    res = _run(tmp_path, seed)
    checks = res["checks"]
    assert res["correct"], checks
    assert res["failed"] == 0
    assert res["attempted"] == (STEPS + 4) * 4
    assert checks["scan_gap"]["value"] == 0.0
    assert checks["sigma_gap_rel"]["value"] < 1e-12
    assert checks["map_off_share"]["value"] < 1e-3
    assert checks["scans_compared"]["value"] == 2 * (STEPS + 4)


def test_ensemble_traced_reports_every_metric(tmp_path):
    res = _run(tmp_path, 2**31 + 23, trace=True)
    assert res["correct"], res["checks"]
    assert "ops_per_step" in res["metrics"] and "host_enqueue_ms" in res["metrics"]


@pytest.mark.parametrize("kind", ["control_f32", "state_unchanged", "half_batch",
                                  "altered_pose"])
def test_ensemble_control_and_faults_are_not_correct(tmp_path, kind):
    wrap = {"control_f32": faults.control(), "state_unchanged": faults.state_unchanged,
            "half_batch": faults.half_batch, "altered_pose": faults.altered_pose(8)}[kind]
    res = _run(tmp_path, 81, wrap=wrap, compare=4)
    assert not res["correct"], res["checks"]
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    if kind == "control_f32":
        assert numbers["sigma_gap_rel"] > 1e-9 and "scan_gap" not in numbers
    else:
        assert numbers["pose_gap_m"] > 0.05 and numbers["scan_gap"] == 0.0


def test_reference_sees_the_timed_points(tmp_path):
    """The noise redrawn after the window from (seed, k, ensemble), added
    to the reference's own preprocess, gives the very points, times and
    mask the timed step registered, bit for bit, in every stream."""
    name = cells.build(str(tmp_path), streams=6, driver="ensemble", ensembles=2)
    cell = manifest.resolve(str(tmp_path), name, str(tmp_path))
    driver = harness.load_driver(cell.config, str(tmp_path))(cell, 2**31 + 3, "cpu")
    timed = [driver.batch(k) for k in (0, 1, 299, 300)]
    for k, scans in zip((0, 1, 299, 300), timed):
        pts, tau, mask = driver.ref_inputs(k)
        assert torch.equal(mask, scans.mask) and mask.any()
        assert torch.equal(pts, scans.xyz) and torch.equal(tau, scans.tau)
    # the same lap position twice: the same scan, other noise; other noise in
    # each stream; each ensemble from its own lap position
    assert torch.equal(timed[0].mask, timed[3].mask)
    assert not torch.equal(timed[0].xyz, timed[3].xyz)
    assert not torch.equal(timed[0].xyz[0], timed[0].xyz[1])
    assert driver.offsets[0] != driver.offsets[1]
    raw = driver.raw(0).xyz
    assert not torch.equal(raw[0], raw[1])
    # a stream's points are its own ensemble's scan plus 1 cm noise
    assert float(torch.amax(torch.abs(timed[0].xyz[4] - timed[0].xyz[3]))) < 0.2
    assert float(torch.amax(torch.abs(timed[0].xyz[3] - timed[0].xyz[2]))) > 1.0


def test_other_noise_than_the_reference_draws_is_not_correct(tmp_path, monkeypatch):
    """A program whose perturbation departs from the drawn noise (here half
    of it) fails `scan_gap`."""
    from lidar_imu_slam_tpu_torch.parallel import streams

    perturb = streams.perturb_scans
    monkeypatch.setattr(streams, "perturb_scans",
                        lambda scan, gen, s, sigma: perturb(scan, gen, s, 0.5 * sigma))
    res = _run(tmp_path, 83)
    assert not res["correct"]
    assert res["checks"]["scan_gap"]["value"] > 0.0


TOY = '''
    """A driver that exists only as a new file: the fleet's, with a number
    of its own that shows it ran."""
    import os

    from odom_bench import harness

    Fleet = harness.load_driver({}, os.path.dirname(os.path.dirname(__file__)))


    class Driver(Fleet):
        def compare(self, cols, port_map, poses, sigmas):
            numbers, detail = super().compare(cols, port_map, poses, sigmas)
            numbers["toy_steps"] = float(poses.shape[0])
            return numbers, detail
'''


def test_a_driver_added_as_a_new_file(tmp_path):
    name = cells.build(str(tmp_path), "livox_dense", streams=2, compare=1)
    (tmp_path / "drivers" / "toy.py").write_text(textwrap.dedent(TOY))
    path = tmp_path / "configs" / "small.json"
    config = json.loads(path.read_text())
    config["driver"] = "toy"
    config["limits"]["toy_steps"] = 1e9
    path.write_text(json.dumps(config))
    res = harness.run_cell(str(tmp_path), name, 4321, 0.0, False, device="cpu",
                           bench_dir=str(tmp_path), steps=4, log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["checks"]["toy_steps"]["value"] == 8.0

"""The harness on the card at a small shape: the port's kernels against
the reference (run on the card with `python -m pytest odom_bench/tests -m
cuda`)."""

import pytest
import torch

from odom_bench import harness
from odom_bench.tests import cells


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["kitti_64beam", "livox_dense"])
def test_small_cell_on_the_card(tmp_path, preset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no interpret mode")
    name = cells.build(str(tmp_path), preset, streams=4, compare=4)
    res = harness.run_cell(str(tmp_path), name, 31337, 0.0, False, device="cuda:0",
                           bench_dir=str(tmp_path), steps=16, log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["scans_per_s"]["value"] > 0

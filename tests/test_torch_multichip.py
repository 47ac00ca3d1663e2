"""The port's multi-device dry run (`parallel/dryrun.py`) against the JAX
package's `__graft_entry__.dryrun_multichip(8)` on its 8-device virtual CPU
mesh: the same three lines (N streams over N devices, an N-way sharded map,
2 streams x 4 map shards) with the same counts, recorded for JAX in
MULTICHIP_r05.json as 4080 correspondences, 927 voxels, 927 / 510 and
[927, 927]. The port's world 1 (no process group) and world 4 (gloo, CPU
ranks) give the same numbers, poses bit for bit.
"""

import re

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lidar_imu_slam_tpu_torch.parallel import dryrun

torch.set_num_threads(1)


def _metrics(line: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"'(\w+)': (?:Array\()?([-+\d.e]+)", line)}


@pytest.fixture(scope="module")
def world1():
    return dryrun.run(8, "cpu", quiet=True)


def test_dryrun_prints_jax_counts(capsys, world1):
    graft.dryrun_multichip(8)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun_")]
    dryrun.main(["8", "--device", "cpu"])
    port_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("dryrun")]
    assert len(jax_lines) == 3 and len(port_lines) == 4
    mj, mt = _metrics(jax_lines[0]), _metrics(port_lines[0])
    assert mj == mt and mt["total_correspondences"] == 4080 and mt["mean_map_voxels"] == 927
    assert port_lines[0].split(", metrics=")[0] == jax_lines[0].split(", metrics=")[0]
    assert port_lines[1:3] == jax_lines[1:3]
    assert port_lines[1].endswith("voxels=927, corr=510")
    assert port_lines[2].endswith("voxels/stream=[927, 927]")
    assert port_lines[3].startswith("dryrun: backend none, world 1, device cpu")
    assert world1["combined_voxels"] == [927, 927]


def test_dryrun_world_4_matches_world_1(world1):
    outs = dryrun.spawn(4, dryrun.run, (8, "cpu", 0, True), backend="gloo", timeout_s=240)
    for out in outs:  # every rank returns the global results
        for key in ("poses", "sharded_pose", "combined_poses"):
            np.testing.assert_array_equal(out[key], world1[key], err_msg=key)
        assert out["sharded_metrics"] == world1["sharded_metrics"]
        assert out["combined_voxels"] == world1["combined_voxels"]
        for k, v in world1["metrics"].items():
            assert out["metrics"][k] == pytest.approx(v, rel=1e-12, abs=0), k
        assert out["metrics"]["total_correspondences"] == 4080


def test_dryrun_cli_arguments():
    with pytest.raises(SystemExit):
        dryrun.main(["8", "--world", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        dryrun.main(["8", "--backend", "mpi"])

"""The stream mesh: the port's `parallel.mesh` against the JAX package's
`sharded_multistream_step` on its 8-device virtual CPU mesh (the JAX side
of tests/test_pipeline.py:129), and the port's worlds against each other.

The configuration is `__graft_entry__._tiny_cfg` with gn_backend="pallas"
under `batch_config` (kernel K5: JAX's interpret mode, the port's plain
version), 4 streams x 3 steps, stream s at step i on scan i + s. Scans are
preprocessed once by the port and fed to both packages.

Tolerances: poses at the stream tests' free-drive bar (5e-3 m,
tests/test_torch_streams.py), integer metrics equal. Over gloo, world 2 and
4 give poses bit-equal to world 1, integer metrics equal and f64 metrics
within 1e-12 relative (the sums add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.ops.preprocess import Scan as JScan
from lidar_imu_slam_tpu.parallel import mesh as jmesh
from lidar_imu_slam_tpu.parallel import streams as jstreams
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.parallel import dryrun
from lidar_imu_slam_tpu_torch.parallel import mesh as tmesh
from lidar_imu_slam_tpu_torch.parallel import streams as tstreams

torch.set_num_threads(1)

S = 4
STEPS = 3
INT_METRICS = ("total_correspondences", "max_icp_iterations", "mean_map_voxels")


def _cfg(C):
    mod = jstreams if C is jcfg else tstreams
    return mod.batch_config(C.PipelineConfig(
        lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16),
        icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend="pallas"),
        ekf=C.EkfConfig(lidar_pose_trail=4),
        imu=C.ImuConfig(max_init_count=20, max_samples_per_scan=32)))


@pytest.fixture(scope="module")
def runs():
    cj, ct = _cfg(jcfg), _cfg(tcfg)
    world = jsyn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = jsyn.make_trajectory(n_poses=S + STEPS, speed=1.2, yaw_rate=0.03, dt=0.1)
    raws = [tpre.pack_raw_scan(jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01,
                                                seed=i), stamp=i * 0.1, max_points=2048,
                               device="cpu") for i in range(S + STEPS - 1)]
    steps = [tuple(t.numpy() for t in tpre.preprocess_scan(
        tpre.stack_raw_scans(raws[i:i + S]), ct.lidar)) for i in range(STEPS)]

    mesh = jmesh.stream_mesh(jax.devices()[:S])
    states = jmesh.shard_streams(jstreams.init_batched_state(cj, S), mesh)
    step = jmesh.sharded_multistream_step(mesh, cj)
    poses_j, metrics_j = [], []
    for arrays in steps:
        states, poses, metrics = step(states, jmesh.shard_streams(
            JScan(*(jnp.asarray(a) for a in arrays)), mesh))
        poses_j.append(np.asarray(poses))
        metrics_j.append({k: np.asarray(v).item() for k, v in metrics._asdict().items()})
    return dict(ct=ct, steps=steps, poses_j=np.stack(poses_j), metrics_j=metrics_j,
                port=dryrun.drive_streams(ct, steps, "cpu"))


def test_multistream_step_matches_jax(runs):
    port = runs["port"]
    assert port["start"] == 0 and port["poses"].shape == (STEPS, S, 4, 4)
    d = np.abs(port["poses"][..., :3, 3] - runs["poses_j"][..., :3, 3]).max()
    assert d < 5e-3, d
    for mt, mj in zip(port["metrics"], runs["metrics_j"]):
        assert list(mt) == list(tmesh.GlobalMetrics._fields)
        for k in INT_METRICS:
            assert mt[k] == mj[k], k
        assert abs(mt["mean_residual_rms"] - mj["mean_residual_rms"]) < 1e-3
    assert port["metrics"][-1]["total_correspondences"] > 0
    # the streams see different scans
    assert np.abs(port["poses"][-1, 0] - port["poses"][-1, 1]).max() > 1e-3


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_worlds_match_world_1(runs, world):
    ref = runs["port"]
    outs = dryrun.spawn(world, dryrun.drive_streams, (runs["ct"], runs["steps"], "cpu"),
                        backend="gloo", timeout_s=240)
    assert [o["start"] for o in outs] == [r * S // world for r in range(world)]
    np.testing.assert_array_equal(np.concatenate([o["poses"] for o in outs], axis=1),
                                  ref["poses"])
    for out in outs:
        for mt, m1 in zip(out["metrics"], ref["metrics"]):
            for k in INT_METRICS:
                assert mt[k] == m1[k], k
            assert mt["mean_residual_rms"] == pytest.approx(m1["mean_residual_rms"], rel=1e-12)


def test_grid_mesh_rank_layout():
    outs = dryrun.spawn(4, dryrun.mesh_layout, (2, 2, "cpu"), backend="gloo", timeout_s=240)
    for r, out in enumerate(outs):
        assert tuple(out["coords"]) == (r // 2, r % 2)
        assert out["dp"] == [r % 2, r % 2 + 2]
        assert out["mp"] == [2 * (r // 2), 2 * (r // 2) + 1]
    one = dryrun.mesh_layout(1, 1, "cpu")
    assert one == dict(coords=(0, 0), dp=[0], mp=[0])
    m = tmesh.stream_mesh(device="cpu")
    assert (m.shape, m.coords, m.groups, m.device) == ((1,), (0,), (None,), torch.device("cpu"))
    assert m.block("dp", 8) == (0, 8)


def test_unsupported_backend_device_pairs_raise():
    with pytest.raises(ValueError, match="one rank per card"):
        tmesh._rank_device("cuda:0", 2, 1, "nccl")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmesh._rank_device("cpu", 2, 0, "nccl")
    with pytest.raises(ValueError, match="nccl or gloo"):
        tmesh._rank_device("cpu", 2, 0, "mpi")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tmesh._rank_device("meta", 1, 0, None)
    assert tmesh._rank_device("cpu", 4, 3, "gloo") == torch.device("cpu")
    # a CUDA mesh without a card raises; nothing moves to the CPU
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tmesh.stream_mesh()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tmesh._rank_device("cuda:0", 2, 1, "gloo")
    # a world the process group does not have
    with pytest.raises(ValueError, match="none initialized"):
        tmesh.stream_mesh(world=2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.grid_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        tmesh.Mesh(("dp",), (2,), (0,), (None,), torch.device("cpu")).block("dp", 3)


def test_spawn_reports_a_failed_rank():
    """A rank that raises fails the call with its traceback; the others are
    stopped (here: a (2, 2) grid on a world of 2)."""
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        dryrun.spawn(2, dryrun.mesh_layout, (2, 2, "cpu"), backend="gloo", timeout_s=120)

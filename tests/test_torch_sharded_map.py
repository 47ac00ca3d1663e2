"""The map-parallel path: the port's `parallel.sharded_map` against the JAX
package's on its 8-device virtual CPU mesh, at tests/test_sharded_map.py's
sizes (D = 8 shards of 2^12 slots, 4,096-point scans, the 2 x 4 unroll).

Scans are preprocessed once by the port and the same arrays fed to both
packages (JAX's `time_source="auto"` disagrees with its own rotation model
on scans without timestamps, ROADMAP queue 3).

Tolerances: `_owner` bit-equal; one step from a shared populated state:
pose 1e-6 m (the whole-step bar of tests/test_torch_classic.py; the f64
normal equations of the world-frame GN are ill-conditioned, so their sums
in another order, the port's `se3_exp` and matmul `compose` against JAX's
polynomial / while-free forms move the pose by ~1e-8 m here), the f32 point
slab within 1e-5 m and its packed mirror within one quantum on at most 8
lanes (the inserted points are moved by that correction rounded to f32),
every other map table bit-equal per shard; the 10-scan
drive 1e-6 m per pose against JAX and against the port's own single map
of 8x capacity (JAX's bar, tests/test_sharded_map.py:76); the 12-scan drive
within 0.1 m of the ground truth; the combined (2 streams x 4 shards) step
1e-6 m against JAX and 1e-9 m against the port's single-stream sharded
run. Over gloo, world 2 and 4 give poses, integer metrics and per-shard
voxel counts bit-equal to world 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.models import kiss_icp as jk
from lidar_imu_slam_tpu.ops import icp as jicp
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.ops.preprocess import Scan as JScan
from lidar_imu_slam_tpu.parallel import mesh as jmesh
from lidar_imu_slam_tpu.parallel import sharded_map as jsm
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.parallel import dryrun
from lidar_imu_slam_tpu_torch.parallel import sharded_map as tsm

torch.set_num_threads(1)

D = 8
N_SCANS = 12
N_CMP = 10  # tests/test_sharded_map.py's drive


def _cfg(C, **map_kw):
    return C.PipelineConfig(
        lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=4096),
        map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, **map_kw),
        icp=C.IcpConfig(max_map_points=4096, max_source_points=1024,
                        batch_unroll_outer=2, batch_unroll_inner=4),
    )


def _scans(ct):
    world = jsyn.make_world(seed=4, n_points=100_000, extent=(40.0, 12.0, 5.0))
    gt = jsyn.make_trajectory(n_poses=N_SCANS, speed=1.5, yaw_rate=0.02, dt=0.1)
    scans = []
    for i, pose in enumerate(gt):
        pts = jsyn.render_scan(world, pose, 3000, 0.5, 30.0, noise=0.01, seed=i)
        raw = tpre.pack_raw_scan(pts, stamp=i * 0.1, max_points=4096, device="cpu")
        scans.append(tuple(t.numpy() for t in tpre.preprocess_scan(raw, ct.lidar)))
    return scans, gt


def _jscan(arrays):
    return JScan(*(jnp.asarray(a) for a in arrays))


def _jax_state(tree):
    return jsm.ShardedKissState(jvm.VoxelMap(*tree.map), tree.pose, tree.pose_prev,
                                tree.first_pose, tree.num_poses,
                                jicp.ThresholdState(*tree.threshold))


def _ctrl_cfg(cfg):
    return cfg.replace(map=dataclasses.replace(cfg.map, capacity=cfg.map.capacity * D))


@pytest.fixture(scope="module")
def drive():
    cj, ct = _cfg(jcfg), _cfg(tcfg)
    scans, gt = _scans(ct)
    mesh = jmesh.stream_mesh(jax.devices()[:D], axis="mp")
    sj = jsm.shard_state(jsm.init_state(cj, D), mesh, axis="mp")
    poses_j, states_j = [], []
    for arrays in scans[:N_CMP]:
        sj, pj, _ = jsm.register_frame_jit(sj, _jscan(arrays), cj, D)
        poses_j.append(np.asarray(pj))
        states_j.append(jax.tree.map(np.asarray, sj))
    port = dryrun.drive_sharded(ct, scans, D, "cpu")
    ctrl_cfg = _ctrl_cfg(ct)
    ctrl = tk.init_state(ctrl_cfg, "cpu")
    ctrl_poses = []
    for arrays in scans[:N_CMP]:
        ctrl, out = tk.register_frame(ctrl, tpre.Scan(*map(torch.from_numpy, arrays)), ctrl_cfg)
        ctrl_poses.append(out.pose.numpy())
    return dict(cj=cj, ct=ct, scans=scans, gt=gt, poses_j=np.stack(poses_j), states_j=states_j,
                port=port, ctrl_poses=np.stack(ctrl_poses))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_owner_bit_equal(n_shards):
    rng = np.random.default_rng(n_shards)
    keys = np.concatenate([rng.integers(0, 1 << 30, 4096), [0, 1, (1 << 30) - 1]]).astype(np.int32)
    want = np.asarray(jsm._owner(jnp.asarray(keys), n_shards))
    got = tsm._owner(torch.from_numpy(keys), n_shards).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_one_step_from_jax_state(drive):
    """One register_frame from JAX's populated state after scan 3: every
    other per-shard table bit-equal, points within 1e-5 m (packed within a
    quantum), pose within 1e-6 m."""
    cj, ct = drive["cj"], drive["ct"]
    tree, arrays = drive["states_j"][3], drive["scans"][4]
    sj, pj, mj = jsm.register_frame_jit(_jax_state(tree), _jscan(arrays), cj, D)
    st, pt, mt = tsm.register_frame(interop.sharded_state_from_numpy(tree, "cpu"),
                                    tpre.Scan(*map(torch.from_numpy, arrays)), ct, D)
    for f in jvm.VoxelMap._fields:
        a, b = np.asarray(getattr(sj.map, f)), getattr(st.map, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype and a.shape[0] == D, f
        if f == "points":  # f32 points moved by the f64 correction (see above)
            np.testing.assert_array_equal(np.isinf(b), np.isinf(a))
            np.testing.assert_allclose(b[np.isfinite(a)], a[np.isfinite(a)], rtol=0, atol=1e-5)
        elif f == "packed":  # the points quantized: a moved point may step one quantum
            np.testing.assert_array_equal(b < 0, a < 0)
            for shift in (20, 10, 0):
                q = lambda x: (x >> shift) & 1023  # noqa: E731
                assert np.abs(q(b) - q(a)).max() <= 1
            assert np.count_nonzero(b != a) <= 8
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert np.abs(pt.numpy() - np.asarray(pj)).max() < 1e-6
    for k in ("icp_iterations", "num_correspondences", "map_voxels", "drops", "window_drops"):
        assert int(mt[k]) == int(mj[k]), k
    np.testing.assert_array_equal(st.num_poses.numpy(), np.asarray(sj.num_poses))


def test_drive_matches_jax_and_the_single_map(drive):
    port = drive["port"]
    p = port["poses"][:N_CMP]
    assert p.shape == (N_CMP, 4, 4) and np.isfinite(p).all()
    d_jax = np.linalg.norm(p[:, :3, 3] - drive["poses_j"][:, :3, 3], axis=-1)
    d_ctrl = np.linalg.norm(p[:, :3, 3] - drive["ctrl_poses"][:, :3, 3], axis=-1)
    assert d_jax.max() < 1e-6, d_jax
    assert d_ctrl.max() < 1e-6, d_ctrl
    assert all(m["drops"] == 0 and m["window_drops"] == 0 for m in port["metrics"])
    per_shard = port["shard_voxels"][N_CMP - 1]
    assert per_shard.shape == (D,) and (per_shard > 0).all()
    assert per_shard.max() < 3 * max(per_shard.min(), 1)


def test_drive_tracks_ground_truth(drive):
    gt = drive["gt"]
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    err = np.linalg.norm(drive["port"]["poses"][-1][:3, 3] - gt_rel[-1][:3, 3])
    assert err < 0.1, err


def test_compact_insert_owner_mask():
    """With the head-compacted insert (max_insert_voxels > 0) each shard
    inserts exactly its owned groups: 4 scans bit-equal in stored points to
    the single map of 8x capacity, poses within 1e-6 m. The JAX package
    masks only the heads and attributes non-owned members to the previous
    owned head (ROADMAP queue 3); the port does not reproduce that."""
    ct = _cfg(tcfg, max_insert_voxels=3000)
    scans, _ = _scans(_cfg(tcfg))
    ctrl_cfg = _ctrl_cfg(ct)
    st, ctrl = tsm.init_state(ct, D, "cpu"), tk.init_state(ctrl_cfg, "cpu")
    for arrays in scans[:4]:
        scan = tpre.Scan(*map(torch.from_numpy, arrays))
        st, pose, m = tsm.register_frame(st, scan, ct, D)
        ctrl, out = tk.register_frame(ctrl, scan, ctrl_cfg)
        assert np.abs(pose.numpy() - out.pose.numpy())[:3, 3].max() < 1e-6
        assert int(m["drops"]) == 0 and int(ctrl.map.drops) == 0
        assert int(m["map_voxels"]) == int(tvm.num_voxels(ctrl.map))

    def stored(keys, npts):
        return sorted(zip(keys[keys >= 0].tolist(), npts[keys >= 0].tolist()))

    assert stored(st.map.keys.numpy().reshape(-1), st.map.npts.numpy().reshape(-1)) == \
        stored(ctrl.map.keys.numpy(), ctrl.map.npts.numpy())


def test_combined_step_matches_jax():
    """2 streams x 4 shards (JAX's `batched_register_frame_jit` on a (2, 4)
    mesh of the virtual devices) over 3 steps, stream s at step i on scan
    i + s."""
    cj, ct = _cfg(jcfg), _cfg(tcfg)
    scans, _ = _scans(ct)
    grid = jmesh.grid_mesh(2, 4, jax.devices()[:D])
    sj = jsm.shard_multi_state(jsm.init_multi_state(cj, 2, 4), grid)
    st = tsm.init_multi_state(ct, 2, 4, "cpu")
    for i in range(3):
        batch = [np.stack([scans[i + s][f] for s in range(2)]) for f in range(len(JScan._fields))]
        sj, pj, mj = jsm.batched_register_frame_jit(sj, _jscan(batch), cj, 4)
        st, pt, mt = tsm.batched_register_frame(st, tpre.Scan(*map(torch.from_numpy, batch)),
                                                ct, 4)
        assert pt.shape == (2, 4, 4)
        assert np.abs(pt.numpy()[:, :3, 3] - np.asarray(pj)[:, :3, 3]).max() < 1e-6
        for k in ("map_voxels", "drops", "icp_iterations", "num_correspondences"):
            np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]), err_msg=k)
    for f in ("keys", "npts", "next_slot"):
        np.testing.assert_array_equal(getattr(st.map, f).numpy(), np.asarray(getattr(sj.map, f)))
    assert not np.array_equal(pt[0].numpy(), pt[1].numpy())
    # each stream is the single-stream sharded step on its own scans
    for s in range(2):
        one = dryrun.drive_sharded(ct, scans[s:s + 3], 4, "cpu")
        assert np.abs(one["poses"][-1] - pt[s].numpy()).max() < 1e-9


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_worlds_bit_equal(drive, world):
    n = 3
    ref = drive["port"]
    outs = dryrun.spawn(world, dryrun.drive_sharded, (drive["ct"], drive["scans"][:n], D, "cpu"),
                        backend="gloo", timeout_s=240)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["poses"], ref["poses"][:n], err_msg=f"rank {r}")
        assert out["metrics"] == ref["metrics"][:n]
    # each rank holds its block of the shards
    np.testing.assert_array_equal(np.concatenate([o["shard_voxels"] for o in outs], axis=1),
                                  ref["shard_voxels"][:n])


def test_sharded_interop_round_trip(drive):
    tree = drive["states_j"][2]
    back = interop.sharded_state_to_numpy(interop.sharded_state_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    multi = jax.tree.map(np.asarray, jsm.init_multi_state(drive["cj"], 2, 3))
    back = interop.sharded_multi_state_to_numpy(
        interop.sharded_multi_state_from_numpy(multi, "cpu"))
    assert back.map.keys.shape == (2, 3, 1 << 12) and back.pose.shape == (2, 4, 4)
    with pytest.raises(ValueError, match="sharded state"):
        interop.sharded_state_from_numpy(multi, "cpu")
    with pytest.raises(ValueError, match="sharded state"):
        interop.sharded_multi_state_from_numpy(tree, "cpu")
    with pytest.raises(ValueError, match="sharded state"):
        interop.sharded_state_from_numpy(jax.tree.map(np.asarray, jk.init_state(drive["cj"])),
                                         "cpu")

"""The slice: lidar-only KISS-ICP fast path, port against the JAX package.

Three configurations at test size: `tiny` (__graft_entry__._tiny_cfg with
gn_backend="pallas": sorted scans, 27-voxel neighbourhood, f32 point slab,
no deskew), `tiny_f32_slab` (the same with packed_nn=False: the fused path
fetches its candidates from the f32 point slab, `gather_candidate_planes`)
and `bench_like` (the bench deployment's options scaled down: unsorted
scans with per-point time, 8-voxel neighbourhood, packed-only map,
head-compacted insert, CV deskew on rolling-shutter scans).

* shared state: a 3-scan JAX drive is carried across with `interop`, then
  one `register_frame` in each package from that state — poses within
  1e-3 m / 1e-3 rad;
* free drive: 8 scans in each package from fresh states — scan 0's integer
  map state bit-equal (scan 0 registers against an empty map, so its delta
  is exactly the identity), every pose within 5e-3 m, and the port's ATE
  against ground truth no worse than JAX's + 1e-3 m.
"""

import jax
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.models import kiss_icp as jk
from lidar_imu_slam_tpu.ops import icp as jicp
from lidar_imu_slam_tpu.ops import preprocess as jpre
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.utils import trajectory as jtraj
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.ops import lie as tlie
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)

N_SCANS = 8


def _cfg(C, name):
    if name.startswith("tiny"):
        return C.PipelineConfig(
            lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
            map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                            packed_nn=name != "tiny_f32_slab"),
            icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                            gn_backend="pallas"),
            ekf=C.EkfConfig(lidar_pose_trail=4),
            imu=C.ImuConfig(max_init_count=20, max_samples_per_scan=32),
        )
    return C.PipelineConfig(
        lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                            sort_by_time=False, time_source="per_point"),
        map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, neighborhood=8,
                        store_points=False, max_insert_voxels=700),
        icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend="pallas", deskew=True),
    )


def _scans(name):
    """(xyz, per-point absolute time, stamp) per scan, and ground truth."""
    world = jsyn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    if name.startswith("tiny"):
        gt = jsyn.make_trajectory(n_poses=N_SCANS, speed=1.2, yaw_rate=0.03, dt=0.1)
        out = []
        for i in range(N_SCANS):
            pts = jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i)
            out.append((pts, jsyn.azimuth_times(pts, i * 0.1), i * 0.1))
        return out, gt
    gt = jsyn.make_trajectory(n_poses=N_SCANS, speed=2.0, yaw_rate=0.03, dt=0.1)
    out = []
    for i in range(N_SCANS):
        pts, rel = jsyn.render_scan_rolling(world, gt[i], gt[min(i + 1, N_SCANS - 1)], 0.1,
                                            1500, 0.5, 30.0, noise=0.01, seed=i)
        out.append((pts, i * 0.1 + rel, i * 0.1))
    return out, gt


def _jax_scan(s, cfg):
    return jpre.preprocess_scan(jpre.pack_raw_scan(s[0], time=s[1], stamp=s[2],
                                                   max_points=cfg.lidar.max_points), cfg.lidar)


def _torch_scan(s, cfg):
    return tpre.preprocess_scan(tpre.pack_raw_scan(s[0], time=s[1], stamp=s[2],
                                                   max_points=cfg.lidar.max_points,
                                                   device="cpu"), cfg.lidar)


def _np_tree(state):
    return jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module", params=["tiny", "tiny_f32_slab", "bench_like"])
def drives(request):
    name = request.param
    cj, ct = _cfg(jcfg, name), _cfg(tcfg, name)
    scans, gt = _scans(name)
    sj, st = jk.init_state(cj), tk.init_state(ct, "cpu")
    states_j, poses_j, poses_t, maps_t = [], [], [], []
    for s in scans:
        sj, oj = jk.register_frame_jit(sj, _jax_scan(s, cj), cj)
        st, ot = tk.register_frame(st, _torch_scan(s, ct), ct)
        states_j.append(_np_tree(sj))
        poses_j.append(np.asarray(oj.pose))
        poses_t.append(ot.pose.numpy())
        maps_t.append(st.map)
    return dict(name=name, cj=cj, ct=ct, scans=scans, gt=gt, states_j=states_j,
                poses_j=np.stack(poses_j), poses_t=np.stack(poses_t), maps_t=maps_t)


def test_scan0_map_bit_equal(drives):
    mj, mt = drives["states_j"][0].map, drives["maps_t"][0]
    for f in jvm.VoxelMap._fields:
        np.testing.assert_array_equal(getattr(mt, f).numpy(), getattr(mj, f), err_msg=f)
    np.testing.assert_array_equal(drives["poses_t"][0], np.eye(4))


def test_free_drive_poses_agree(drives):
    err = np.abs(drives["poses_t"][:, :3, 3] - drives["poses_j"][:, :3, 3]).max()
    assert err < 5e-3, err
    assert np.isfinite(drives["poses_t"]).all()


def test_free_drive_ate_no_worse(drives):
    gt = drives["gt"]
    ref = np.linalg.inv(gt[0])[None] @ gt
    ate_t = ttraj.ate_rmse(drives["poses_t"], ref, align=False)
    ate_j = jtraj.ate_rmse(drives["poses_j"], ref, align=False)
    assert ate_t <= ate_j + 1e-3, (ate_t, ate_j)
    assert ate_t < 0.08


@pytest.mark.parametrize("drives", ["tiny_f32_slab"], indirect=True)
def test_f32_slab_drive_scan2_matches_jax(drives):
    """The packed_nn=False fused drive (candidates from the f32 slab):
    scan 2's translation within 1e-3 m of JAX's, [0.0431, 0.0265, -0.0086]."""
    got = drives["poses_t"][2, :3, 3]
    np.testing.assert_allclose(got, drives["poses_j"][2, :3, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, [0.0431, 0.0265, -0.0086], rtol=0, atol=1e-3)


def test_shared_state_step(drives):
    cj, ct = drives["cj"], drives["ct"]
    tree = drives["states_j"][2]
    sj = jk.KissState(jvm.VoxelMap(*tree.map), tree.pose, tree.pose_prev, tree.first_pose,
                      tree.num_poses, jicp.ThresholdState(*tree.threshold))
    st = interop.kiss_state_from_numpy(tree, "cpu")
    scan = drives["scans"][3]
    _, oj = jk.register_frame_jit(sj, _jax_scan(scan, cj), cj)
    _, ot = tk.register_frame(st, _torch_scan(scan, ct), ct)
    pj, pt = np.asarray(oj.pose), ot.pose.numpy()
    assert np.abs(pt[:3, 3] - pj[:3, 3]).max() < 1e-3
    rot = tlie.so3_log(torch.from_numpy(pj[:3, :3].T @ pt[:3, :3])).numpy()
    assert np.linalg.norm(rot) < 1e-3
    assert int(ot.map_voxels) == int(oj.map_voxels)


def test_interop_round_trip(drives):
    tree = drives["states_j"][3]
    back = interop.kiss_state_to_numpy(interop.kiss_state_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_step_in_place_matches_functional(drives):
    ct = drives["ct"]
    scans = drives["scans"]
    st = tk.init_state(ct, "cpu")
    for s in scans[:2]:
        st, _ = tk.register_frame(st, _torch_scan(s, ct), ct)
    keys_before = st.map.keys.clone()
    new_f, out_f = tk.register_frame(st, _torch_scan(scans[2], ct), ct)
    assert torch.equal(st.map.keys, keys_before)  # functional: input untouched
    new_s, out_s = tk.register_frame_step(st, _torch_scan(scans[2], ct), ct)
    assert torch.equal(out_f.pose, out_s.pose)
    for a, b in zip(new_f.map, new_s.map):
        assert torch.equal(a, b)
    assert new_s.map.keys.data_ptr() == st.map.keys.data_ptr()  # updated in place


@pytest.mark.parametrize("name", ["tiny", "bench_like"])
def test_fast_step_compaction_matches_jax(name):
    """The fast step through an in-step compaction (`auto_rebuild` firing):
    from a state whose map holds only tombstones with the cursor near the
    compaction mark, scan 0's insert passes the mark and the step compacts
    the slab. The map is bit-equal to JAX's fast step from the same state,
    functional and in place (the empty live map makes the ICP return the
    guess, so the inserted points are the same bits)."""
    cj, ct = _cfg(jcfg, name), _cfg(tcfg, name)
    cap = ct.map.capacity
    rng = np.random.default_rng(3)
    m = tvm.create(ct.map, "cpu")
    for _ in range(5):  # 660 voxels an insert (bench_like inserts at most 700)
        far = torch.from_numpy(rng.uniform(-20, 20, (660, 3)).astype(np.float32))
        far[:, 0] += 200.0
        g = tvm.fused_downsample(far, torch.ones(660, dtype=torch.bool), ct.map.voxel_size, 660)
        m = tvm.insert_grouped(m, g, ct.map)
    m = tvm.evict_far(m, torch.zeros(3, dtype=torch.float64), ct.map)
    assert int(tvm.num_voxels(m)) == 0 and 3000 < int(m.next_slot) <= cap - cap // 8
    st = tk.init_state(ct, "cpu")._replace(map=m)
    tree = interop.kiss_state_to_numpy(st)
    sj = jk.KissState(jvm.VoxelMap(**{f: getattr(tree.map, f) for f in jvm.VoxelMap._fields}),
                      tree.pose, tree.pose_prev, tree.first_pose, tree.num_poses,
                      jicp.ThresholdState(*tree.threshold))
    scan = _scans(name)[0][0]
    nj, oj = jk.register_frame_jit(sj, _jax_scan(scan, cj), cj)
    nt, ot = tk.register_frame(st, _torch_scan(scan, ct), ct)
    ns, os_ = tk.register_frame_step(st, _torch_scan(scan, ct), ct)
    assert int(nt.map.tombstones) == 0 and int(nt.map.next_slot) == int(ot.map_voxels) > 0
    for f in jvm.VoxelMap._fields:
        np.testing.assert_array_equal(getattr(nt.map, f).numpy(), np.asarray(getattr(nj.map, f)),
                                      err_msg=f)
        assert torch.equal(getattr(ns.map, f), getattr(nt.map, f)), f
    np.testing.assert_array_equal(ot.pose.numpy(), np.asarray(oj.pose))
    assert torch.equal(os_.pose, ot.pose)

"""The batched multi-stream / Monte-Carlo path: the port's
`parallel.streams` and the stream-axis voxel map, preprocess, statistics,
deskew and pose bookkeeping against the JAX package under `jax.vmap`.

Three configurations at test size, all under `batch_config` (2 x 4
fixed-unroll ICP, kernel K5 in the JAX package's interpret mode and the
port's plain version): `compact` (the 8-stream HDL-64E deployment's
options scaled down: head-compacted insert, CV deskew on rolling-shutter
scans with per-point time), `f32_slab` (`compact` with packed_nn=False:
the candidates come from the f32 point slab) and `plain` (the Monte-Carlo
VLP-16 deployment's: plain insert, 2 packed points per voxel, 32-deep
grid, no deskew, scans without timestamps). Scans are preprocessed ONCE by the port
and the same arrays fed to both packages: JAX's `time_source="auto"`
disagrees with its own rotation model on scans without timestamps
(ROADMAP queue 3), so letting each package preprocess would compare that
fault, not the batched step.

Tolerances: integer map tables bit-equal per stream; a shared-state step
1e-3 m / 1e-3 rad; a free drive 5e-3 m per pose; single-stream
`register_frame` under batch_config 1e-3 (the fast path's bars,
tests/test_torch_kiss_icp.py);
deskew 2e-5 (f32 transcendentals); orthonormalize and the threshold
functions 1e-12 (same f64 formulas, another evaluation order).
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
from lidar_imu_slam_tpu.ops import deskew as jdeskew
from lidar_imu_slam_tpu.ops import icp as jicp
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu.ops import preprocess as jpre
from lidar_imu_slam_tpu.ops import stats as jstats
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.ops.preprocess import Scan as JScan
from lidar_imu_slam_tpu.parallel import streams as jstreams
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.ops import deskew as tdeskew
from lidar_imu_slam_tpu_torch.ops import icp as ticp
from lidar_imu_slam_tpu_torch.ops import lie as tlie
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.ops import stats as tstats
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.parallel import streams as tstreams

torch.set_num_threads(1)

S = 2
N_SCANS = 5


def _cfg(C, name):
    if name in ("compact", "f32_slab"):
        slab = name == "f32_slab"
        cfg = C.PipelineConfig(
            lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                sort_by_time=False, time_source="per_point"),
            map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, neighborhood=8,
                            store_points=slab, packed_nn=not slab, max_insert_voxels=700),
            icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                            gn_backend="pallas", deskew=True),
        )
    else:
        cfg = C.PipelineConfig(
            lidar=C.LidarConfig(num_scan_lines=16, max_range=30.0, min_range=0.5,
                                max_points=2048, sort_by_time=False),
            map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, neighborhood=8,
                            nn_points=2, grid_z=32, store_points=False),
            icp=C.IcpConfig(max_map_points=1024, max_source_points=512, gn_backend="pallas"),
        )
    mod = jstreams if C is jcfg else tstreams
    return mod.batch_config(cfg)


def _raw_scans(name):
    """Raw scans as the port packs them, and the ground truth."""
    world = jsyn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = jsyn.make_trajectory(n_poses=N_SCANS + S, speed=2.0, yaw_rate=0.03, dt=0.1)
    raws = []
    for i in range(N_SCANS + S - 1):
        if name != "plain":
            pts, rel = jsyn.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5, 30.0,
                                                noise=0.01, seed=i)
            raws.append(tpre.pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                           max_points=2048, device="cpu"))
        else:
            pts = jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i)
            ring = (np.arange(len(pts)) % 16).astype(np.int32)
            raws.append(tpre.pack_raw_scan(pts, ring=ring, stamp=i * 0.1, max_points=2048,
                                           device="cpu"))
    return raws, gt


def _to_jax_scan(scan):
    return JScan(*(jnp.asarray(t.numpy()) for t in scan))


def _np_tree(state):
    return jax.tree.map(np.asarray, state)


def _jax_state(tree):
    return jk.KissState(jvm.VoxelMap(*tree.map), tree.pose, tree.pose_prev, tree.first_pose,
                        tree.num_poses, jicp.ThresholdState(*tree.threshold))


@pytest.fixture(scope="module", params=["compact", "f32_slab", "plain"])
def drive(request):
    """S = 2 streams x 5 steps; stream s at step i sees scan i + s."""
    name = request.param
    cj, ct = _cfg(jcfg, name), _cfg(tcfg, name)
    raws, gt = _raw_scans(name)
    steps = [tpre.preprocess_scan(tpre.stack_raw_scans([raws[i + s] for s in range(S)]),
                                  ct.lidar) for i in range(N_SCANS)]
    sj, st = jstreams.init_batched_state(cj, S), tstreams.init_batched_state(ct, S, "cpu")
    states_j, poses_j, poses_t, states_t = [], [], [], []
    for scan in steps:
        sj, oj = jstreams.batched_register_frame_jit(sj, _to_jax_scan(scan), cj)
        st, ot = tstreams.batched_register_frame(st, scan, ct)
        states_j.append(_np_tree(sj))
        poses_j.append(np.asarray(oj.pose))
        poses_t.append(ot.pose.numpy())
        states_t.append(st)
    return dict(name=name, cj=cj, ct=ct, raws=raws, steps=steps, gt=gt, states_j=states_j,
                states_t=states_t, poses_j=np.stack(poses_j), poses_t=np.stack(poses_t),
                last_out=ot)


def test_first_step_maps_bit_equal(drive):
    mj, mt = drive["states_j"][0].map, drive["states_t"][0].map
    for f in jvm.VoxelMap._fields:
        a, b = np.asarray(getattr(mj, f)), getattr(mt, f).numpy()
        assert a.shape == b.shape and a.shape[0] == S, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(drive["poses_t"][0], np.broadcast_to(np.eye(4), (S, 4, 4)))


def test_free_drive_poses_agree(drive):
    p_t, p_j = drive["poses_t"], drive["poses_j"]
    assert p_t.shape == (N_SCANS, S, 4, 4) and np.isfinite(p_t).all()
    assert np.abs(p_t[..., :3, 3] - p_j[..., :3, 3]).max() < 5e-3
    # the streams see different scans, so they differ from each other
    assert np.abs(p_t[-1, 0] - p_t[-1, 1]).max() > 1e-3
    out = drive["last_out"]
    assert out.icp_iterations.shape == (S,) and out.map_voxels.shape == (S,)


def test_shared_state_step(drive):
    cj, ct = drive["cj"], drive["ct"]
    tree = drive["states_j"][2]
    scan = drive["steps"][3]
    sj_next, oj = jstreams.batched_register_frame_jit(_jax_state(tree), _to_jax_scan(scan), cj)
    st_next, ot = tstreams.batched_register_frame(interop.batched_kiss_state_from_numpy(tree, "cpu"),
                                                  scan, ct)
    pj, pt = np.asarray(oj.pose), ot.pose.numpy()
    assert np.abs(pt[:, :3, 3] - pj[:, :3, 3]).max() < 1e-3
    for s in range(S):
        rot = tlie.so3_log(torch.from_numpy(pj[s, :3, :3].T @ pt[s, :3, :3])).numpy()
        assert np.linalg.norm(rot) < 1e-3
    np.testing.assert_array_equal(ot.map_voxels.numpy(), np.asarray(oj.map_voxels))
    np.testing.assert_array_equal(ot.icp_iterations.numpy(), np.asarray(oj.icp_iterations))
    np.testing.assert_array_equal(st_next.num_poses.numpy(), np.asarray(sj_next.num_poses))


def test_step_in_place_matches_functional(drive):
    ct, steps = drive["ct"], drive["steps"]
    st = interop.batched_kiss_state_from_numpy(drive["states_j"][1], "cpu")
    keys_before = st.map.keys.clone()
    new_f, out_f = tstreams.batched_register_frame(st, steps[2], ct)
    assert torch.equal(st.map.keys, keys_before)
    new_s, out_s = tstreams.batched_register_frame_step(st, steps[2], ct)
    assert torch.equal(out_f.pose, out_s.pose)
    for a, b in zip(new_f.map, new_s.map):
        assert torch.equal(a, b)
    assert new_s.map.grid.data_ptr() == st.map.grid.data_ptr()


def test_batched_interop_round_trip(drive):
    tree = drive["states_j"][3]
    back = interop.batched_kiss_state_to_numpy(interop.batched_kiss_state_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape and a.shape[0] == S
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="leading stream axis"):
        interop.batched_kiss_state_from_numpy(_np_tree(jk.init_state(drive["cj"])), "cpu")


def test_single_stream_batch_config_matches_jax():
    """register_frame with batch_config runs the classic branch at S = 1
    without a stream axis (kernel K4 in both packages)."""
    cj, ct = _cfg(jcfg, "compact"), _cfg(tcfg, "compact")
    raws, _ = _raw_scans("compact")
    sj, st = jk.init_state(cj), tk.init_state(ct, "cpu")
    for raw in raws[:N_SCANS]:
        scan = tpre.preprocess_scan(raw, ct.lidar)
        sj, oj = jk.register_frame_jit(sj, _to_jax_scan(scan), cj)
        st, ot = tk.register_frame(st, scan, ct)
        assert ot.pose.shape == (4, 4)
        assert np.abs(ot.pose.numpy() - np.asarray(oj.pose)).max() < 1e-3
        assert int(ot.icp_iterations) == int(oj.icp_iterations)
    for f in jvm.VoxelMap._fields[:3]:
        np.testing.assert_array_equal(getattr(st.map, f).numpy(), np.asarray(getattr(sj.map, f)))


def test_tiny_f32_slab_batched_matches_jax():
    """__graft_entry__._tiny_cfg with packed_nn=False under batch_config: 2
    streams x 3 steps, candidates from the f32 point slab (the fault this
    pins raised at step 0), poses held to JAX's batched path."""
    def cfg(C):
        mod = jstreams if C is jcfg else tstreams
        return mod.batch_config(C.PipelineConfig(
            lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
            map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                            packed_nn=False),
            icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                            gn_backend="pallas"),
            ekf=C.EkfConfig(lidar_pose_trail=4),
            imu=C.ImuConfig(max_init_count=20, max_samples_per_scan=32)))

    cj, ct = cfg(jcfg), cfg(tcfg)
    world = jsyn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = jsyn.make_trajectory(n_poses=4, speed=1.2, yaw_rate=0.03, dt=0.1)
    raws = []
    for i in range(4):
        pts = jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i)
        raws.append(tpre.pack_raw_scan(pts, time=jsyn.azimuth_times(pts, i * 0.1),
                                       stamp=i * 0.1, max_points=2048, device="cpu"))
    sj, st = jstreams.init_batched_state(cj, S), tstreams.init_batched_state(ct, S, "cpu")
    for i in range(3):
        scan = tpre.preprocess_scan(tpre.stack_raw_scans(raws[i:i + S]), ct.lidar)
        sj, oj = jstreams.batched_register_frame_jit(sj, _to_jax_scan(scan), cj)
        st, ot = tstreams.batched_register_frame(st, scan, ct)
        pj, pt = np.asarray(oj.pose), ot.pose.numpy()
        assert np.isfinite(pt).all()
        assert np.abs(pt[:, :3, 3] - pj[:, :3, 3]).max() < 1e-3
    assert np.abs(pt[0, :3, 3] - pt[1, :3, 3]).max() > 1e-3  # the streams differ


def test_batched_requires_batch_config():
    cfg = _cfg(tcfg, "compact")
    fast = cfg.replace(icp=dataclasses.replace(cfg.icp, batch_unroll_outer=0))
    with pytest.raises(ValueError, match="batch_config"):
        tstreams.batched_register_frame(tstreams.init_batched_state(fast, 2, "cpu"), None, fast)


def test_conditional_rebuild_per_stream():
    """With auto_rebuild on (batch_config turns it off), the classic step
    compacts exactly the streams whose cursor and tombstones call for it."""
    cfg = tcfg.PipelineConfig(map=tcfg.MapConfig(voxel_size=0.5, max_range=10.0,
                                                  capacity=1 << 10, max_insert_voxels=0))
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.uniform(-5, 5, (S, 2048, 3)).astype(np.float32))
    g = tvm.fused_downsample(pts, torch.ones(S, 2048, dtype=torch.bool), 0.5, 2048)
    m = tvm.insert_grouped(tvm.create(cfg.map, "cpu", streams=S), g, cfg.map)
    far = torch.tensor([[100.0, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    m = tvm.evict_far(m, far, cfg.map)  # stream 0 loses every voxel, stream 1 none
    assert (m.next_slot > 896).all() and m.tombstones[0] > 64 and m.tombstones[1] == 0
    out = tk._rebuild_where_needed(m, cfg)
    rebuilt = tvm.rebuild(m, cfg.map)
    for a, b, r in zip(out, m, rebuilt):
        assert torch.equal(a[0], r[0]) and torch.equal(a[1], b[1])


def test_perturb_scans():
    ct = _cfg(tcfg, "plain")
    raws, _ = _raw_scans("plain")
    scan = tpre.preprocess_scan(raws[0], ct.lidar)
    out = [tstreams.perturb_scans(scan, torch.Generator().manual_seed(5), 4, 0.01)
           for _ in range(2)]
    for a, b in zip(*out):
        assert a.shape[0] == 4
        assert torch.equal(a, b)
    xyz = out[0].xyz
    pad = ~scan.mask
    assert pad.any() and torch.equal(xyz[:, pad], scan.xyz[pad].expand(4, -1, 3))
    d = (xyz[:, scan.mask] - scan.xyz[scan.mask]).numpy()
    assert 0.008 < d.std() < 0.012 and np.abs(d).max() > 0
    assert not torch.equal(xyz[0], xyz[1])
    other = tstreams.perturb_scans(scan, torch.Generator().manual_seed(6), 4, 0.01)
    assert not torch.equal(other.xyz, xyz)


# ---------------------------------------------------------------------------
# the stream-axis ops against jax.vmap of the JAX package's
# ---------------------------------------------------------------------------


def _clouds(rng, n=2048, spread=12.0):
    pts = np.stack([rng.uniform(-spread, spread, (n, 3)) + 3.0 * s for s in range(S)])
    pts = pts.astype(np.float32)
    pts[:, :64] = np.round(pts[:, :64] * 2.0) / 2.0  # on voxel edges
    mask = rng.uniform(size=(S, n)) < 0.9
    tau = rng.uniform(size=(S, n)).astype(np.float32)
    return pts, mask, tau


def _assert_maps_equal(mj, mt, where):
    for f in jvm.VoxelMap._fields:
        a, b = np.asarray(getattr(mj, f)), getattr(mt, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{where} {f}")


@pytest.mark.parametrize("max_insert_voxels", [0, 300])
def test_batched_map_sequence_bit_equal(max_insert_voxels):
    kw = dict(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
              max_insert_voxels=max_insert_voxels, store_points=max_insert_voxels == 0)
    cj, ct = jcfg.MapConfig(**kw), tcfg.MapConfig(**kw)
    rng = np.random.default_rng(max_insert_voxels)
    mj = jax.tree.map(lambda x: jnp.stack([x] * S), jvm.create(cj))
    mt = tvm.create(ct, "cpu", streams=S)
    _assert_maps_equal(mj, mt, "create")

    def j_step(m, p, k, t, origin):
        g = jvm.fused_downsample(p, k, cj.voxel_size, 1024, tau=t)
        keys = jvm.pack_key(jvm.voxel_of(g.points, cj.voxel_size))
        m = jvm.insert_grouped(m, g, cj, keys=keys)
        return g, m, jvm.evict_far(m, origin, cj)

    j_step = jax.jit(jax.vmap(j_step))
    for it in range(4):
        pts, mask, tau = _clouds(rng)
        origin = np.stack([np.array([it * 3.0 + 6.0 * s, -3.0, 1.0]) for s in range(S)])
        gj, mj_ins, mj = j_step(mj, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(tau),
                                jnp.asarray(origin))
        gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                                  ct.voxel_size, 1024, tau=torch.from_numpy(tau))
        for f in jvm.GroupedCloud._fields:
            np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                          err_msg=f)
        keys = tvm.pack_key(tvm.voxel_of(gt.points, ct.voxel_size))
        mt = tvm.insert_grouped(mt, gt, ct, keys=keys, inplace=it % 2 == 1)
        _assert_maps_equal(mj_ins, mt, f"insert {it}")
        mt = tvm.evict_far(mt, torch.from_numpy(origin), ct, inplace=it % 2 == 0)
        _assert_maps_equal(mj, mt, f"evict {it}")
    _assert_maps_equal(jax.vmap(lambda m: jvm.rebuild(m, cj))(mj), tvm.rebuild(mt, ct),
                       "rebuild")
    np.testing.assert_array_equal(tvm.num_voxels(mt).numpy(),
                                  np.asarray(jax.vmap(jvm.num_voxels)(mj)))

    # the candidate fetch and the source downsample on the same streams
    q = np.stack([rng.uniform(-12, 12, (256, 3)) for _ in range(S)]).astype(np.float32)
    qm = rng.uniform(size=(S, 256)) < 0.9
    anchor = q.mean(1).astype(np.float32).astype(np.float64)
    cj_planes = jax.vmap(lambda m, a, b, c: jvm.gather_candidate_planes_packed(
        m, a, b, cj, c))(mj, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(anchor))
    ct_planes = tvm.gather_candidate_planes_packed(
        mt, torch.from_numpy(q), torch.from_numpy(qm), ct, torch.from_numpy(anchor))
    np.testing.assert_array_equal(ct_planes.numpy(),
                                  np.asarray(cj_planes).reshape(ct_planes.shape))
    a = jax.vmap(lambda p, k: jvm.first_point_per_voxel(p, k, 0.75, 512))(
        jnp.asarray(pts), jnp.asarray(mask))
    b = tvm.first_point_per_voxel(torch.from_numpy(pts), torch.from_numpy(mask), 0.75, 512)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("sort_by_time", [False, True])
def test_batched_preprocess_equal(sort_by_time):
    cfg_kw = dict(max_range=30.0, min_range=1.0, max_points=1024, num_scan_lines=16,
                  sort_by_time=sort_by_time, time_source="per_point")
    rng = np.random.default_rng(3)
    raws = []
    for s in range(3):
        pts = rng.uniform(-40, 40, (900, 3)).astype(np.float32)
        raws.append(tpre.pack_raw_scan(pts, time=s + rng.uniform(0, 0.1, 900), stamp=float(s),
                                       ring=rng.integers(0, 16, 900), max_points=1024,
                                       device="cpu"))
    batch = tpre.stack_raw_scans(raws)
    t = tpre.preprocess_scan(batch, tcfg.LidarConfig(**cfg_kw))
    j = jax.vmap(lambda r: jpre.preprocess_scan(r, jcfg.LidarConfig(**cfg_kw)))(
        jpre.RawScan(*(jnp.asarray(x.numpy()) for x in batch)))
    for f in JScan._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    rot = tcfg.LidarConfig(**{**cfg_kw, "time_source": "rotation_model"})
    rel_b = tpre.rotation_model_rel_time(batch.xyz, batch.ring, batch.mask, rot)
    for s in range(3):
        np.testing.assert_array_equal(
            rel_b[s].numpy(),
            tpre.rotation_model_rel_time(raws[s].xyz, raws[s].ring, raws[s].mask, rot).numpy())


def test_batched_iqr_equal():
    rng = np.random.default_rng(4)
    v = rng.exponential(10.0, (3, 500))
    mask = rng.uniform(size=(3, 500)) < np.array([[0.9], [0.5], [0.002]])
    t = tstats.iqr_inlier_mask(torch.from_numpy(v), torch.from_numpy(mask)).numpy()
    j = jax.vmap(jstats.iqr_inlier_mask)(jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_array_equal(t, np.asarray(j))


def _poses(rng, n, scale_t, scale_r):
    xi = np.concatenate([rng.normal(size=(n, 3)) * scale_t, rng.normal(size=(n, 3)) * scale_r], 1)
    return np.array(jlie.se3_exp(jnp.asarray(xi)))


def test_constant_velocity_deskew_fast_batched():
    rng = np.random.default_rng(5)
    start = _poses(rng, 3, 20.0, 0.5)
    end = start @ _poses(rng, 3, 0.5, 0.05)
    end[2] = start[2]  # a still stream: identity twist
    pts = rng.uniform(-30, 30, (3, 700, 3)).astype(np.float32)
    tau = rng.uniform(size=(3, 700)).astype(np.float32)
    j = jax.vmap(jdeskew.constant_velocity_deskew_fast)(
        jnp.asarray(pts), jnp.asarray(tau), jnp.asarray(start), jnp.asarray(end))
    t = tdeskew.constant_velocity_deskew_fast(torch.from_numpy(pts), torch.from_numpy(tau),
                                              torch.from_numpy(start), torch.from_numpy(end))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)
    np.testing.assert_allclose(t[2].numpy(), pts[2], atol=1e-6)
    one = tdeskew.constant_velocity_deskew_fast(torch.from_numpy(pts[0]),
                                                torch.from_numpy(tau[0]),
                                                torch.from_numpy(start[0]),
                                                torch.from_numpy(end[0]))
    np.testing.assert_allclose(one.numpy(), t[0].numpy(), atol=1e-6)


def test_orthonormalize_and_thresholds():
    rng = np.random.default_rng(6)
    T = _poses(rng, 4, 50.0, 1.0)
    T[:, :3, :3] += rng.normal(size=(4, 3, 3)) * 1e-9  # a composition defect
    np.testing.assert_allclose(tlie.orthonormalize(torch.from_numpy(T)).numpy(),
                               np.asarray(jlie.orthonormalize(jnp.asarray(T))), atol=1e-12)
    q = rng.normal(size=(4, 4))
    np.testing.assert_allclose(tlie.quat_to_rot(torch.from_numpy(q)).numpy(),
                               np.asarray(jlie.quat_to_rot(jnp.asarray(q))), atol=1e-12)

    dev = _poses(rng, 4, 0.05, 0.01)
    err_j = jax.vmap(lambda d: jicp.compute_model_error(d, 80.0))(jnp.asarray(dev))
    err_t = ticp.compute_model_error(torch.from_numpy(dev), 80.0)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-12, atol=1e-12)
    sums = rng.uniform(0, 2, 4)
    counts = np.array([0, 3, 5, 1], np.int32)
    moved = np.array([True, True, False, True])
    j_state, j_sigma = jax.vmap(lambda a, b, c, m: jicp.compute_threshold(
        jicp.ThresholdState(a, b, c), m, 2.0, 0.1, 80.0))(
        jnp.asarray(sums), jnp.asarray(counts), jnp.asarray(dev), jnp.asarray(moved))
    t_state, t_sigma = ticp.compute_threshold(
        ticp.ThresholdState(torch.from_numpy(sums), torch.from_numpy(counts),
                            torch.from_numpy(dev)), torch.from_numpy(moved), 2.0, 0.1, 80.0)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(j_sigma), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_state.model_error_sq.numpy(), np.asarray(j_state.model_error_sq),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(t_state.num_samples.numpy(), np.asarray(j_state.num_samples))

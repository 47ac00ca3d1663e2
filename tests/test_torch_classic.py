"""The classic f64 odometry path (gn_backend="xla", the default config):
the port against the JAX package on the CPU, and against the independent
numpy oracle.

Map and candidate state is integer or copied f32, so it is held bit-equal:
`insert`, `evict_far(exact_boundary=True)`, `update`, `export_points`,
`gather_candidates`, `nn_from_candidates(_soa)` and `nearest_neighbors`
(first-index ties included). The f64 GN math agrees to float noise:
`chol6_solve`, `align_clouds` and `_align_soa` 1e-12 (a LAPACK factor
against JAX's unrolled one, sums in another order); `icp_registration` and
its unrolled schedule: equal iteration counts, poses 1e-9. Whole steps:
shared-state `register_frame` 1e-6 m / 1e-6 rad, a free drive 5e-3 m (the
fast path's bar, tests/test_torch_kiss_icp.py), the batched xla step per
stream against `jax.vmap` likewise. Against the oracle (the port's copy,
`lidar_imu_slam_tpu_torch/validation/oracle.py`, in `match_jax` mode)
the bars of tests/test_trajectory_parity.py: first 8 scans 1e-4, median
1e-3, max 5e-2.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.host import synthetic as jsyn
from lidar_imu_slam_tpu.models import kiss_icp as jk
from lidar_imu_slam_tpu.ops import icp as jicp
from lidar_imu_slam_tpu.ops import preprocess as jpre
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.ops.preprocess import Scan as JScan
from lidar_imu_slam_tpu.parallel import streams as jstreams
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import ekf as tekf
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.models import lio as tlio
from lidar_imu_slam_tpu_torch.ops import imu as timu
from lidar_imu_slam_tpu_torch.ops import icp as ticp
from lidar_imu_slam_tpu_torch.ops import lie as tlie
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.parallel import dryrun as tdryrun
from lidar_imu_slam_tpu_torch.parallel import mesh as tmesh
from lidar_imu_slam_tpu_torch.parallel import sharded_map as tsm
from lidar_imu_slam_tpu_torch.parallel import streams as tstreams
from lidar_imu_slam_tpu_torch.validation import oracle as oracle_mod

torch.set_num_threads(1)

MAP_KW = dict(voxel_size=0.5, max_range=30.0, capacity=1 << 12)


@pytest.mark.parametrize("fn", [tk.init_state, tstreams.init_batched_state, tvm.create,
                                ticp.threshold_init, tpre.pack_raw_scan,
                                interop.kiss_state_from_numpy,
                                interop.batched_kiss_state_from_numpy,
                                tlio.init_state, tlio.pack_imu_packet, tekf.init,
                                timu.init_state, interop.lio_state_from_numpy,
                                interop.imu_packet_from_numpy,
                                interop.sharded_state_from_numpy,
                                interop.sharded_multi_state_from_numpy,
                                tsm.init_state, tsm.init_multi_state, tmesh.stream_mesh,
                                tmesh.grid_mesh, tdryrun.run, tdryrun.example_scan,
                                tdryrun.drive_sharded, tdryrun.drive_streams,
                                tdryrun.mesh_layout])
def test_entry_points_default_to_the_card(fn):
    # a caller who leaves out `device=` gets the card (ROADMAP queue 3)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# the f32-slab map API
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    kw = dict(MAP_KW, **kw)
    return jcfg.MapConfig(**kw), tcfg.MapConfig(**kw)


def _assert_maps_equal(mj, mt, where=""):
    for f in jvm.VoxelMap._fields:
        a, b = np.asarray(getattr(mj, f)), getattr(mt, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{where} {f}")


def _cloud(rng, n, shift, spread=14.0):
    """Points on a 1/16 m lattice (exact midpoints and ties), some masked,
    some duplicated."""
    pts = (np.round(rng.uniform(-spread, spread, (n, 3)) * 16.0) / 16.0 + shift)
    pts = pts.astype(np.float32)
    pts[-32:] = pts[:32]
    return pts, rng.uniform(size=n) < 0.9


def _insert_both(cj, ct, clouds):
    mj, mt = jvm.create(cj), tvm.create(ct, "cpu")
    for pts, mask in clouds:
        mj = jvm.insert(mj, jnp.asarray(pts), jnp.asarray(mask), cj)
        mt = tvm.insert(mt, torch.from_numpy(pts), torch.from_numpy(mask), ct)
    return mj, mt


@pytest.mark.parametrize("max_insert_voxels", [0, 1200])
def test_insert_and_exact_eviction_bit_equal(max_insert_voxels):
    cj, ct = _cfgs(max_insert_voxels=max_insert_voxels, max_range=12.0, grid_xy=64)
    rng = np.random.default_rng(max_insert_voxels)
    mj, mt = jvm.create(cj), tvm.create(ct, "cpu")
    for it in range(4):
        pts, mask = _cloud(rng, 1500, np.array([it * 3.0, 0.0, 0.0]))
        mj = jvm.insert(mj, jnp.asarray(pts), jnp.asarray(mask), cj)
        mt = tvm.insert(mt, torch.from_numpy(pts), torch.from_numpy(mask), ct)
        _assert_maps_equal(mj, mt, f"insert {it}")
        origin = np.array([it * 3.0 + 4.0, -2.0, 1.0])
        mj = jvm.evict_far(mj, jnp.asarray(origin), cj, exact_boundary=True)
        mt = tvm.evict_far(mt, torch.from_numpy(origin), ct, exact_boundary=True)
        _assert_maps_equal(mj, mt, f"exact evict {it}")
    assert int(mt.tombstones) > 0 and int(mt.npts.sum()) > 0  # emptied and kept voxels


def test_exact_eviction_needs_the_point_slab():
    _, ct = _cfgs(store_points=False)
    with pytest.raises(ValueError, match="store_points"):
        tvm.evict_far(tvm.create(ct, "cpu"), torch.zeros(3, dtype=torch.float64), ct,
                      exact_boundary=True)


def test_update_bit_equal():
    cj, ct = _cfgs()
    rng = np.random.default_rng(5)
    pts, mask = _cloud(rng, 1200, np.zeros(3))
    xi = np.concatenate([rng.normal(size=3) * 2.0, rng.normal(size=3) * 0.2])
    pose = tlie.se3_exp(torch.from_numpy(xi))
    mj = jvm.update(jvm.create(cj), jnp.asarray(pts), jnp.asarray(mask),
                    jnp.asarray(pose.numpy()), cj)
    mt = tvm.update(tvm.create(ct, "cpu"), torch.from_numpy(pts), torch.from_numpy(mask),
                    pose, ct)
    _assert_maps_equal(mj, mt, "update")


@pytest.mark.parametrize("store_points", [True, False])
def test_export_points_equal(store_points):
    cj, ct = _cfgs(store_points=store_points)
    rng = np.random.default_rng(6)
    mj, mt = _insert_both(cj, ct, [_cloud(rng, 1500, np.array([40.0, -30.0, 2.0]))])
    origin = np.array([38.0, -31.0, 1.5])
    pj, kj = jvm.export_points(mj, cj, origin=jnp.asarray(origin))
    pt, kt = tvm.export_points(mt, ct, origin=torch.from_numpy(origin))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    if store_points:  # the world origin is the default reference
        np.testing.assert_array_equal(tvm.export_points(mt, ct)[0].numpy(),
                                      np.asarray(jvm.export_points(mj, cj)[0]))


@pytest.mark.parametrize("neighborhood,nn_points", [(27, 0), (8, 0), (8, 4)])
def test_candidate_fetch_and_nn_bit_equal(neighborhood, nn_points):
    cj, ct = _cfgs(neighborhood=neighborhood, nn_points=nn_points)
    rng = np.random.default_rng(neighborhood + nn_points)
    clouds = [_cloud(rng, 1500, np.zeros(3)), _cloud(rng, 1500, np.array([1.0, 0.5, 0.0]))]
    mj, mt = _insert_both(cj, ct, clouds)
    _assert_maps_equal(mj, mt, "maps")
    # queries: map points, midpoints of map point pairs (exact d2 ties),
    # random points and points far from the map (no candidate)
    a, b = clouds[0][0][:300], clouds[0][0][300:600]
    q = np.concatenate([a, (a + b) / 2, rng.uniform(-16, 16, (300, 3)),
                        rng.uniform(60, 70, (100, 3))]).astype(np.float32)
    qmask = rng.uniform(size=len(q)) < 0.95
    cand_j, valid_j = jvm.gather_candidates(mj, jnp.asarray(q), jnp.asarray(qmask), cj)
    cand_t, valid_t = tvm.gather_candidates(mt, torch.from_numpy(q), torch.from_numpy(qmask), ct)
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    for got, want in zip(tvm.nearest_neighbors(mt, torch.from_numpy(q), torch.from_numpy(qmask), ct),
                         jvm.nearest_neighbors(mj, jnp.asarray(q), jnp.asarray(qmask), cj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nn_from_candidates_soa_first_index_ties():
    rng = np.random.default_rng(7)
    n, c = 400, 48
    cx, cy, cz = (rng.integers(-2, 3, (n, c)).astype(np.float32) for _ in range(3))
    valid = rng.uniform(size=(n, c)) < 0.7
    valid[:8] = False  # nothing to find
    qx, qy, qz = (rng.integers(-1, 2, n).astype(np.float32) + 0.5 for _ in range(3))
    qmask = rng.uniform(size=n) < 0.9
    got = tvm.nn_from_candidates_soa(*(torch.from_numpy(x) for x in (cx, cy, cz, valid, qx, qy,
                                                                     qz, qmask)))
    want = jvm.nn_from_candidates_soa(*(jnp.asarray(x) for x in (cx, cy, cz, valid, qx, qy, qz,
                                                                 qmask)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the f64 GN step
# ---------------------------------------------------------------------------


def _spd(rng, scale=1.0):
    m = rng.normal(size=(6, 6))
    return m @ m.T * scale + 0.5 * np.eye(6)


@pytest.mark.parametrize("positive_definite", [True, False])
def test_chol6_solve(positive_definite):
    rng = np.random.default_rng(8)
    A, b = _spd(rng), rng.normal(size=6)
    if not positive_definite:
        A[3, 3] = -1.0
    x_t = ticp.chol6_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    x_j = np.asarray(jicp.chol6_solve(jnp.asarray(A), jnp.asarray(b)))
    if positive_definite:
        np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-12)
        np.testing.assert_allclose(A @ x_t, b, atol=1e-12)
    else:  # NaN, which the GN step's isfinite guard turns into x = 0
        assert np.isnan(x_t).all() and not np.isfinite(x_j).all()
        T, x = ticp._solve_step(torch.from_numpy(A), torch.from_numpy(-b),
                                torch.ones((), dtype=torch.float64))
        assert not x.any() and torch.equal(T, torch.eye(4, dtype=torch.float64))


def _correspondences(rng, n=500):
    src = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    xi = np.concatenate([rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.02])
    T = tlie.se3_exp(torch.from_numpy(xi)).numpy()
    tgt = (src.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
           + rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    return src, tgt, mask


@pytest.mark.parametrize("layout", ["aos", "soa", "empty"])
def test_align_clouds(layout):
    rng = np.random.default_rng(9)
    src, tgt, mask = _correspondences(rng)
    if layout == "empty":
        mask[:] = False
    kth = 0.3
    if layout == "soa":
        s64, t64 = src.astype(np.float64), tgt.astype(np.float64)
        Tj, xj = jicp._align_soa(*(jnp.asarray(s64[:, i]) for i in range(3)),
                                 *(jnp.asarray(t64[:, i]) for i in range(3)),
                                 jnp.asarray(mask), kth)
        Tt, xt = ticp._align_soa(*(torch.from_numpy(s64[:, i]) for i in range(3)),
                                 *(torch.from_numpy(t64[:, i]) for i in range(3)),
                                 torch.from_numpy(mask), torch.tensor(kth, dtype=torch.float64))
    else:
        Tj, xj = jicp.align_clouds(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), kth)
        Tt, xt = ticp.align_clouds(torch.from_numpy(src), torch.from_numpy(tgt),
                                   torch.from_numpy(mask), torch.tensor(kth, dtype=torch.float64))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-12)
    if layout == "empty":
        assert not xt.any()


def _registration_case(neighborhood):
    cj, ct = _cfgs(neighborhood=neighborhood)
    rng = np.random.default_rng(neighborhood)
    world = jsyn.make_world(seed=1, n_points=20000, extent=(14.0, 6.0, 3.0))
    pts = world[rng.choice(len(world), 6000, replace=False)].astype(np.float32)
    ones = np.ones(len(pts), bool)
    mj, mt = _insert_both(cj, ct, [(pts, ones)])
    src = pts[:512] + rng.normal(size=(512, 3)).astype(np.float32) * 0.005
    mask = rng.uniform(size=512) < 0.95
    xi = np.array([0.12, -0.08, 0.03, 0.004, -0.006, 0.01])
    guess = tlie.se3_exp(torch.from_numpy(xi)).numpy()
    return cj, ct, mj, mt, src, mask, guess


@pytest.mark.parametrize("neighborhood", [27, 8])
def test_icp_registration(neighborhood):
    cj, ct, mj, mt, src, mask, guess = _registration_case(neighborhood)
    args = (1.5, 0.5)
    rj = jicp.icp_registration(mj, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(guess),
                               *args, cj, 40, 1e-5)
    rt = ticp.icp_registration(mt, torch.from_numpy(src), torch.from_numpy(mask),
                               torch.from_numpy(guess), *args, ct, 40, 1e-5)
    assert int(rt.iterations) == int(rj.iterations) > 2
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.num_correspondences) == int(rj.num_correspondences)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(rt.residual_rms), float(rj.residual_rms), rtol=1e-5)


def test_icp_registration_unrolled_batched_against_vmap():
    """Two streams with their own maps, guesses and thresholds, against the
    JAX schedule under jax.vmap."""
    cases = [_registration_case(8), _registration_case(27)]
    cj, ct = cases[0][0], cases[0][1]  # both streams fetch 8-voxel neighbourhoods
    mt = tvm.VoxelMap(*(torch.stack([a, b]) for a, b in zip(cases[0][3], cases[1][3])))
    mj = jax.tree.map(lambda a, b: jnp.stack([a, b]), cases[0][2], cases[1][2])
    src = np.stack([c[4] for c in cases])
    mask = np.stack([c[5] for c in cases])
    guess = np.stack([c[6] for c in cases])
    max_d, kth = np.array([1.5, 0.9]), np.array([0.5, 0.3])
    rj = jax.vmap(lambda m, s, k, g, d, t: jicp.icp_registration_unrolled(
        m, s, k, g, d, t, cj, 3, 4, 1e-5))(mj, jnp.asarray(src), jnp.asarray(mask),
                                          jnp.asarray(guess), jnp.asarray(max_d),
                                          jnp.asarray(kth))
    rt = ticp.icp_registration_unrolled(mt, torch.from_numpy(src), torch.from_numpy(mask),
                                        torch.from_numpy(guess), torch.from_numpy(max_d),
                                        torch.from_numpy(kth), ct, 3, 4, 1e-5)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.num_correspondences.numpy(),
                                  np.asarray(rj.num_correspondences))
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# whole steps: register_frame, single and batched
# ---------------------------------------------------------------------------

N_SCANS = 8


def _pipeline_cfg(C, name):
    if name == "tiny":  # __graft_entry__._tiny_cfg with its default backend
        return C.PipelineConfig(
            lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
            map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16),
            icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20),
            ekf=C.EkfConfig(lidar_pose_trail=4),
            imu=C.ImuConfig(max_init_count=20, max_samples_per_scan=32),
        )
    # the bench f64 anchor's options (bench.py:_make_cfg(gn_backend="xla"))
    # scaled down: unsorted rolling-shutter scans, 8-voxel neighbourhood,
    # head-compacted insert, CV deskew
    return C.PipelineConfig(
        lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                            sort_by_time=False, time_source="per_point"),
        map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, neighborhood=8,
                        max_insert_voxels=700),
        icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        estimation_threshold=5e-4, deskew=True),
    )


def _scans(name, n):
    world = jsyn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    speed = 1.2 if name == "tiny" else 2.0
    gt = jsyn.make_trajectory(n_poses=n, speed=speed, yaw_rate=0.03, dt=0.1)
    out = []
    for i in range(n):
        if name == "tiny":
            pts = jsyn.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i)
            out.append((pts, jsyn.azimuth_times(pts, i * 0.1), i * 0.1))
        else:
            pts, rel = jsyn.render_scan_rolling(world, gt[i], gt[min(i + 1, n - 1)], 0.1,
                                                1500, 0.5, 30.0, noise=0.01, seed=i)
            out.append((pts, i * 0.1 + rel, i * 0.1))
    return out, gt


def _torch_scan(s, cfg):
    return tpre.preprocess_scan(tpre.pack_raw_scan(s[0], time=s[1], stamp=s[2],
                                                   max_points=cfg.lidar.max_points,
                                                   device="cpu"), cfg.lidar)


def _to_jax_scan(scan):
    return JScan(*(jnp.asarray(t.numpy()) for t in scan))


def _np_tree(state):
    return jax.tree.map(np.asarray, state)


def _jax_state(tree):
    return jk.KissState(jvm.VoxelMap(*tree.map), tree.pose, tree.pose_prev, tree.first_pose,
                        tree.num_poses, jicp.ThresholdState(*tree.threshold))


def _pose_err(pt, pj):
    dt = float(np.abs(pt[..., :3, 3] - pj[..., :3, 3]).max())
    rel = np.swapaxes(pj[..., :3, :3], -1, -2) @ pt[..., :3, :3]
    dr = float(np.linalg.norm(tlie.so3_log(torch.from_numpy(rel)).numpy(), axis=-1).max())
    return dt, dr


@pytest.fixture(scope="module", params=["tiny", "bench_like"])
def drive(request):
    """Both packages from fresh states over the same preprocessed scans."""
    name = request.param
    cj, ct = _pipeline_cfg(jcfg, name), _pipeline_cfg(tcfg, name)
    assert ct.icp.gn_backend == "xla" and ct.map.store_points
    scans, gt = _scans(name, N_SCANS)
    sj, st = jk.init_state(cj), tk.init_state(ct, "cpu")
    states_j, poses_j, poses_t, states_t, outs = [], [], [], [], []
    for s in scans:
        scan = _torch_scan(s, ct)
        sj, oj = jk.register_frame_jit(sj, _to_jax_scan(scan), cj)
        st, ot = tk.register_frame(st, scan, ct)
        states_j.append(_np_tree(sj))
        poses_j.append(np.asarray(oj.pose))
        poses_t.append(ot.pose.numpy())
        states_t.append(st)
        outs.append((int(oj.icp_iterations), int(ot.icp_iterations)))
    return dict(cj=cj, ct=ct, scans=scans, gt=gt, states_j=states_j, states_t=states_t,
                poses_j=np.stack(poses_j), poses_t=np.stack(poses_t), iters=outs)


def test_drive_scan0_map_bit_equal(drive):
    _assert_maps_equal(drive["states_j"][0].map, drive["states_t"][0].map, "scan 0")
    np.testing.assert_array_equal(drive["poses_t"][0], np.eye(4))


def test_free_drive_poses_agree(drive):
    assert np.isfinite(drive["poses_t"]).all()
    assert _pose_err(drive["poses_t"], drive["poses_j"])[0] < 5e-3
    assert sum(t for _, t in drive["iters"]) > N_SCANS  # the ICP really iterated


@pytest.mark.parametrize("step", [2, 5])
def test_shared_state_step(drive, step):
    cj, ct = drive["cj"], drive["ct"]
    tree = drive["states_j"][step - 1]
    scan = _torch_scan(drive["scans"][step], ct)
    sj_next, oj = jk.register_frame_jit(_jax_state(tree), _to_jax_scan(scan), cj)
    st_next, ot = tk.register_frame(interop.kiss_state_from_numpy(tree, "cpu"), scan, ct)
    dt, dr = _pose_err(ot.pose.numpy(), np.asarray(oj.pose))
    assert dt < 1e-6 and dr < 1e-6, (dt, dr)
    assert int(ot.icp_iterations) == int(oj.icp_iterations)
    assert int(ot.map_voxels) == int(oj.map_voxels)
    for f in ("keys", "npts", "grid", "next_slot"):
        np.testing.assert_array_equal(getattr(st_next.map, f).numpy(),
                                      np.asarray(getattr(sj_next.map, f)), err_msg=f)


def test_step_in_place_matches_functional(drive):
    ct = drive["ct"]
    st = drive["states_t"][2]
    scan = _torch_scan(drive["scans"][3], ct)
    points_before = st.map.points.clone()
    new_f, out_f = tk.register_frame(st, scan, ct)
    assert torch.equal(st.map.points, points_before)
    copy = tk.KissState(tvm.VoxelMap(*(t.clone() for t in st.map)), *st[1:])
    new_s, out_s = tk.register_frame_step(copy, scan, ct)
    assert torch.equal(out_f.pose, out_s.pose)
    for a, b in zip(new_f.map, new_s.map):
        assert torch.equal(a, b)


def test_interop_carries_the_point_slab(drive):
    tree = drive["states_j"][4]
    assert tree.map.points.shape == (drive["cj"].map.capacity,
                                     drive["cj"].map.max_points_per_voxel * 3)
    back = interop.kiss_state_to_numpy(interop.kiss_state_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


S = 2


@pytest.fixture(scope="module")
def batched_drive():
    """S = 2 streams under batch_config with gn_backend="xla" (2 x 4
    unroll, `icp_registration_unrolled`), stream s at step i on scan i + s."""
    cj = jstreams.batch_config(_pipeline_cfg(jcfg, "bench_like"))
    ct = tstreams.batch_config(_pipeline_cfg(tcfg, "bench_like"))
    scans, gt = _scans("bench_like", 6 + S - 1)
    raws = [tpre.pack_raw_scan(s[0], time=s[1], stamp=s[2], max_points=2048, device="cpu")
            for s in scans]
    steps = [tpre.preprocess_scan(tpre.stack_raw_scans(raws[i:i + S]), ct.lidar)
             for i in range(6)]
    sj, st = jstreams.init_batched_state(cj, S), tstreams.init_batched_state(ct, S, "cpu")
    states_j, poses_j, poses_t = [], [], []
    for scan in steps:
        sj, oj = jstreams.batched_register_frame_jit(sj, _to_jax_scan(scan), cj)
        st, ot = tstreams.batched_register_frame(st, scan, ct)
        states_j.append(_np_tree(sj))
        poses_j.append(np.asarray(oj.pose))
        poses_t.append(ot.pose.numpy())
    return dict(cj=cj, ct=ct, steps=steps, states_j=states_j, poses_j=np.stack(poses_j),
                poses_t=np.stack(poses_t), last=st)


def test_batched_free_drive(batched_drive):
    p_t, p_j = batched_drive["poses_t"], batched_drive["poses_j"]
    assert p_t.shape == (6, S, 4, 4) and np.isfinite(p_t).all()
    assert _pose_err(p_t, p_j)[0] < 5e-3
    assert not np.allclose(p_t[:, 0], p_t[:, 1])


def test_batched_shared_state_step(batched_drive):
    cj, ct = batched_drive["cj"], batched_drive["ct"]
    tree = batched_drive["states_j"][2]
    scan = batched_drive["steps"][3]
    _, oj = jstreams.batched_register_frame_jit(_jax_state(tree), _to_jax_scan(scan), cj)
    _, ot = tstreams.batched_register_frame(interop.batched_kiss_state_from_numpy(tree, "cpu"),
                                            scan, ct)
    for s in range(S):
        dt, dr = _pose_err(ot.pose[s].numpy(), np.asarray(oj.pose[s]))
        assert dt < 1e-6 and dr < 1e-6, (s, dt, dr)
    np.testing.assert_array_equal(ot.icp_iterations.numpy(), np.asarray(oj.icp_iterations))
    np.testing.assert_array_equal(ot.map_voxels.numpy(), np.asarray(oj.map_voxels))


def test_batched_interop_carries_the_point_slab(batched_drive):
    tree = batched_drive["states_j"][3]
    assert tree.map.points.ndim == 3 and tree.map.points.shape[0] == S
    back = interop.batched_kiss_state_to_numpy(
        interop.batched_kiss_state_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# the port against the independent numpy oracle
# ---------------------------------------------------------------------------


def test_port_tracks_the_oracle():
    """tests/test_trajectory_parity.py's drive and bars, with the port in
    place of the JAX pipeline."""
    cfg = tcfg.PipelineConfig(
        lidar=tcfg.LidarConfig(num_scan_lines=16, max_points=4096, min_range=1.0,
                               max_range=40.0),
        map=tcfg.MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 14, neighborhood=27),
        icp=tcfg.IcpConfig(deskew=False, max_map_points=4096, max_source_points=2048,
                           max_iterations=100),
    )
    world = jsyn.make_world(seed=3, n_points=120_000, extent=(70.0, 24.0, 8.0))
    gt = jsyn.make_trajectory(n_poses=52, speed=2.0, yaw_rate=0.02, dt=0.1)
    ocfg = oracle_mod.OracleConfig.match_jax(
        voxel_size=cfg.map.voxel_size, max_range=cfg.map.max_range,
        max_points_per_voxel=cfg.map.max_points_per_voxel,
        initial_threshold=cfg.icp.initial_threshold, min_motion_th=cfg.icp.min_motion_th,
        max_iterations=cfg.icp.max_iterations,
        estimation_threshold=cfg.icp.estimation_threshold)
    ocfg.min_correspondences = cfg.icp.min_correspondences
    ocfg.max_step_norm = cfg.icp.max_step_norm
    ocfg.max_model_deviation = cfg.icp.max_model_deviation
    odo = oracle_mod.ReferenceOdometry(ocfg)
    state = tk.init_state(cfg, "cpu")
    rot, trans = [], []
    for i, pose in enumerate(gt):
        pts = jsyn.render_scan(world, pose, 3000, 1.0, 40.0, noise=0.01, seed=100 + i)
        scan = tpre.preprocess_scan(tpre.pack_raw_scan(pts, stamp=i * 0.1, max_points=4096,
                                                       device="cpu"), cfg.lidar)
        state, out = tk.register_frame_step(state, scan, cfg)
        P = out.pose.numpy()
        O = odo.register_frame(scan.xyz.numpy()[scan.mask.numpy()].astype(np.float64))
        D = oracle_mod.inv(P) @ O
        rot.append(np.linalg.norm(oracle_mod.so3_log(D[:3, :3])))
        trans.append(np.linalg.norm(D[:3, 3]))
    rot, trans = np.asarray(rot), np.asarray(trans)
    assert np.max(trans[:8]) < 1e-4, trans[:8]
    assert np.max(rot[:8]) < 1e-4, rot[:8]
    assert np.max(trans) < 5e-2, np.max(trans)
    assert np.median(trans) < 1e-3, np.median(trans)

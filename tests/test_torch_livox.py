"""The dense solid-state deployment (`config.livox_dense()`, BASELINE.json
config 4), port against the JAX package at full width.

A scan holds 262,144 = 2^18 points, exactly the packed-sort budget
(`voxel_map._IDX_BITS`), with 6 lines, a 5-100 m range and no per-point
time; the map has 2^18 slots with the f32 slab, the ICP budgets are 65,536
map and 16,384 source points, and the fast path runs K1-K3 (their plain
versions here, on the CPU).

* the drive: tests/test_livox.py's world and trajectory, 6 scans through
  JAX's `register_frame_jit` and the port's `register_frame` — scan 0's
  integer map state bit-equal and its pose the identity, every pose within
  5e-3 m / 5e-3 rad of JAX's, correspondence and voxel counts within
  0.1% at every scan (~1e-5 m of pose noise moves a point that lies on a
  voxel face across it), and test_livox.py's bars (final error under
  0.3 m, more than 1,000 correspondences);
* shared-state steps: JAX's state after each scan k - 1 carried across
  with `interop`, scan k in each package — poses within 1e-3 m / 1e-3
  rad, correspondence and voxel counts equal;
* the budget edge: `fused_downsample` (with and without tau),
  `first_point_per_voxel` and `_voxel_group_sort` on seeded inputs of
  exactly 2^18 rows, one of them built so that every 18-bit payload field
  (output index, map-voxel head, input index) reaches 2^18 - 1 — bit-equal
  to JAX's functions; at 2^18 + 1 rows the port raises ValueError where
  JAX asserts.
"""

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
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import kiss_icp as tk
from lidar_imu_slam_tpu_torch.ops import lie as tlie
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm

torch.set_num_threads(1)

N_SCANS = 6
EDGE = 1 << 18  # the packed-sort budget, voxel_map._IDX_BITS


def _rot_err(a, b) -> float:
    return float(np.linalg.norm(tlie.so3_log(torch.from_numpy(a[:3, :3].T @ b[:3, :3])).numpy()))


@pytest.fixture(scope="module")
def drive():
    """tests/test_livox.py's drive in both packages."""
    cj, ct = jcfg.livox_dense(), tcfg.livox_dense()
    n = cj.lidar.max_points
    world = jsyn.make_world(seed=2, n_points=500_000, extent=(120.0, 30.0, 10.0))
    gt = jsyn.make_trajectory(n_poses=N_SCANS, speed=4.0, yaw_rate=0.01, dt=0.1)
    scans = [jsyn.render_scan(world, pose, n, cj.lidar.min_range, cj.lidar.max_range,
                              noise=0.02, seed=i) for i, pose in enumerate(gt)]
    sj, st = jk.init_state(cj), tk.init_state(ct, "cpu")
    states_j, maps_t, outs_j, outs_t = [], [], [], []
    for i, pts in enumerate(scans):
        sj, oj = jk.register_frame_jit(sj, jpre.preprocess_scan(
            jpre.pack_raw_scan(pts, stamp=i * 0.1, max_points=n), cj.lidar), cj)
        st, ot = tk.register_frame(st, tpre.preprocess_scan(
            tpre.pack_raw_scan(pts, stamp=i * 0.1, max_points=n, device="cpu"), ct.lidar), ct)
        states_j.append(jax.tree.map(np.asarray, sj))
        maps_t.append(st.map)
        outs_j.append(jax.tree.map(np.asarray, oj))
        outs_t.append(ot)
    return dict(cj=cj, ct=ct, scans=scans, gt=gt, states_j=states_j, maps_t=maps_t,
                outs_j=outs_j, outs_t=outs_t)


def test_scans_fill_the_budget(drive):
    assert drive["ct"].lidar.max_points == EDGE
    assert all(len(pts) == EDGE for pts in drive["scans"])


def test_scan0_map_bit_equal(drive):
    mj, mt = drive["states_j"][0].map, drive["maps_t"][0]
    for f in jvm.VoxelMap._fields:
        np.testing.assert_array_equal(getattr(mt, f).numpy(), getattr(mj, f), err_msg=f)
    np.testing.assert_array_equal(drive["outs_t"][0].pose.numpy(), np.eye(4))


def test_poses_agree(drive):
    for i, (oj, ot) in enumerate(zip(drive["outs_j"], drive["outs_t"])):
        pj, pt = oj.pose, ot.pose.numpy()
        assert np.isfinite(pt).all(), i
        assert np.abs(pt[:3, 3] - pj[:3, 3]).max() < 5e-3, i
        assert _rot_err(pj, pt) < 5e-3, i


def test_counts_agree(drive):
    """The free drive's correspondence and voxel counts within 0.1% of
    JAX's. They need not be equal: the poses part by ~1e-5 m (the port's
    f64 pose against JAX's f32 pair), and a point that close to a 1 m voxel
    face can land in the voxel beside it. The ground lies on such a face
    (z = -2 in the map frame: the trajectory runs at z = 2). One voxel of
    35,168 differs at scan 4, one correspondence of 11,110 at scan 5. From
    a shared state the counts are equal (test_shared_state_step)."""
    for i, (oj, ot) in enumerate(zip(drive["outs_j"], drive["outs_t"])):
        for f in ("num_correspondences", "map_voxels"):
            a, b = int(getattr(ot, f)), int(getattr(oj, f))
            assert abs(a - b) <= 1e-3 * b, (i, f, a, b)


def test_tracks(drive):
    """tests/test_livox.py's bars on the port."""
    gt = drive["gt"]
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    last = drive["outs_t"][-1]
    assert np.linalg.norm(last.pose.numpy()[:3, 3] - gt_rel[-1][:3, 3]) < 0.3
    assert int(last.num_correspondences) > 1000


@pytest.mark.parametrize("k", range(1, N_SCANS))
def test_shared_state_step(drive, k):
    """JAX's state after scan k - 1 carried across, scan k in each package:
    poses within 1e-3 m / 1e-3 rad, correspondence and voxel counts equal."""
    cj, ct = drive["cj"], drive["ct"]
    tree = drive["states_j"][k - 1]
    sj = jk.KissState(jvm.VoxelMap(*tree.map), tree.pose, tree.pose_prev, tree.first_pose,
                      tree.num_poses, jicp.ThresholdState(*tree.threshold))
    st = interop.kiss_state_from_numpy(tree, "cpu")
    n, pts = cj.lidar.max_points, drive["scans"][k]
    _, oj = jk.register_frame_jit(sj, jpre.preprocess_scan(
        jpre.pack_raw_scan(pts, stamp=k * 0.1, max_points=n), cj.lidar), cj)
    _, ot = tk.register_frame(st, tpre.preprocess_scan(
        tpre.pack_raw_scan(pts, stamp=k * 0.1, max_points=n, device="cpu"), ct.lidar), ct)
    pj, pt = np.asarray(oj.pose), ot.pose.numpy()
    assert np.abs(pt[:3, 3] - pj[:3, 3]).max() < 1e-3
    assert _rot_err(pj, pt) < 1e-3
    assert int(ot.num_correspondences) == int(oj.num_correspondences)
    assert int(ot.map_voxels) == int(oj.map_voxels)


# ---------------------------------------------------------------------------
# the packed-sort budget edge: 2^18 rows
# ---------------------------------------------------------------------------


def _edge_inputs(case: str, n: int = EDGE):
    """(points (n, 3) f32, mask (n,), tau (n,) f32, out_capacity), seeded.

    "distinct": one point in each of 64^3 = 2^18 unit voxels in a seeded
    order, so with out_capacity 2^18 every point is its own fine cell and
    its own map voxel: the output index, the head's output index and the
    input index each run to 2^18 - 1. "dense": a dense scan's shape —
    points clustered on a few hundred surfaces, a tenth of them masked,
    the livox_dense map budget (65,536) binding."""
    rng = np.random.default_rng(18)
    if case == "distinct":
        side = round(n ** (1 / 3))
        cells = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = cells[rng.permutation(len(cells))] + rng.uniform(0.1, 0.9, (len(cells), 3))
        mask = np.ones(len(cells), bool)
        cap = n
    else:
        centres = rng.uniform(-60.0, 60.0, (400, 3)) * [1.0, 1.0, 0.1]
        pts = centres[rng.integers(0, 400, n)] + rng.normal(0.0, 1.5, (n, 3))
        mask = rng.uniform(size=n) > 0.1
        cap = 65536
    tau = rng.uniform(0.0, 1.0, len(pts)).astype(np.float32)
    return pts.astype(np.float32), mask, tau, cap


@pytest.fixture(scope="module", params=["distinct", "dense"])
def edge(request):
    return (request.param,) + _edge_inputs(request.param)


def _same(got: torch.Tensor, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("with_tau", [False, True], ids=["no_tau", "tau"])
def test_edge_fused_downsample(edge, with_tau):
    case, pts, mask, tau, cap = edge
    tau_j = jnp.asarray(tau) if with_tau else None
    tau_t = torch.from_numpy(tau) if with_tau else None
    gj = jvm.fused_downsample(jnp.asarray(pts), jnp.asarray(mask), 1.0, cap, tau=tau_j)
    gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask), 1.0, cap, tau=tau_t)
    for f in jvm.GroupedCloud._fields:
        _same(getattr(gt, f), getattr(gj, f), f)
    if case == "distinct":  # every 18-bit field at its maximum
        assert int(gt.n_unique) == EDGE
        assert int(gt.head_pos.max()) == EDGE - 1 and bool(gt.head.all())


def test_edge_first_point_per_voxel(edge):
    case, pts, mask, _, cap = edge
    outs_j = jvm.first_point_per_voxel(jnp.asarray(pts), jnp.asarray(mask), 1.0, cap)
    outs_t = tvm.first_point_per_voxel(torch.from_numpy(pts), torch.from_numpy(mask), 1.0, cap)
    for what, a, b in zip(("points", "mask", "n_unique", "window_drops"), outs_t, outs_j):
        _same(a, b, what)
    if case == "distinct":
        assert int(outs_t[2]) == EDGE


def test_edge_voxel_group_sort(edge):
    _, pts, mask, _, _ = edge
    vox_j = jvm.voxel_of(jnp.asarray(pts), 1.0)
    vox_t = tvm.voxel_of(torch.from_numpy(pts), 1.0)
    _same(vox_t, vox_j, "voxel_of")
    outs_j = jvm._voxel_group_sort(vox_j, jnp.asarray(mask), EDGE)
    outs_t = tvm._voxel_group_sort(vox_t, torch.from_numpy(mask))
    for what, a, b in zip(("order", "group", "valid", "window_drops"), outs_t, outs_j):
        _same(a.to(torch.int64) if what == "order" else a,
              np.asarray(b).astype(np.int64) if what == "order" else b, what)
    assert int(outs_t[0].max()) == EDGE - 1


@pytest.mark.parametrize("fn", ["fused_downsample", "first_point_per_voxel",
                                "voxel_group_sort"])
def test_over_budget_raises(fn):
    pts = np.zeros((EDGE + 1, 3), np.float32)
    mask = np.ones(EDGE + 1, bool)
    pt, mt = torch.from_numpy(pts), torch.from_numpy(mask)
    if fn == "voxel_group_sort":  # JAX's takes n and checks nothing itself
        with pytest.raises(ValueError, match="budget"):
            tvm._voxel_group_sort(tvm.voxel_of(pt, 1.0), mt)
        return
    with pytest.raises(AssertionError, match="budget"):
        getattr(jvm, fn)(jnp.asarray(pts), jnp.asarray(mask), 1.0, 65536)
    with pytest.raises(ValueError):
        getattr(tvm, fn)(pt, mt, 1.0, 65536)

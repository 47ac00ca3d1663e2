"""The port's pose-graph backend (`lidar_imu_slam_tpu_torch/models/
backend.py`) against the JAX package's, on the CPU, graphs carried across
with `interop.pose_graph_from_numpy`:

* construction (`create`, `add_node`, `add_edge`, `add_odometry_chain`,
  `from_chain`) array-equal, the counts equal, and past capacity the
  update dropped and still counted, as JAX drops an out-of-range set;
* weighted residuals and both Jacobians within 1e-9 on a random graph and
  on one whose edge errors sit near a rotation of pi (the port: forward-
  mode dual numbers through `ops/lie`; JAX: `jax.jacobian`);
* dense LM `optimize` on tests/test_backend.py's drifted square loop: poses
  within 1e-8 of JAX's;
* a Cholesky failure (a NaN measurement, a negative weight): every step
  rejected in both packages, the poses returned unchanged, no raise;
* `find_loop_candidates` identical, exact distance ties included (a stable
  sort in both).

JAX results are computed once per module; every dense JAX solve shares one
(K, E) = (32, 64) shape and one iteration count, so JAX compiles it once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.models import backend as jb
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import backend as tb
from lidar_imu_slam_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)

K, E = 32, 64
ITERS = 15
# jitted once per shape (op-by-op dispatch of the vmapped Jacobians compiles
# each op on first use)
_j_edge_terms = jax.jit(jb._edge_terms)
_j_graph_error = jax.jit(jb.graph_error)


def _np(g):
    return jax.tree.map(np.asarray, g)


def _port(g):
    return interop.pose_graph_from_numpy(_np(g), "cpu")


def _assert_graph_equal(jg, tg):
    want, got = _np(jg), interop.pose_graph_to_numpy(tg)
    for f in jb.PoseGraph._fields:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _square_trajectory(n_side=5, step=1.0):
    """tests/test_backend.py's square loop of 4 * n_side poses."""
    poses = [np.eye(4)]
    for heading in (0, np.pi / 2, np.pi, -np.pi / 2):
        c, s = np.cos(heading), np.sin(heading)
        for _ in range(n_side):
            T = poses[-1].copy()
            T[:3, 3] += np.array([c * step, s * step, 0])
            poses.append(T)
    return np.stack(poses)


def _drifted_square():
    """tests/test_backend.py::test_corrects_drifted_loop's graph."""
    rng = np.random.default_rng(3)
    gt = _square_trajectory(4)
    drifted = [gt[0]]
    for i in range(1, len(gt)):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        noise = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6)
                                                    + [0.02, 0, 0, 0, 0, 0.01])))
        drifted.append(drifted[-1] @ rel @ noise)
    return gt, np.stack(drifted)


def _loop_graph(meas_fn=None, weight=10.0):
    gt, drifted = _drifted_square()
    g = jb.from_chain(drifted, K, E)
    meas = np.linalg.inv(gt[0]) @ gt[-1] if meas_fn is None else meas_fn(gt)
    return jb.add_edge(g, 0, len(gt) - 1, jnp.asarray(meas), weight)


def _random_graph(rng, n_nodes=10, n_edges=24, near_pi=False):
    """Random poses on 16 nodes / 32 edges, built in numpy; measurements off
    the true relative pose by a random twist, or (near_pi) by a rotation of
    pi - 1e-4 about a random axis."""
    xi = rng.normal(0, 1.0, (n_nodes, 6))
    poses = np.broadcast_to(np.eye(4), (16, 4, 4)).copy()
    poses[:n_nodes] = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    edge_i, edge_j = np.zeros(32, np.int32), np.zeros(32, np.int32)
    meas = np.broadcast_to(np.eye(4), (32, 4, 4)).copy()
    weight = np.zeros(32)
    err = rng.normal(0, 0.3, (n_edges, 6))
    if near_pi:
        axis = rng.normal(size=(n_edges, 3))
        err[:, 3:] = (np.pi - 1e-4) * axis / np.linalg.norm(axis, axis=1, keepdims=True)
    err_T = np.asarray(jlie.se3_exp(jnp.asarray(err)))
    for e in range(n_edges):
        i, j = rng.choice(n_nodes, 2, replace=False)
        edge_i[e], edge_j[e] = i, j
        meas[e] = np.linalg.inv(poses[i]) @ poses[j] @ err_T[e]
        weight[e] = rng.uniform(0.5, 5.0)
    node_mask, edge_mask = np.arange(16) < n_nodes, np.arange(32) < n_edges
    return jb.PoseGraph(*(jnp.asarray(a) for a in (poses, node_mask, edge_i, edge_j, meas,
                                                    weight, edge_mask)),
                        num_nodes=jnp.int32(n_nodes), num_edges=jnp.int32(n_edges))


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def test_create_equal():
    _assert_graph_equal(jb.create(K, E), tb.create(K, E, "cpu"))


def test_from_chain_equal():
    _, drifted = _drifted_square()
    _assert_graph_equal(jb.from_chain(drifted, K, E, weight=2.5),
                        tb.from_chain(drifted, K, E, weight=2.5, device="cpu"))


def test_add_node_edge_and_chain_equal():
    gt = _square_trajectory(3)[:7]
    jg = jb.add_odometry_chain(jb.create(16, 32), jnp.asarray(gt))
    tg = tb.add_odometry_chain(tb.create(16, 32, "cpu"), gt)
    meas = np.linalg.inv(gt[1]) @ gt[6]
    jg = jb.add_edge(jg, 1, 6, jnp.asarray(meas), 7.0)
    tg = tb.add_edge(tg, 1, 6, meas, 7.0)
    _assert_graph_equal(jg, tg)
    assert float(_j_graph_error(jg)) < 1e-20 and float(tb.graph_error(tg)) < 1e-20


def test_past_capacity_drops_the_update_and_counts_it():
    poses = _square_trajectory(1)[:4]
    jg, tg = jb.create(2, 1), tb.create(2, 1, "cpu")
    for p in poses:
        jg, tg = jb.add_node(jg, jnp.asarray(p)), tb.add_node(tg, p)
    for i in range(3):
        meas = np.linalg.inv(poses[i]) @ poses[i + 1]
        jg = jb.add_edge(jg, i, i + 1, jnp.asarray(meas), 1.0 + i)
        tg = tb.add_edge(tg, i, i + 1, meas, 1.0 + i)
    assert (tg.num_nodes, tg.num_edges) == (4, 3)
    _assert_graph_equal(jg, tg)
    np.testing.assert_array_equal(tg.poses.numpy(), poses[:2])


def test_interop_round_trip():
    jg = _loop_graph()
    back = interop.pose_graph_to_numpy(_port(jg))
    for f in jb.PoseGraph._fields:
        a, b = np.asarray(getattr(_np(jg), f)), np.asarray(getattr(back, f))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# residuals and Jacobians
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("near_pi", [False, True], ids=["random", "near_pi"])
def test_edge_terms_match(near_pi):
    jg = _random_graph(np.random.default_rng(5 + near_pi), near_pi=near_pi)
    rj, Jij, Jjj = (np.asarray(x) for x in _j_edge_terms(jg))
    rt, Jit, Jjt = (x.numpy() for x in tb._edge_terms(_port(jg)))
    if near_pi:  # the residuals' rotations do sit near pi
        ang = np.linalg.norm(rj[: int(jg.num_edges), 3:], axis=1)
        ang /= np.sqrt(np.asarray(jg.edge_weight)[: int(jg.num_edges)])
        assert ang.max() > 3.0
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Jit, Jij, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Jjt, Jjj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(tb.graph_error(_port(jg))), float(_j_graph_error(jg)),
                               rtol=1e-12)


def test_edge_residuals_equal_the_dual_pass():
    tg = _port(_random_graph(np.random.default_rng(9)))
    np.testing.assert_array_equal(tb._edge_residuals(tg).numpy(), tb._edge_terms(tg)[0].numpy())


def test_jacobians_at_identity_error():
    # a consistent graph: every residual 0, Jj = I and Ji = -Ad(meas^-1)
    # (the closed forms at xi = 0, r = 0)
    rng = np.random.default_rng(1)
    poses = tlie.se3_exp(torch.as_tensor(rng.normal(0, 1, (5, 6))))
    g = tb.add_odometry_chain(tb.create(8, 8, "cpu"), poses)
    r, Ji, Jj = tb._edge_terms(g)
    n = g.num_edges
    assert float(torch.abs(r).max()) < 1e-12
    np.testing.assert_allclose(Jj[:n].numpy(), np.broadcast_to(np.eye(6), (n, 6, 6)),
                               atol=1e-12)
    meas_inv = tlie.transform_inverse(g.edge_meas[:n]).numpy()
    for e in range(n):
        R, t = meas_inv[e, :3, :3], meas_inv[e, :3, 3]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        ad = np.block([[R, tx @ R], [np.zeros((3, 3)), R]])
        np.testing.assert_allclose(Ji[e].numpy(), -ad, atol=1e-12)


# ---------------------------------------------------------------------------
# dense LM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_results():
    """JAX's `optimize_jit` on the drifted loop and on two graphs whose
    Cholesky fails, all (32, 64) and ITERS steps: one compile."""
    cases = {
        "loop": _loop_graph(),
        "nan_meas": _loop_graph(meas_fn=lambda gt: np.full((4, 4), np.nan)),
        "negative_weight": _loop_graph(weight=-10.0),
    }
    return {name: (g, np.asarray(jb.optimize_jit(g, iterations=ITERS).poses))
            for name, g in cases.items()}


def test_dense_optimize_matches_jax(dense_results):
    jg, want = dense_results["loop"]
    gt, drifted = _drifted_square()
    tg = tb.optimize(_port(jg), iterations=ITERS)
    np.testing.assert_allclose(tg.poses.numpy(), want, rtol=0, atol=1e-8)
    # and it did its job (tests/test_backend.py's bars)
    n = len(gt)
    assert float(tb.graph_error(tg)) < 0.1 * float(tb.graph_error(_port(jg)))
    before = np.linalg.norm(drifted[-1][:3, 3] - gt[-1][:3, 3])
    after = np.linalg.norm(tg.poses[n - 1, :3, 3].numpy() - gt[-1][:3, 3])
    assert after < 0.5 * before
    np.testing.assert_allclose(tg.poses[0].numpy(), gt[0], atol=1e-6)


@pytest.mark.parametrize("case", ["nan_meas", "negative_weight"])
def test_cholesky_failure_rejects_every_step(dense_results, case):
    jg, want = dense_results[case]
    start = np.asarray(jg.poses)
    np.testing.assert_array_equal(want, start)  # JAX: NaN factor, every step rejected
    tg = _port(jg)
    H, _ = tb._assemble(tg, *tb._edge_terms(tg), torch.tensor(1e-6, dtype=torch.float64))
    _, info = torch.linalg.cholesky_ex(H)
    assert not torch.isfinite(H).all() or int(info) != 0
    out = tb.optimize(tg, iterations=ITERS)
    np.testing.assert_array_equal(out.poses.numpy(), start)


# ---------------------------------------------------------------------------
# loop candidates
# ---------------------------------------------------------------------------


def _serpentine(nx=6, ny=5):
    """Poses on an exact unit grid, row by row in alternating directions:
    distances between rows tie exactly."""
    poses = []
    for y in range(ny):
        for x in (range(nx) if y % 2 == 0 else reversed(range(nx))):
            T = np.eye(4)
            T[:2, 3] = x, y
            poses.append(T)
    return np.stack(poses)


@pytest.mark.parametrize("traj,radius,gap,count", [("square", 0.75, 8, 8),
                                                   ("serpentine", 1.5, 4, 64),
                                                   ("serpentine", 2.5, 2, 128)])
def test_find_loop_candidates_identical(traj, radius, gap, count):
    gt = _square_trajectory(4) if traj == "square" else _serpentine()
    jg = jb.add_odometry_chain(jb.create(K, E), jnp.asarray(gt))
    want = jb.find_loop_candidates(jg, radius=radius, min_index_gap=gap, max_candidates=count)
    got = tb.find_loop_candidates(_port(jg), radius, gap, count)
    assert int(np.sum(np.asarray(want.mask))) > 0
    for f in jb.LoopCandidates._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    d = np.asarray(want.dist)[np.asarray(want.mask)]
    if traj == "serpentine":
        assert len(np.unique(d)) < len(d) // 4  # exact ties were present

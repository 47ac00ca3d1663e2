"""The port's matrix-free PCG pose-graph solve and ICP loop verification
(`lidar_imu_slam_tpu_torch/models/backend.py`) against the JAX package's,
on the CPU, graphs carried across with `interop.pose_graph_from_numpy`:

* `optimize_cg` on tests/test_backend_scale.py's drifted circle (64 nodes,
  256 edges) and its 500-node double loop in a 512 / 1024 graph with three
  revisit edges: poses within 1e-8 of JAX's, and the bars of that file (the
  dense optimum within 0.05 m, the anchor fixed, a consistent graph's
  error under 1e-6);
* the matrix-free product and the block-Jacobi blocks against the dense
  normal matrix of `_assemble`;
* `verify_and_add_loops` on tests/test_backend.py's verification case: the
  same edge accepted, its measurement within 1e-6 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.config import MapConfig as JMapConfig
from lidar_imu_slam_tpu.models import backend as jb
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.config import MapConfig as TMapConfig
from lidar_imu_slam_tpu_torch.models import backend as tb

torch.set_num_threads(1)


def _port(g):
    return interop.pose_graph_from_numpy(jax.tree.map(np.asarray, g), "cpu")


def _drifted_circle(n=48, radius=10.0, yaw_err=0.006):
    """tests/test_backend_scale.py's drifted circle."""
    gt = []
    for k in range(n):
        th = 2 * np.pi * k / (n - 1)
        T = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [radius * np.sin(th), radius * (1 - np.cos(th)), 0.0]
        gt.append(T)
    gt = np.stack(gt)
    drift = np.eye(4)
    cd, sd = np.cos(yaw_err), np.sin(yaw_err)
    drift[:3, :3] = [[cd, -sd, 0], [sd, cd, 0], [0, 0, 1]]
    drift[:3, 3] = [0.015, 0, 0]
    drifted = [gt[0]]
    for k in range(1, n):
        drifted.append(drifted[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift)
    return gt, np.stack(drifted)


def _circle_graph():
    gt, drifted = _drifted_circle()
    g = jb.from_chain(drifted, 64, 256)
    return jb.add_edge(g, 0, len(gt) - 1, jnp.asarray(np.linalg.inv(gt[0]) @ gt[-1]), 50.0)


def _double_loop_graph():
    """tests/test_backend_scale.py::test_cg_scales_to_kitti_length_graph."""
    n = 500
    th = np.linspace(0, 4 * np.pi, n)
    poses = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    poses[:, 0, 3] = 30 * np.sin(th)
    poses[:, 1, 3] = 30 * (1 - np.cos(th))
    g = jb.from_chain(poses, 512, 1024)
    for k in (10, 100, 200):
        g = jb.add_edge(g, k, k + n // 2,
                        jnp.asarray(np.linalg.inv(poses[k]) @ poses[k + n // 2]), 5.0)
    return g


@pytest.fixture(scope="module")
def jax_cg():
    circle, loop = _circle_graph(), _double_loop_graph()
    return {
        "circle": (circle, np.asarray(
            jb.optimize_cg_jit(circle, iterations=12, cg_iterations=96).poses)),
        "double_loop": (loop, np.asarray(
            jb.optimize_cg_jit(loop, iterations=3, cg_iterations=48).poses)),
    }


def test_cg_matches_jax_on_the_drifted_circle(jax_cg):
    jg, want = jax_cg["circle"]
    tg = _port(jg)
    out = tb.optimize_cg(tg, iterations=12, cg_iterations=96)
    np.testing.assert_allclose(out.poses.numpy(), want, rtol=0, atol=1e-8)
    # test_backend_scale.py's bars: both solvers cut the error tenfold and
    # agree on the trajectory
    dense = tb.optimize(tg, iterations=12)
    e0 = float(tb.graph_error(tg))
    assert float(tb.graph_error(out)) < 0.1 * e0 and float(tb.graph_error(dense)) < 0.1 * e0
    n = 48
    d = out.poses[:n, :3, 3] - dense.poses[:n, :3, 3]
    assert float(torch.linalg.vector_norm(d, dim=1).max()) < 0.05


def test_cg_matches_jax_on_the_double_loop(jax_cg):
    jg, want = jax_cg["double_loop"]
    out = tb.optimize_cg(_port(jg), iterations=3, cg_iterations=48)
    np.testing.assert_allclose(out.poses.numpy(), want, rtol=0, atol=1e-8)
    assert float(tb.graph_error(out)) < 1e-6


def test_cg_anchor_fixed():
    _, drifted = _drifted_circle(n=20)
    g = tb.from_chain(drifted, 32, 64, device="cpu")
    g = tb.add_edge(g, 0, 19, np.eye(4), 50.0)
    out = tb.optimize_cg(g, iterations=3, cg_iterations=32)
    np.testing.assert_array_equal(out.poses[0].numpy(), drifted[0])
    assert not torch.equal(out.poses[19], g.poses[19])


def test_matrix_free_product_and_blocks_match_the_dense_matrix():
    g = _port(_circle_graph())
    r, Ji, Jj = tb._edge_terms(g)
    lam = torch.tensor(0.3, dtype=torch.float64)
    H, _ = tb._assemble(g, r, Ji, Jj, torch.tensor(0.0, dtype=torch.float64))
    k = g.poses.shape[0]
    free = g.node_mask & (torch.arange(k) != 0)
    # J^T J: the dense matrix less its gauge prior (node 0 and the inactive
    # nodes, which the product leaves out) and its 1e-12 floor
    fm = free.repeat_interleave(6).to(torch.float64)
    prior = torch.where(fm > 0, 0.0, 1e12)
    JtJ = H - torch.diag(prior + 1e-12)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(k, 6)))
    want = (fm[:, None] * (JtJ @ (fm * x.reshape(-1))[:, None]))[:, 0] + lam * fm * x.reshape(-1)
    got = tb._apply_H(g, Ji, Jj, free, lam, x).reshape(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-9)
    Minv = tb._block_jacobi_inv(g, Ji, Jj, free, lam)
    for node in (1, 20, 47):
        blk = JtJ[6 * node:6 * node + 6, 6 * node:6 * node + 6] + (0.3 + 1e-9) * torch.eye(6)
        np.testing.assert_allclose((Minv[node] @ blk).numpy(), np.eye(6), atol=1e-8)
    np.testing.assert_array_equal(Minv[60].numpy(), np.eye(6))  # inactive: identity


def _verify_case():
    """tests/test_backend.py::test_verify_loop_with_icp's two keyframes."""
    rng = np.random.default_rng(3)
    world = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
    T_i = np.eye(4)
    T_j = np.asarray(jlie.se3_exp(jnp.asarray([0.3, 0.1, 0.0, 0.0, 0.0, 0.05])))
    cloud_i = ((world - T_i[:3, 3]) @ T_i[:3, :3]).astype(np.float32)
    cloud_j = ((world - T_j[:3, 3]) @ T_j[:3, :3]).astype(np.float32)
    drifted_j = T_j @ np.asarray(jlie.se3_exp(jnp.asarray([0.05, -0.02, 0, 0, 0, 0.01])))
    return T_i, T_j, drifted_j, np.stack([cloud_i, cloud_j])


def test_verify_and_add_loops_matches_jax():
    T_i, T_j, drifted_j, clouds = _verify_case()
    kw = dict(voxel_size=0.5, max_points_per_voxel=10, max_range=50.0, capacity=1 << 12)
    jg = jb.add_node(jb.add_node(jb.create(4, 8), jnp.asarray(T_i)), jnp.asarray(drifted_j))
    cand = jb.LoopCandidates(idx_i=jnp.asarray([0], jnp.int32), idx_j=jnp.asarray([1], jnp.int32),
                             dist=jnp.asarray([0.3]), mask=jnp.asarray([True]))
    masks = np.ones((2, 2000), bool)
    want = jb.verify_and_add_loops(jg, cand, jnp.asarray(clouds), jnp.asarray(masks),
                                   JMapConfig(**kw))
    tcand = tb.LoopCandidates(*(torch.as_tensor(np.asarray(x)) for x in cand))
    got = tb.verify_and_add_loops(_port(jg), tcand, torch.as_tensor(clouds),
                                  torch.as_tensor(masks), TMapConfig(**kw))
    assert got.num_edges == int(want.num_edges) == 1
    np.testing.assert_allclose(got.edge_meas[0].numpy(), np.asarray(want.edge_meas[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.edge_meas[0].numpy(), np.linalg.inv(T_i) @ T_j, atol=0.02)

"""Fused GN kernel K1 and the fused ICP loop: the port's plain version
`fused_gn_carry_ref` against the JAX Pallas kernel `fused_gn_carry`
(interpret mode on the CPU), and the port's `icp_registration_fused_pair`
against the JAX fused registration, on the geometry of
tests/test_pallas_gn.py (including the 300 m far-from-origin map).

Tolerances: one kernel call R 1e-5 and t 1e-4 m, iterations and flags
equal, n_corr within 1 (the JAX kernel sums and solves in f32, the port in
f64); a whole registration 1e-3 on every pose entry — the bar the JAX
package holds its own fused kernel to against its f64 path
(test_pallas_gn.py:51)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.config import MapConfig as JMapConfig
from lidar_imu_slam_tpu.ops import icp as jicp
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.ops.pallas import icp_gn as jgn
from lidar_imu_slam_tpu_torch.config import MapConfig
from lidar_imu_slam_tpu_torch.ops import icp as ticp
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.ops.kernels import _common
from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn as tgn

torch.set_num_threads(1)

KW = dict(voxel_size=1.0, max_range=40.0, capacity=1 << 13, neighborhood=27)
JCFG, TCFG = JMapConfig(**KW), MapConfig(**KW)


@functools.lru_cache(maxsize=None)
def _maps(offset=(0.0, 0.0, 0.0), seed=0, n=3000):
    """The JAX map and the same tables as the port's map (both read-only
    in these tests, so cached across them)."""
    rng = np.random.default_rng(seed)
    world = (rng.uniform(-18, 18, size=(n, 3)) + np.asarray(offset)).astype(np.float32)
    mj = jvm.insert(jvm.create(JCFG), jnp.asarray(world), jnp.ones(n, bool), JCFG)
    mt = tvm.VoxelMap(*(torch.from_numpy(np.array(a)) for a in mj))
    return mj, mt, world


def _case(kind):
    if kind == "rotated":
        mj, mt, world = _maps()
        xi = np.array([0.3, -0.2, 0.05, 0.01, -0.02, 0.04])
        T_true = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        Tinv = np.linalg.inv(T_true)
        src = (world[:1024] @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
        guess = np.asarray(jlie.se3_exp(jnp.asarray(xi * 0.9)))
        return mj, mt, src, guess, T_true
    offset = (300.0, -250.0, 40.0) if kind == "far" else (0.0, 0.0, 0.0)
    mj, mt, world = _maps(offset)
    t_true = np.array([0.25, -0.15, 0.1]) if kind == "near" else np.array([0.2, 0.1, -0.05])
    T_true = np.eye(4)
    T_true[:3, 3] = t_true
    return mj, mt, (world[:1024] - t_true).astype(np.float32), np.eye(4), T_true


@pytest.mark.parametrize("kind", ["near", "far", "rotated"])
@pytest.mark.parametrize("n_inner", [1, 6])
def test_kernel_ref_matches_jax_kernel(kind, n_inner):
    mj, mt, src, guess, _ = _case(kind)
    n = src.shape[0]
    # queries at the carried pose, centred on their centroid (f32, as the loop)
    R = guess[:3, :3].astype(np.float32)
    w = (src @ R.T + guess[:3, 3].astype(np.float32)).astype(np.float32)
    anchor = w.mean(0, dtype=np.float32)
    q = (w - anchor).T.copy()
    cand = np.asarray(jvm.gather_candidate_planes_packed(
        mj, jnp.asarray(w), jnp.ones(n, bool), JCFG, jnp.asarray(anchor)))
    scal = np.array([0.5, 2.25, 1e-5, 20.0, 2.0, 0.25, 0.0, 0.0], np.float32)
    th = guess[:3, 3].astype(np.float32)
    tl = (guess[:3, 3] - th).astype(np.float32)
    carry_j = np.concatenate([guess[:3, :3].reshape(9).astype(np.float32), th, tl, anchor])
    out_j = jgn.fused_gn_carry(
        jnp.asarray(q.reshape(3, n // 128, 128)), jnp.ones((n // 128, 128), jnp.float32),
        jnp.asarray(cand), jnp.asarray(scal), jnp.asarray(carry_j), n_inner, interpret=True)
    R_j, t_j = np.asarray(out_j[0], np.float64), np.asarray(out_j[1], np.float64) + np.asarray(
        out_j[2], np.float64)
    flags_j = float(out_j[6]) + 2.0 * float(out_j[7])

    carry_t = torch.from_numpy(np.concatenate(
        [guess[:3, :3].reshape(9), guess[:3, 3], anchor.astype(np.float64)]))
    row = tgn.fused_gn_carry_ref(
        torch.from_numpy(q), torch.ones(n), torch.from_numpy(cand.reshape(3, -1, n)),
        torch.from_numpy(scal.astype(np.float64)), carry_t, n_inner).numpy()
    np.testing.assert_allclose(row[0:9], R_j, atol=1e-5)
    np.testing.assert_allclose(row[9:12], t_j, atol=1e-4)
    assert row[14] == float(out_j[5])  # iterations
    assert row[15] == flags_j
    assert abs(row[12] - float(out_j[3])) <= 1  # n_corr


def _register_both(mj, mt, src, guess, max_iterations=30, n_inner=6):
    n = src.shape[0]
    rj = jicp.icp_registration_fused(
        mj, jnp.asarray(src), jnp.ones(n, bool), jnp.asarray(guess), 1.5, 0.5, JCFG,
        max_iterations, 1e-5, n_inner=n_inner)
    rt = ticp.icp_registration_fused_pair(
        mt, torch.from_numpy(src), torch.ones(n, dtype=torch.bool),
        torch.from_numpy(guess[:3, :3].reshape(9).copy()),
        torch.from_numpy(guess[:3, 3].copy()), 1.5, 0.5, TCFG, max_iterations, 1e-5,
        n_inner=n_inner)
    pose_t = np.eye(4)
    pose_t[:3, :3] = rt.pose[:9].numpy().reshape(3, 3)
    pose_t[:3, 3] = rt.pose[9:12].numpy()
    return rj, rt, pose_t


@pytest.mark.parametrize("kind", ["near", "far", "rotated"])
def test_registration_matches_jax(kind):
    mj, mt, src, guess, T_true = _case(kind)
    rj, rt, pose_t = _register_both(mj, mt, src, guess, 60 if kind == "rotated" else 30,
                                    8 if kind == "rotated" else 6)
    assert np.abs(pose_t - np.asarray(rj.pose)).max() < 1e-3
    np.testing.assert_allclose(pose_t, T_true, atol=0.03)
    assert bool(rt.converged) == bool(rj.converged)
    assert abs(int(rt.num_correspondences) - int(rj.num_correspondences)) <= 1
    assert rt.iterations == int(rj.iterations)


def test_starved_correspondences_freeze():
    mj, mt, _ = _maps()
    src = np.full((256, 3), 500.0, np.float32)
    rj, rt, pose_t = _register_both(mj, mt, src, np.eye(4))
    np.testing.assert_allclose(pose_t, np.eye(4), atol=1e-9)
    assert int(rt.num_correspondences) == 0 == int(rj.num_correspondences)
    assert rt.iterations == int(rj.iterations)


def test_empty_map_returns_guess():
    mj, mt = jvm.create(JCFG), tvm.create(TCFG, "cpu")
    guess = np.eye(4)
    guess[0, 3] = 2.5
    rj, rt, pose_t = _register_both(mj, mt, np.zeros((128, 3), np.float32), guess)
    np.testing.assert_array_equal(pose_t, guess)
    assert not bool(rt.converged) and not bool(rj.converged)


def test_rejects_ragged_source():
    _, mt, _ = _maps()
    with pytest.raises(ValueError, match="% 128"):
        ticp.icp_registration_fused_pair(
            mt, torch.zeros((100, 3)), torch.ones(100, dtype=torch.bool),
            torch.eye(3, dtype=torch.float64).reshape(9), torch.zeros(3, dtype=torch.float64),
            1.5, 0.5, TCFG, 30, 1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    _, mt, world = _maps()
    src = torch.from_numpy(world[:256] - 0.1)
    anchor = src.mean(0)
    q = (src - anchor).T.contiguous()
    cand = tvm.gather_candidate_planes_packed(mt, src, torch.ones(256, dtype=torch.bool),
                                              TCFG, anchor).contiguous()
    scal = torch.tensor([0.5, 2.25, 1e-5, 20.0, 2.0, 0.25, 0.0, 0.0], dtype=torch.float64)
    carry = torch.cat([torch.eye(3, dtype=torch.float64).reshape(9),
                       torch.zeros(3, dtype=torch.float64), anchor.double()])
    before = dict(_common.LAUNCHES)
    row = tgn.fused_gn_carry(q, torch.ones(256), cand, scal, carry, 6)
    np.testing.assert_array_equal(
        row.numpy(), tgn.fused_gn_carry_ref(q, torch.ones(256), cand, scal, carry, 6).numpy())
    assert _common.LAUNCHES == before
    with pytest.raises(TypeError):
        tgn.fused_gn_carry(q.double(), torch.ones(256), cand, scal, carry, 6)
    with pytest.raises(ValueError):
        tgn.fused_gn_carry(q, torch.ones(255), cand, scal, carry, 6)

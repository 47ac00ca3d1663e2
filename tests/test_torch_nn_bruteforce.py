"""Kernel K6 `nn_bruteforce`: the port's plain version (what the wrapper
runs on CPU tensors) against the JAX package's kernel in interpret mode,
and `pool_from_map` against JAX's on maps built by both packages' `insert`.

Tolerances: indices equal and d^2 within rtol 1e-6 against JAX (the same
f32 expression; XLA may evaluate it in another order); exact ties resolve
to the first index in both; the pools are bit-equal. Against the hash
fetch on one map: K6 is never farther, and equal wherever its winner lies
in a voxel the hash fetch searched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.ops.pallas import nn_bruteforce as jbf
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.ops.kernels import nn_bruteforce as tbf

torch.set_num_threads(1)


def _both(queries, pool):
    d2_j, idx_j = jbf.nn_bruteforce(jnp.asarray(queries), jnp.asarray(pool), interpret=True)
    d2_t, idx_t = tbf.nn_bruteforce(torch.tensor(queries), torch.tensor(pool))
    assert d2_t.dtype == torch.float32 and idx_t.dtype == torch.int32
    return (np.asarray(d2_j), np.asarray(idx_j)), (d2_t.numpy(), idx_t.numpy())


def test_matches_jax_random():
    rng = np.random.default_rng(0)
    n, m = 256, 8192
    queries = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    pool = rng.uniform(-20, 20, (3, m)).astype(np.float32)
    (d2_j, idx_j), (d2_t, idx_t) = _both(queries, pool)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(d2_t, d2_j, rtol=1e-6)


def test_inf_padding_never_wins():
    rng = np.random.default_rng(1)
    queries = rng.uniform(-5, 5, (jbf.QT, 3)).astype(np.float32)
    pool = np.full((3, jbf.MT), np.inf, np.float32)
    pool[:, :10] = rng.uniform(-5, 5, (10, 3)).astype(np.float32).T
    (d2_j, idx_j), (d2_t, idx_t) = _both(queries, pool)
    assert int(idx_t.max()) < 10 and np.isfinite(d2_t).all()
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(d2_t, d2_j, rtol=1e-6)


def test_exact_ties_take_the_first_index():
    """Points on an integer lattice, each present twice (the copy in a later
    pool tile), queried at lattice points and half-integer midpoints."""
    rng = np.random.default_rng(2)
    m = jbf.MT * 2
    pts = rng.integers(-4, 5, (m // 2, 3)).astype(np.float32)
    pool = np.concatenate([pts, pts]).T.copy()
    queries = (rng.integers(-8, 9, (jbf.QT, 3)) / 2.0).astype(np.float32)
    (d2_j, idx_j), (d2_t, idx_t) = _both(queries, pool)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(d2_t, d2_j)
    assert (idx_t < m // 2).all()  # never the later copy


def test_empty_pool_and_any_shape():
    """The port takes any N and M (the TPU tiling asserts are not carried
    over); a pool with nothing finite gives (+inf, 0), as JAX's initial
    accumulator."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.uniform(-1, 1, (37, 3)).astype(np.float32))
    d2, idx = tbf.nn_bruteforce(q, torch.full((3, 1000), float("inf")))
    assert torch.isinf(d2).all() and not idx.any()
    pool = torch.from_numpy(rng.uniform(-1, 1, (3, 1001)).astype(np.float32))
    d2, idx = tbf.nn_bruteforce(q, pool)
    ref = ((q[:, :, None] - pool[None]) ** 2).sum(1)
    np.testing.assert_array_equal(idx.numpy(), ref.argmin(1).numpy())
    # the chunk merge keeps the earlier index whatever the chunk width
    for chunk in (1, 7, 1000, 5000):
        d2c, idxc = tbf.nn_bruteforce_plain(q, pool, chunk=chunk)
        assert torch.equal(idxc, idx) and torch.equal(d2c, d2)


def test_wrapper_checks_its_arguments():
    with pytest.raises(TypeError):
        tbf.nn_bruteforce(torch.zeros(4, 3, dtype=torch.float64), torch.zeros(3, 8))
    with pytest.raises(ValueError):
        tbf.nn_bruteforce(torch.zeros(4, 3), torch.zeros(8, 3))


def _maps(store_points=True, **kw):
    kw = dict(dict(voxel_size=1.0, max_points_per_voxel=4, capacity=1 << 10, max_range=30.0,
                   store_points=store_points), **kw)
    cj, ct = jcfg.MapConfig(**kw), tcfg.MapConfig(**kw)
    rng = np.random.default_rng(4)
    mj, mt = jvm.create(cj), tvm.create(ct, "cpu")
    for shift in (0.0, 3.0):
        pts = (rng.uniform(-10, 10, (300, 3)) + shift).astype(np.float32)
        mask = rng.uniform(size=300) < 0.9
        mj = jvm.insert(mj, jnp.asarray(pts), jnp.asarray(mask), cj)
        mt = tvm.insert(mt, torch.from_numpy(pts), torch.from_numpy(mask), ct)
    # a tombstoned voxel and dead rows must both read as +inf
    origin = np.array([-12.0, 0.0, 0.0])
    mj = jvm.evict_far(mj, jnp.asarray(origin), cj)
    mt = tvm.evict_far(mt, torch.from_numpy(origin), ct)
    return cj, ct, mj, mt, pts


def test_pool_from_map_bit_equal_and_round_trip():
    cj, ct, mj, mt, pts = _maps(max_range=18.0)
    pool_j = np.asarray(jbf.pool_from_map(mj, cj))
    pool_t = tbf.pool_from_map(mt, ct)
    assert pool_t.shape == (3, jbf.MT) and int(mt.tombstones) > 0
    np.testing.assert_array_equal(pool_t.numpy(), pool_j)
    finite = np.isfinite(pool_j[0])
    assert finite.sum() == int(mt.npts.sum())  # every stored point exactly once
    q = np.tile(pool_j[:, np.argmax(finite)], (jbf.QT, 1)).astype(np.float32)
    (d2_j, idx_j), (d2_t, idx_t) = _both(q, pool_j)
    assert float(d2_t[0]) == 0.0 and int(idx_t[0]) == int(idx_j[0]) == int(np.argmax(finite))


def test_pool_needs_the_point_slab():
    _, ct, _, mt, _ = _maps(store_points=False)
    with pytest.raises(ValueError, match="store_points"):
        tbf.pool_from_map(mt, ct)


@pytest.mark.parametrize("neighborhood", [8, 27])
def test_exact_versus_hash_fetch(neighborhood):
    """K6 is a superset of the hash fetch: never farther, and equal where
    the hash searched K6's winning voxel — with `insert` every point is
    filed under its own voxel, so that is every query within half a voxel
    (8-block) or one voxel (27-shell) of its nearest point."""
    cj, ct, _, mt, pts = _maps(neighborhood=neighborhood)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(np.concatenate([pts[:100] + rng.normal(size=(100, 3)) * 0.05,
                                         rng.uniform(-12, 14, (300, 3))]).astype(np.float32))
    d2, idx = tbf.nn_bruteforce(q, tbf.pool_from_map(mt, ct))
    ones = torch.ones(q.shape[0], dtype=torch.bool)
    _, d2_hash, found = tvm.nearest_neighbors(mt, q, ones, ct)
    slots = tvm._neighbor_slots(mt, q, ones, ct)
    searched = (slots == (idx // ct.max_points_per_voxel)[:, None]).any(-1)
    assert not (found & (d2 > d2_hash)).any()
    assert torch.equal(d2[found & searched], d2_hash[found & searched])
    reach = 0.5 if neighborhood == 8 else 1.0
    near = found & (d2_hash <= reach ** 2)
    assert near.sum() > 50 and torch.equal(d2[near], d2_hash[near])
    assert (d2 < d2_hash).any()  # the brute force reaches past the neighbourhood

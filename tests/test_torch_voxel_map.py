"""The port's voxel map against the JAX package's: integer tables
bit-equal after a seeded sequence of downsamples, inserts (both insert
paths, functional and in place), evictions and a rebuild; downsamples
equal; candidate planes equal, from the packed slab and from the f32 point
slab (the port's (3, NC, N) layout is the JAX (3, NC, N/128, 128) layout
without the lane split, so equal elementwise and therefore as sets)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm

torch.set_num_threads(1)

BASE = dict(voxel_size=0.5, max_range=30.0, capacity=1 << 12)


def _assert_maps_equal(mj, mt, where=""):
    for f in jvm.VoxelMap._fields:
        a, b = np.asarray(getattr(mj, f)), getattr(mt, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{where} {f}")


def _cloud(rng, n, shift, spread=25.0):
    pts = (rng.uniform(-spread, spread, (n, 3)) + shift).astype(np.float32)
    # points exactly on voxel edges: the f32 division must not move them
    pts[:64] = np.round(pts[:64] * 2.0) / 2.0
    mask = rng.uniform(size=n) < 0.9
    tau = rng.uniform(size=n).astype(np.float32)
    return pts, mask, tau


@pytest.mark.parametrize("max_insert_voxels", [0, 300])
@pytest.mark.parametrize("store_points", [True, False])
def test_map_sequence_bit_equal(max_insert_voxels, store_points):
    kw = dict(BASE, max_insert_voxels=max_insert_voxels, store_points=store_points)
    cj, ct = jcfg.MapConfig(**kw), tcfg.MapConfig(**kw)
    rng = np.random.default_rng(max_insert_voxels + store_points)
    mj, mt = jvm.create(cj), tvm.create(ct, "cpu")
    _assert_maps_equal(mj, mt, "create")
    for it in range(5):
        pts, mask, tau = _cloud(rng, 2048, it * 4.0)
        gj = jvm.fused_downsample(jnp.asarray(pts), jnp.asarray(mask), cj.voxel_size,
                                  1024, tau=jnp.asarray(tau))
        gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                                  ct.voxel_size, 1024, tau=torch.from_numpy(tau))
        kj = jvm.pack_key(jvm.voxel_of(gj.points, cj.voxel_size))
        kt = tvm.pack_key(tvm.voxel_of(gt.points, ct.voxel_size))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        mj = jvm.insert_grouped(mj, gj, cj, keys=kj)
        mt = tvm.insert_grouped(mt, gt, ct, keys=kt, inplace=it % 2 == 1)
        _assert_maps_equal(mj, mt, f"insert {it}")
        origin = np.array([it * 4.0 + 6.0, -3.0, 1.0])
        mj = jvm.evict_far(mj, jnp.asarray(origin), cj)
        mt = tvm.evict_far(mt, torch.from_numpy(origin), ct, inplace=it % 2 == 0)
        _assert_maps_equal(mj, mt, f"evict {it}")
        if it == 2:
            mj, mt = jvm.rebuild(mj, cj), tvm.rebuild(mt, ct)
            _assert_maps_equal(mj, mt, "rebuild")
    assert int(tvm.num_voxels(mt)) == int(jvm.num_voxels(mj)) > 0


def test_functional_insert_leaves_input_unchanged():
    c = tcfg.MapConfig(**BASE)
    rng = np.random.default_rng(7)
    pts, mask, _ = _cloud(rng, 2048, 0.0)
    g = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask), c.voxel_size, 1024)
    m0 = tvm.create(c, "cpu")
    snapshot = [t.clone() for t in m0]
    m1 = tvm.insert_grouped(m0, g, c)
    tvm.evict_far(m1, torch.zeros(3), c)
    for a, b in zip(snapshot, m0):
        assert torch.equal(a, b)
    assert int(tvm.num_voxels(m1)) > 0


@pytest.mark.parametrize("with_tau", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_downsample_equal(with_tau, seed):
    rng = np.random.default_rng(seed)
    pts, mask, tau = _cloud(rng, 4096, -10.0, spread=40.0)
    pts[100:110] = pts[100]  # duplicates: index / time tie-breaks
    gj = jvm.fused_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.5, 2048,
                              tau=jnp.asarray(tau) if with_tau else None)
    gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask), 0.5, 2048,
                              tau=torch.from_numpy(tau) if with_tau else None)
    for f in jvm.GroupedCloud._fields:
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                      err_msg=f)


@pytest.mark.parametrize("n,cap", [(4096, 512), (300, 512), (1000, 1000)])
def test_first_point_per_voxel_equal(n, cap):
    rng = np.random.default_rng(n)
    pts, mask, _ = _cloud(rng, n, 5.0)
    a = jvm.first_point_per_voxel(jnp.asarray(pts), jnp.asarray(mask), 0.75, cap)
    b = tvm.first_point_per_voxel(torch.from_numpy(pts), torch.from_numpy(mask), 0.75, cap)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_empty_mask_downsamples():
    pts = np.zeros((1024, 3), np.float32)
    mask = np.zeros(1024, bool)
    gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask), 0.5, 512)
    gj = jvm.fused_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.5, 512)
    for f in jvm.GroupedCloud._fields:
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)))
    assert int(gt.n_unique) == 0


@pytest.mark.parametrize("neighborhood", [8, 27])
@pytest.mark.parametrize("anchor_kind", ["centroid", "far"])
def test_candidate_planes_equal(neighborhood, anchor_kind):
    c = jcfg.MapConfig(**BASE, neighborhood=neighborhood)
    ct = tcfg.MapConfig(**BASE, neighborhood=neighborhood)
    rng = np.random.default_rng(neighborhood)
    mj, mt = jvm.create(c), tvm.create(ct, "cpu")
    for it in range(2):
        pts, mask, _ = _cloud(rng, 2048, it * 2.0, spread=15.0)
        gj = jvm.fused_downsample(jnp.asarray(pts), jnp.asarray(mask), c.voxel_size, 1024)
        gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                                  ct.voxel_size, 1024)
        mj = jvm.insert_grouped(mj, gj, c)
        mt = tvm.insert_grouped(mt, gt, ct)
    q = rng.uniform(-15, 15, (256, 3)).astype(np.float32)
    qm = rng.uniform(size=256) < 0.9
    anchor = (q[qm].mean(0) if anchor_kind == "centroid" else np.array([300.5, -20.25, 3.0]))
    anchor = anchor.astype(np.float32).astype(np.float64)
    cj = np.asarray(jvm.gather_candidate_planes_packed(
        mj, jnp.asarray(q), jnp.asarray(qm), c, jnp.asarray(anchor)))
    ct = tvm.gather_candidate_planes_packed(
        mt, torch.from_numpy(q), torch.from_numpy(qm), ct, torch.from_numpy(anchor)).numpy()
    nc = c.packed_width * neighborhood
    assert ct.shape == (3, nc, 256) and cj.shape == (3, nc, 2, 128)
    np.testing.assert_array_equal(ct, cj.reshape(3, nc, 256))
    # as sets per query (the contract if layouts ever diverge)
    for i in range(0, 256, 37):
        sj = {tuple(v) for v in cj.reshape(3, nc, 256)[:, :, i].T if np.isfinite(v).all()}
        st = {tuple(v) for v in ct[:, :, i].T if np.isfinite(v).all()}
        assert sj == st
    assert np.isfinite(ct).any()


@pytest.mark.parametrize("nn_points", [0, 4])
@pytest.mark.parametrize("neighborhood", [8, 27])
@pytest.mark.parametrize("anchor_kind", ["centroid", "far"])
def test_f32_slab_candidate_planes_equal(neighborhood, nn_points, anchor_kind):
    """`gather_candidate_planes` (the fused paths' fetch under packed_nn=False)
    bit-equal to JAX's, candidate order included: absent voxels +inf, the
    first nn_points of K = 10 per voxel, an f64 anchor centred in f32."""
    kw = dict(BASE, neighborhood=neighborhood, nn_points=nn_points, packed_nn=False)
    c, ct = jcfg.MapConfig(**kw), tcfg.MapConfig(**kw)
    rng = np.random.default_rng(neighborhood + nn_points)
    mj, mt = jvm.create(c), tvm.create(ct, "cpu")
    for it in range(2):  # a dense block: voxels with up to K points
        pts, mask, _ = _cloud(rng, 2048, it * 1.0, spread=4.0)
        gj = jvm.fused_downsample(jnp.asarray(pts), jnp.asarray(mask), c.voxel_size, 1024)
        gt = tvm.fused_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                                  ct.voxel_size, 1024)
        mj = jvm.insert_grouped(mj, gj, c)
        mt = tvm.insert_grouped(mt, gt, ct)
    q = rng.uniform(-6, 6, (256, 3)).astype(np.float32)  # inside and around the block
    qm = rng.uniform(size=256) < 0.9
    anchor = (q[qm].mean(0) if anchor_kind == "centroid"
              else np.array([300.5, -20.25, 3.0]) + 1e-9).astype(np.float64)
    cj = np.asarray(jvm.gather_candidate_planes(mj, jnp.asarray(q), jnp.asarray(qm), c,
                                                jnp.asarray(anchor.astype(np.float32))))
    got = tvm.gather_candidate_planes(mt, torch.from_numpy(q), torch.from_numpy(qm), ct,
                                      torch.from_numpy(anchor))
    nc = neighborhood * (nn_points or c.max_points_per_voxel)
    assert got.shape == (3, nc, 256) and cj.shape == (3, nc, 2, 128)
    np.testing.assert_array_equal(got.numpy(), cj.reshape(3, nc, 256))
    inf = np.isinf(got.numpy())
    assert inf.any() and (~inf).any()
    assert inf[:, :, ~qm].all()  # masked queries look nothing up
    # a leading stream axis fetches each stream's own map
    two = tvm.VoxelMap(*(torch.stack([t, t]) for t in mt))
    both = tvm.gather_candidate_planes(
        two, torch.from_numpy(np.stack([q, q[::-1].copy()])),
        torch.from_numpy(np.stack([qm, qm[::-1].copy()])), ct,
        torch.from_numpy(np.stack([anchor, anchor])))
    assert both.shape == (2, 3, nc, 256)
    assert torch.equal(both[0], got)
    rev = tvm.gather_candidate_planes(mt, torch.from_numpy(q[::-1].copy()),
                                      torch.from_numpy(qm[::-1].copy()), ct,
                                      torch.from_numpy(anchor))
    assert torch.equal(both[1], rev)


def test_f32_slab_fetch_requires_the_point_slab():
    c = tcfg.MapConfig(**BASE, store_points=False)
    m = tvm.create(c, "cpu")
    q = torch.zeros(128, 3)
    with pytest.raises(ValueError, match="store_points"):
        tvm.gather_candidate_planes(m, q, torch.ones(128, dtype=torch.bool), c, torch.zeros(3))


def test_voxel_of_truncates_toward_zero():
    p = torch.tensor([[-0.25, 0.5, 0.9999999], [-1.0, -0.5, 1.5]], dtype=torch.float32)
    np.testing.assert_array_equal(tvm.voxel_of(p, 0.5).numpy(),
                                  np.asarray(jvm.voxel_of(jnp.asarray(p.numpy()), 0.5)))

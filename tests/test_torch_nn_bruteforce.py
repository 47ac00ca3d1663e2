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
from lidar_imu_slam_tpu_torch.tools import nn_cases

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


# ---------------------------------------------------------------------------
# the card kernel's filter (csrc/nn_bruteforce.cu), held on the CPU: its
# margin on every pair of the adversarial cases, and an emulation of the
# kernel's algorithm (seed, filter, exact re-check, merge) against the plain
# version, bit for bit
# ---------------------------------------------------------------------------

F32 = np.float32
U = tbf.FILTER_U
STAGE, GROUP, STRIDE = 1024, 32, 64  # the kernel's kTile, kGroup, kSampleStride
BEST_INIT = np.array([0x7F7F7F7F], np.int32).view(np.float32)[0]


def _fma(a, b, c):
    """f32 fused multiply-add: the product of two f32 is exact in f64."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32) \
        if np.isscalar(a) else (a.astype(np.float64) * b + c).astype(F32)


def _exact_d2(q, p):
    """The plain version's f32 d^2 of every query (N, 3) to every entry (M, 3)."""
    d = p[None, :, :] - q[:, None, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _staged(p):
    """The kernel's staged entries: (coords, |p|^2) for in-range entries,
    (0, +inf) for non-finite ones, (0, -inf) for finite ones beyond the range."""
    inr = (np.abs(p) <= tbf.FILTER_RANGE).all(1)
    fin = np.isfinite(p).all(1)
    c = np.where(inr[:, None], p, F32(0))
    pp = _fma(c[:, 0], c[:, 0], _fma(c[:, 1], c[:, 1], c[:, 2] * c[:, 2]))
    pp = np.where(inr, pp, np.where(fin, F32(-np.inf), F32(np.inf)))
    return c, pp, inr


def _filter(q, c, pp, fused=True):
    """a = d^2 - |q|^2 + rounding for every pair: fused as the kernel, or
    un-fused (every product and sum rounded)."""
    m2 = F32(-2) * q
    if fused:
        a = _fma(m2[:, 2:3], c[None, :, 2], pp[None, :])
        a = _fma(m2[:, 1:2], c[None, :, 1], a)
        return _fma(m2[:, 0:1], c[None, :, 0], a)
    a = m2[:, 2:3] * c[None, :, 2] + pp[None, :]
    a = m2[:, 1:2] * c[None, :, 1] + a
    return m2[:, 0:1] * c[None, :, 0] + a


def _round_up(x):
    """f64 -> the nearest f32 at or above it (__double2float_ru)."""
    f = np.asarray(x).astype(F32)
    return np.where(f.astype(np.float64) < x, np.nextafter(f, F32(np.inf)), f)


def _modes(q):
    """0: filtered, 1: not finite (no re-check), 2: beyond the range (every group)."""
    fin = np.isfinite(q).all(1)
    inr = (np.abs(q) <= tbf.FILTER_RANGE).all(1)
    return np.where(~fin, 1, np.where(inr, 0, 2))


@pytest.mark.parametrize("case", nn_cases.CASES)
@np.errstate(invalid="ignore")  # NaN queries
def test_filter_margin_holds(case):
    """Every pair of in-range query and entry: a (fused as the kernel, and
    un-fused) is within the header's bound of |p|^2 - 2 q.p, and at most
    the threshold taken with T = the pair's own exact d^2 (the smallest T
    the kernel can hold when it must keep that entry)."""
    q, pool = nn_cases.make(case, 64, 6000, seed=1)
    p = pool.T
    d2 = _exact_d2(q, p)
    qq = (q.astype(np.float64) ** 2).sum(1)
    ok_q = _modes(q) == 0
    checked = 0
    for s0 in range(0, p.shape[0], STAGE):
        c, pp, inr = _staged(p[s0:s0 + STAGE])
        p2 = float(pp[inr].max()) if inr.any() else 0.0
        for fused in (True, False):
            a = _filter(q, c, pp, fused)
            pair = ok_q[:, None] & inr[None, :]
            if not pair.any():
                continue
            thr = _round_up(tbf.filter_threshold(d2[:, s0:s0 + STAGE], qq[:, None], p2))
            assert (a[pair] <= thr[pair]).all(), case
            # the header's bound on the filter's error, pair by pair
            pd = c.astype(np.float64)
            big_a = (pd ** 2).sum(1)[None, :] - 2.0 * (q.astype(np.float64) @ pd.T)
            pn = np.sqrt((pd ** 2).sum(1))[None, :]
            bound = 6.0000004 * U * pn ** 2 + 8.0000006 * U * np.sqrt(qq)[:, None] * pn + 1e-30
            assert (np.abs(a - big_a)[pair] <= bound[pair]).all(), case
            checked += int(pair.sum())
    assert checked > 0 or case == "all_inf"
    if case == "near_ties":
        # its queries' nearest entries: exact ties, and d^2 one ulp apart
        near = np.sort(d2[:32], axis=1)[:, :8].view(np.int32)
        gaps = np.diff(near, axis=1)
        assert (gaps == 0).any() and (gaps == 1).any()


@np.errstate(invalid="ignore")
def _emulate(q, pool, slice_len=tbf.SLICE):
    """The kernel's algorithm in numpy, slice after slice: the seed over
    every STRIDE-th entry, per stage the filter threshold from the smaller
    of the slice's best and the shared best, the group test, the exact
    re-check (first minimum below the running best), the tightened
    threshold, the shared best's update; then the ordered merge. Returns
    (d2, idx, share of query-group pairs re-checked)."""
    p = pool.T
    n, m = q.shape[0], p.shape[0]
    d2 = _exact_d2(q, p)
    mode = _modes(q)
    qq = (q.astype(np.float64) ** 2).sum(1)
    seed = np.fmin.reduce(d2[:, ::STRIDE], axis=1, initial=np.inf) if m else np.full(n, np.inf)
    shared = np.minimum(seed, BEST_INIT).astype(F32)
    parts, rechecked, groups = [], 0, 0
    for b in range(0, max(m, 1), slice_len):
        best = np.full(n, np.inf, F32)
        best_i = np.zeros(n, np.int64)
        for s0 in range(b, min(b + slice_len, m), STAGE):
            s1 = min(s0 + STAGE, m)
            c, pp, inr = _staged(p[s0:s1])
            p2 = float(pp[inr].max()) if inr.any() else 0.0
            qf = np.where((mode == 0)[:, None], q, F32(0))
            a = np.where((mode == 0)[:, None], _filter(qf, c, pp), pp[None, :])
            thr = np.where(mode == 0, _round_up(tbf.filter_threshold(
                np.minimum(best, shared), qq, p2)), np.where(mode == 2, np.inf, np.nan))
            for g in range(0, s1 - s0, GROUP):
                sl = slice(g, min(g + GROUP, s1 - s0))
                hit = np.fmin.reduce(a[:, sl], axis=1) <= thr  # NaN: False
                groups += n
                rechecked += int(hit.sum())
                exact = np.where(np.isfinite(pp[sl]) | (pp[sl] < 0), d2[:, s0 + g:s0 + sl.stop],
                                 np.inf)
                gmin = exact.min(1)
                better = hit & (gmin < best)
                first = np.argmax(exact == gmin[:, None], axis=1)
                best = np.where(better, gmin, best)
                best_i = np.where(better, s0 + g + first, best_i)
                thr = np.where(hit & (mode == 0), np.minimum(thr, _round_up(
                    tbf.filter_threshold(best, qq, p2))), thr)
            shared = np.where(mode == 0, np.minimum(shared, best), shared).astype(F32)
        parts.append((best, best_i))
    out_d2, out_i = parts[0]
    for d, i in parts[1:]:
        better = d < out_d2
        out_d2, out_i = np.where(better, d, out_d2), np.where(better, i, out_i)
    return out_d2.astype(F32), out_i.astype(np.int32), rechecked / max(groups, 1)


@pytest.mark.parametrize("case", nn_cases.CASES)
def test_filter_algorithm_matches_plain(case):
    """The kernel's algorithm, emulated, is bit-equal to the plain version
    on every adversarial case, at an N that is not a multiple of the
    kernel's 512-query tile and an M that is not a multiple of its slice."""
    q, pool = nn_cases.make(case, 100, 3 * tbf.SLICE + 1234, seed=2)
    d2_e, idx_e, share = _emulate(q, pool)
    d2_p, idx_p = tbf.nn_bruteforce_plain(torch.from_numpy(q), torch.from_numpy(pool))
    np.testing.assert_array_equal(idx_e, idx_p.numpy())
    np.testing.assert_array_equal(d2_e.view(np.int32), d2_p.numpy().view(np.int32))
    if case in ("nonfinite_queries", "all_inf"):
        bad = ~np.isfinite(q).all(1) if case == "nonfinite_queries" else np.ones(len(q), bool)
        assert np.isinf(d2_e[bad]).all() and not idx_e[bad].any()
    if case in ("far", "slice_ties", "on_point"):
        assert share < 0.05, share  # the filter spares most groups


def test_filter_constants_mirror_the_kernel():
    """The Python mirror of the filter (and this file's emulation) reads the
    constants of csrc/nn_bruteforce.cu."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tbf.__file__), "..", "..", "csrc",
                            "nn_bruteforce.cu")).read()

    def const(name):
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.e+-]+)f?;", src).group(1))

    assert const("kRange") == tbf.FILTER_RANGE and const("kU") == tbf.FILTER_U
    assert const("kMarginC") == tbf.FILTER_C and const("kMarginAbs") == tbf.FILTER_ABS
    assert (const("kTile"), const("kGroup"), const("kSampleStride")) == (STAGE, GROUP, STRIDE)
    assert tbf.SLICE % STAGE == 0


def test_nan_pool_entry_hides_its_chunk():
    """A NaN pool entry hides nothing from the plain version (ROADMAP queue
    3, fixed): its d^2 counts as +inf, the card kernel's per-entry rule.
    On the queue's input (NaN at entry 100, the nearest entry 19,999 in the
    same 32,768-entry chunk) it returns (0.01, 19,999), as JAX does there.
    JAX's kernel skips the whole 8192-entry tile that holds a NaN entry, a
    reference behaviour outside its contract (+inf for invalid entries):
    with the nearest entry in the NaN's own tile, JAX finds an entry of
    another tile, the port the nearest one."""
    m = 3 * jbf.MT
    pool = np.full((3, m), 50.0, np.float32)
    pool[:, 100] = np.nan
    pool[:, 19_999] = [0.1, 0.0, 0.0]
    q = np.zeros((jbf.QT, 3), np.float32)
    d01 = np.float32(0.1) * np.float32(0.1)
    (d2_j, idx_j), (d2_t, idx_t) = _both(q, pool)
    assert idx_t[0] == 19_999 and d2_t[0] == d01
    assert idx_j[0] == 19_999 and d2_j[0] == d01
    # the nearest entry in the NaN's own tile: JAX skips the tile
    pool[:, 200] = [0.1, 0.0, 0.0]
    pool[:, 19_999] = [0.2, 0.0, 0.0]
    (d2_j, idx_j), (d2_t, idx_t) = _both(q, pool)
    assert idx_t[0] == 200 and d2_t[0] == d01
    assert idx_j[0] == 19_999 and d2_j[0] == np.float32(0.2) * np.float32(0.2)


def test_nan_entries_case_finds_the_entry_beside_the_nan():
    """The nan_entries case of tools/nn_cases.py: each of its first queries'
    nearest entry lies right after a NaN entry of the same group, and the
    plain version returns it."""
    q, pool = nn_cases.make("nan_entries", 100, 3 * tbf.SLICE + 1234, seed=2)
    d2, idx = tbf.nn_bruteforce_plain(torch.from_numpy(q), torch.from_numpy(pool))
    idx = idx.numpy()[:32]
    assert np.isnan(pool[:, idx - 1]).any(0).all()
    assert (idx // 32 == (idx - 1) // 32).all()
    np.testing.assert_allclose(np.sqrt(d2.numpy()[:32]),
                               0.01 * (np.arange(32) % 5 + 1) * np.sqrt(3), rtol=1e-3)

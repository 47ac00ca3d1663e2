"""Kernels K4 (`fused_gn`) and K5 (`fused_gn_batched`) and the fixed-unroll
ICP schedule: the port's plain versions against the JAX Pallas kernels
(interpret mode on the CPU, as tests/test_pallas_gn.py runs them), on the
geometry of tests/test_torch_icp_gn.py (near, far at 300 m, rotated).

Tolerances: one kernel call R 1e-5 and t 1e-4 m, iterations and flags
equal, n_corr within 1 (the JAX kernel sums and solves in f32, the port in
f64 — K1's bar); K5 on one stream against K4 1e-12 (the same plain code);
a whole unrolled registration 1e-3 on every pose entry (the JAX package's
own fused-vs-f64 bar, test_pallas_gn.py:51)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.config import IcpConfig as JIcpConfig
from lidar_imu_slam_tpu.config import MapConfig as JMapConfig
from lidar_imu_slam_tpu.ops import icp as jicp
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu.ops import voxel_map as jvm
from lidar_imu_slam_tpu.ops.pallas import icp_gn as jgn
from lidar_imu_slam_tpu_torch.config import IcpConfig, MapConfig
from lidar_imu_slam_tpu_torch.ops import icp as ticp
from lidar_imu_slam_tpu_torch.ops import voxel_map as tvm
from lidar_imu_slam_tpu_torch.ops.kernels import _common
from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn as tgn

torch.set_num_threads(1)

KW = dict(voxel_size=1.0, max_range=40.0, capacity=1 << 13, neighborhood=27)
JCFG, TCFG = JMapConfig(**KW), MapConfig(**KW)
KINDS = ("near", "far", "rotated")
N = 1024


@functools.lru_cache(maxsize=None)
def _maps(offset=(0.0, 0.0, 0.0), n=3000):
    rng = np.random.default_rng(0)
    world = (rng.uniform(-18, 18, size=(n, 3)) + np.asarray(offset)).astype(np.float32)
    mj = jvm.insert(jvm.create(JCFG), jnp.asarray(world), jnp.ones(n, bool), JCFG)
    return jax.tree.map(np.asarray, mj), world


def _case(kind):
    """(JAX map as numpy leaves, world-frame source (N, 3), guess (4, 4))."""
    if kind == "rotated":
        mj, world = _maps()
        xi = np.array([0.3, -0.2, 0.05, 0.01, -0.02, 0.04])
        Tinv = np.linalg.inv(np.asarray(jlie.se3_exp(jnp.asarray(xi))))
        src = (world[:N] @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
        return mj, src, np.asarray(jlie.se3_exp(jnp.asarray(xi * 0.9)))
    offset = (300.0, -250.0, 40.0) if kind == "far" else (0.0, 0.0, 0.0)
    mj, world = _maps(offset)
    t_true = np.array([0.25, -0.15, 0.1]) if kind == "near" else np.array([0.2, 0.1, -0.05])
    return mj, (world[:N] - t_true).astype(np.float32), np.eye(4)


def _kernel_inputs(kind, kth):
    """Queries at the guess, centred on their centroid (f32), the JAX
    candidate planes, and per-stream scalars."""
    mj, src, guess = _case(kind)
    w = (src @ guess[:3, :3].T.astype(np.float32) + guess[:3, 3].astype(np.float32))
    w = w.astype(np.float32)
    anchor = w.mean(0, dtype=np.float32)
    q = (w - anchor).T.copy()
    cand = np.array(jvm.gather_candidate_planes_packed(
        jvm.VoxelMap(*mj), jnp.asarray(w), jnp.ones(N, bool), JCFG, jnp.asarray(anchor)))
    scal = np.array([kth, 2.25, 1e-5, 20.0, 2.0, 0.25, 0.0, 0.0], np.float32)
    return q, np.ones(N, np.float32), cand.reshape(3, -1, N), scal


def _check_row(row, jax_out):
    R, t, nc, rms, it, conv, stale = (np.asarray(x, np.float64) for x in jax_out)
    np.testing.assert_allclose(row[0:9], R.reshape(9), atol=1e-5)
    np.testing.assert_allclose(row[9:12], t, atol=1e-4)
    assert row[14] == it
    assert row[15] == float(conv) + 2.0 * float(stale)
    assert abs(row[12] - nc) <= 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_inner", [1, 4])
def test_fused_gn_ref_matches_jax_kernel(kind, n_inner):
    q, qm, cand, scal = _kernel_inputs(kind, 0.5)
    out_j = jgn.fused_gn(jnp.asarray(q.reshape(3, N // 128, 128)),
                         jnp.asarray(qm.reshape(N // 128, 128)),
                         jnp.asarray(cand.reshape(3, -1, N // 128, 128)), jnp.asarray(scal),
                         n_inner, interpret=True)
    row = tgn.fused_gn_ref(torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(cand),
                           torch.from_numpy(scal.astype(np.float64)), n_inner).numpy()
    assert row.shape == (16,)
    _check_row(row, out_j)


@pytest.mark.parametrize("n_inner", [1, 4])
def test_fused_gn_batched_ref_matches_vmapped_jax_kernel(n_inner):
    # three streams of different geometry and kernel widths: they converge
    # after different iteration counts
    ins = [_kernel_inputs(kind, kth) for kind, kth in zip(KINDS, (0.5, 0.3, 0.7))]
    q, qm, cand, scal = (np.stack(x) for x in zip(*ins))
    f = jicp._fused_gn_vmappable(n_inner, True)
    out_j = jax.vmap(f)(jnp.asarray(q.reshape(3, 3, N // 128, 128)),
                        jnp.asarray(qm.reshape(3, N // 128, 128)),
                        jnp.asarray(cand.reshape(3, 3, -1, N // 128, 128)), jnp.asarray(scal))
    rows = tgn.fused_gn_batched_ref(torch.from_numpy(q), torch.from_numpy(qm),
                                    torch.from_numpy(cand),
                                    torch.from_numpy(scal.astype(np.float64)), n_inner).numpy()
    assert rows.shape == (3, 16)
    for s in range(3):
        _check_row(rows[s], [np.asarray(x)[s] for x in out_j])
    # each stream of K5 is K4 on that stream
    for s in range(3):
        one = tgn.fused_gn_ref(*(torch.from_numpy(np.ascontiguousarray(x[s]))
                                 for x in (q, qm, cand)),
                               torch.from_numpy(scal[s].astype(np.float64)), n_inner).numpy()
        np.testing.assert_allclose(rows[s], one, rtol=0, atol=1e-12)


def test_batched_at_one_stream_equals_single():
    q, qm, cand, scal = (torch.from_numpy(np.ascontiguousarray(x))
                         for x in _kernel_inputs("near", 0.5))
    scal = scal.double()
    one = tgn.fused_gn(q, qm, cand, scal, 4)
    batched = tgn.fused_gn_batched(q[None], qm[None], cand[None], scal[None], 4)
    assert batched.shape == (1, 16)
    torch.testing.assert_close(batched[0], one, rtol=0, atol=1e-12)


def test_wrappers_take_plain_version_on_cpu():
    q, qm, cand, scal = (torch.from_numpy(np.ascontiguousarray(x))
                         for x in _kernel_inputs("near", 0.5))
    scal = scal.double()
    before = dict(_common.LAUNCHES)
    row = tgn.fused_gn(q, qm, cand, scal, 4)
    torch.testing.assert_close(row, tgn.fused_gn_ref(q, qm, cand, scal, 4), rtol=0, atol=0)
    rows = tgn.fused_gn_batched(q[None], qm[None], cand[None], scal[None], 4)
    torch.testing.assert_close(rows, tgn.fused_gn_batched_ref(q[None], qm[None], cand[None],
                                                              scal[None], 4), rtol=0, atol=0)
    assert _common.LAUNCHES == before
    with pytest.raises(TypeError):
        tgn.fused_gn(q, qm, cand, scal.float(), 4)
    with pytest.raises(ValueError):
        tgn.fused_gn_batched(q[None], qm[None], cand[None], scal, 4)
    with pytest.raises(ValueError):
        tgn.fused_gn_batched(q, qm, cand, scal, 4)


def _stacked_maps():
    mjs = [_case(kind)[0] for kind in KINDS]
    mj = jax.tree.map(lambda *x: jnp.stack(x), *mjs)
    mt = tvm.VoxelMap(*(torch.from_numpy(np.stack(x)) for x in zip(*mjs)))
    return mj, mt


@pytest.mark.parametrize("n_inner", [2, 4])
def test_unrolled_registration_matches_vmapped_jax(n_inner):
    mj, mt = _stacked_maps()
    srcs, guesses = zip(*(_case(kind)[1:] for kind in KINDS))
    src, guess = np.stack(srcs), np.stack(guesses)
    sigma = np.array([0.5, 0.45, 0.6])

    def one(m, p, g, s):
        return jicp.icp_registration_fused_unrolled(
            jvm.VoxelMap(*m), p, jnp.ones(N, bool), g, 3.0 * s, s / 3.0, JCFG, 3, n_inner,
            1e-4)

    rj = jax.jit(jax.vmap(one))(mj, jnp.asarray(src), jnp.asarray(guess), jnp.asarray(sigma))
    sig = torch.from_numpy(sigma)
    rt = ticp.icp_registration_fused_unrolled(
        mt, torch.from_numpy(src), torch.ones(3, N, dtype=torch.bool), torch.from_numpy(guess),
        3.0 * sig, sig / 3.0, TCFG, 3, n_inner, 1e-4)
    assert rt.pose.shape == (3, 4, 4)
    assert np.abs(rt.pose.numpy() - np.asarray(rj.pose)).max() < 1e-3
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert np.abs(rt.num_correspondences.numpy() - np.asarray(rj.num_correspondences)).max() <= 1
    # one stream alone (kernel K4's path) gives that stream's batched answer
    r0 = ticp.icp_registration_fused_unrolled(
        tvm.VoxelMap(*(t[1] for t in mt)), torch.from_numpy(src[1]),
        torch.ones(N, dtype=torch.bool), torch.from_numpy(guess[1]), 3.0 * sig[1], sig[1] / 3.0,
        TCFG, 3, n_inner, 1e-4)
    torch.testing.assert_close(r0.pose, rt.pose[1], rtol=0, atol=1e-12)


def test_unrolled_empty_map_returns_guess():
    mt = tvm.create(TCFG, "cpu", streams=2)
    guess = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    guess[1, 0, 3] = 2.5
    r = ticp.icp_registration_fused_unrolled(
        mt, torch.zeros(2, 128, 3), torch.ones(2, 128, dtype=torch.bool), guess,
        torch.full((2,), 1.5, dtype=torch.float64), torch.full((2,), 0.5, dtype=torch.float64),
        TCFG, 2, 4, 1e-4)
    torch.testing.assert_close(r.pose, guess, rtol=0, atol=0)
    assert not r.converged.any()


@pytest.mark.parametrize("outer", [0, 2])
def test_registration_dispatch_pallas_branches(outer):
    """Both pallas branches of registration_dispatch against JAX's: the
    fused loop (outer 0) and the fixed unroll (outer 2, inner 4); then the
    xla branch of the same schedule."""
    mj, src, guess = _case("near")
    kw = dict(gn_backend="pallas", batch_unroll_outer=outer, batch_unroll_inner=4,
              max_iterations=30, estimation_threshold=1e-5)
    rj = jicp.registration_dispatch(jvm.VoxelMap(*mj), jnp.asarray(src), jnp.ones(N, bool),
                                    jnp.asarray(guess), jnp.float64(0.5), JCFG, JIcpConfig(**kw))
    rt = ticp.registration_dispatch(tvm.VoxelMap(*(torch.from_numpy(np.array(a)) for a in mj)),
                                    torch.from_numpy(src), torch.ones(N, dtype=torch.bool),
                                    torch.from_numpy(guess), torch.tensor(0.5, dtype=torch.float64),
                                    TCFG, IcpConfig(**kw))
    assert rt.pose.shape == (4, 4)
    assert np.abs(rt.pose.numpy() - np.asarray(rj.pose)).max() < 1e-3
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    # the same config with gn_backend="xla" runs the f64 loops (while loop or
    # unroll), held to JAX as tests/test_torch_classic.py holds them
    kx = dict(kw, gn_backend="xla")
    rj = jicp.registration_dispatch(jvm.VoxelMap(*mj), jnp.asarray(src), jnp.ones(N, bool),
                                    jnp.asarray(guess), jnp.float64(0.5), JCFG, JIcpConfig(**kx))
    rt = ticp.registration_dispatch(tvm.VoxelMap(*(torch.from_numpy(np.array(a)) for a in mj)),
                                    torch.from_numpy(src), torch.ones(N, dtype=torch.bool),
                                    torch.from_numpy(guess), torch.tensor(0.5, dtype=torch.float64),
                                    TCFG, IcpConfig(**kx))
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=1e-9)

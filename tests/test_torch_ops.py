"""The port's lie / stats / preprocess / deskew against the JAX package's,
same seeded inputs.

Tolerances: lie f64 maths ~1e-12 (same formulas, different evaluation
order); stats and the preprocess `Scan` fields exactly equal (same f64 /
f32 operations, same sort keys); the rotation-model time and the f32
deskew to float noise (f32 transcendentals differ by an ulp between XLA
and PyTorch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.ops import deskew as jdeskew
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu.ops import preprocess as jpre
from lidar_imu_slam_tpu.ops import stats as jstats
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.ops import deskew as tdeskew
from lidar_imu_slam_tpu_torch.ops import lie as tlie
from lidar_imu_slam_tpu_torch.ops import preprocess as tpre
from lidar_imu_slam_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)


def _twists(seed, n=16, scale_t=3.0, scale_r=1.0):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(size=(n, 3)) * scale_t,
                         rng.normal(size=(n, 3)) * scale_r], axis=1)
    xi[0, 3:] = 0.0  # identity rotation branch
    xi[1, 3:] = 1e-8  # Taylor branch
    return xi


class TestLie:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_exp_log(self, seed):
        xi = _twists(seed)
        T_j = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        T_t = tlie.se3_exp(torch.from_numpy(xi)).numpy()
        np.testing.assert_allclose(T_t, T_j, atol=1e-12)
        np.testing.assert_allclose(tlie.so3_exp(torch.from_numpy(xi[:, 3:])).numpy(),
                                   np.asarray(jlie.so3_exp(jnp.asarray(xi[:, 3:]))),
                                   atol=1e-12)
        np.testing.assert_allclose(tlie.se3_log(torch.from_numpy(T_j)).numpy(),
                                   np.asarray(jlie.se3_log(jnp.asarray(T_j))), atol=1e-10)
        np.testing.assert_allclose(tlie.so3_log(torch.from_numpy(T_j[:, :3, :3])).numpy(),
                                   np.asarray(jlie.so3_log(jnp.asarray(T_j[:, :3, :3]))),
                                   atol=1e-12)

    def test_compose_inverse_make(self):
        A = np.asarray(jlie.se3_exp(jnp.asarray(_twists(2))))
        B = np.asarray(jlie.se3_exp(jnp.asarray(_twists(3))))
        np.testing.assert_allclose(
            tlie.compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
            np.asarray(jlie.compose(jnp.asarray(A), jnp.asarray(B))), atol=1e-12)
        np.testing.assert_allclose(
            tlie.transform_inverse(torch.from_numpy(A)).numpy(),
            np.asarray(jlie.transform_inverse(jnp.asarray(A))), atol=1e-12)
        np.testing.assert_array_equal(
            tlie.make_transform(torch.from_numpy(A[:, :3, :3]), torch.from_numpy(A[:, :3, 3])).numpy(),
            np.asarray(jlie.make_transform(jnp.asarray(A[:, :3, :3]), jnp.asarray(A[:, :3, 3]))))
        np.testing.assert_allclose(
            tlie.delta_pose(torch.from_numpy(A[2]), torch.from_numpy(B[2])).numpy(),
            np.asarray(jlie.delta_pose(jnp.asarray(A[2]), jnp.asarray(B[2]))), atol=1e-10)

    def test_rotate_points_f32(self):
        rng = np.random.default_rng(4)
        R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3))))
        p = rng.uniform(-80, 80, (1000, 3)).astype(np.float32)
        got = tlie.rotate_points(torch.from_numpy(R), torch.from_numpy(p)).numpy()
        ref = np.asarray(jlie.rotate_points(jnp.asarray(R), jnp.asarray(p)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


class TestStats:
    @pytest.mark.parametrize("n_valid", [1, 2, 3, 7, 50, 51])
    def test_masked_iqr_equal(self, n_valid):
        rng = np.random.default_rng(n_valid)
        v = rng.exponential(10.0, 64)
        mask = np.zeros(64, bool)
        mask[rng.choice(64, n_valid, replace=False)] = True
        j = [np.asarray(a) for a in jstats.masked_iqr(jnp.asarray(v), jnp.asarray(mask))]
        t = [a.numpy() for a in tstats.masked_iqr(torch.from_numpy(v), torch.from_numpy(mask))]
        np.testing.assert_array_equal(np.stack(t), np.stack(j))
        np.testing.assert_array_equal(
            tstats.iqr_inlier_mask(torch.from_numpy(v), torch.from_numpy(mask)).numpy(),
            np.asarray(jstats.iqr_inlier_mask(jnp.asarray(v), jnp.asarray(mask))))


def _raw(seed, n=900, cap=1024, with_time=True, nan=True):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    if nan:
        xyz[5] = np.nan
    ring = rng.integers(0, 16, n)
    time = (2.0 + rng.uniform(0, 0.1, n)) if with_time else None
    return dict(xyz=xyz, time=time, ring=ring, stamp=2.0, max_points=cap)


def _lidar_cfgs(sort_by_time, time_source):
    kw = dict(max_range=30.0, min_range=1.0, max_points=1024,
              sort_by_time=sort_by_time, time_source=time_source)
    return jcfg.LidarConfig(**kw), tcfg.LidarConfig(**kw)


class TestPreprocess:
    @pytest.mark.parametrize("sort_by_time", [True, False])
    @pytest.mark.parametrize("time_source", ["per_point", "auto"])
    def test_scan_fields_equal(self, sort_by_time, time_source):
        jc, tc = _lidar_cfgs(sort_by_time, time_source)
        kw = _raw(0)
        sj = jpre.preprocess_scan(jpre.pack_raw_scan(**kw), jc)
        st = tpre.preprocess_scan(tpre.pack_raw_scan(**kw, device="cpu"), tc)
        for f in jpre.Scan._fields:
            a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)

    @pytest.mark.parametrize("sort_by_time", [True, False])
    def test_rotation_model(self, sort_by_time):
        jc, tc = _lidar_cfgs(sort_by_time, "rotation_model")
        kw = _raw(1, with_time=False)
        sj = jpre.preprocess_scan(jpre.pack_raw_scan(**kw), jc)
        st = tpre.preprocess_scan(tpre.pack_raw_scan(**kw, device="cpu"), tc)
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
        np.testing.assert_allclose(st.rel_t.numpy(), np.asarray(sj.rel_t), atol=1e-7)
        np.testing.assert_allclose(st.tau.numpy(), np.asarray(sj.tau), atol=1e-5)
        np.testing.assert_allclose(st.xyz.numpy(), np.asarray(sj.xyz), atol=0)
        np.testing.assert_allclose(st.t_end.numpy(), np.asarray(sj.t_end), atol=1e-7)
        relt = tpre.rotation_model_rel_time(
            torch.from_numpy(kw["xyz"]), torch.from_numpy(kw["ring"].astype(np.int32)),
            torch.ones(900, dtype=torch.bool), tc)
        relj = jpre.rotation_model_rel_time(
            jnp.asarray(kw["xyz"]), jnp.asarray(kw["ring"].astype(np.int32)),
            jnp.ones(900, bool), jc)
        np.testing.assert_allclose(relt.numpy(), np.asarray(relj), atol=1e-7)

    @pytest.mark.parametrize("sort_by_time", [True, False])
    def test_auto_without_time_is_rotation_model(self, sort_by_time):
        # (held against the port's own rotation model: inside the JAX
        # package's lax.cond the fused atan2 can differ by an ulp from the
        # gathered first-point azimuth, which wraps that point to a full
        # period — a JAX-side artefact, not a semantic difference)
        _, t_auto = _lidar_cfgs(sort_by_time, "auto")
        _, t_rot = _lidar_cfgs(sort_by_time, "rotation_model")
        kw = _raw(1, with_time=False)
        a = tpre.preprocess_scan(tpre.pack_raw_scan(**kw, device="cpu"), t_auto)
        b = tpre.preprocess_scan(tpre.pack_raw_scan(**kw, device="cpu"), t_rot)
        for f in tpre.Scan._fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())

    def test_pack_raw_scan_equal(self):
        kw = _raw(2)
        rj, rt = jpre.pack_raw_scan(**kw), tpre.pack_raw_scan(**kw, device="cpu")
        for f in jpre.RawScan._fields:
            a, b = np.asarray(getattr(rj, f)), getattr(rt, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a)


class TestDeskew:
    @pytest.mark.parametrize("zero", [False, True])
    def test_deskew_from_scalars(self, zero):
        rng = np.random.default_rng(5)
        p = rng.uniform(-50, 50, (2000, 3)).astype(np.float32)
        tau = rng.uniform(0, 1, 2000).astype(np.float32)
        w = rng.normal(size=3) * 0.02
        v = rng.normal(size=3) * 0.5
        wn = np.linalg.norm(w)
        sc = np.concatenate([[wn], w / wn, v, np.cross(w, v), np.cross(w, np.cross(w, v))])
        if zero:
            sc = np.zeros(13)
        got = tdeskew.deskew_from_scalars(torch.from_numpy(p), torch.from_numpy(tau),
                                          torch.from_numpy(sc)).numpy()
        ref = np.asarray(jdeskew.deskew_from_scalars(jnp.asarray(p), jnp.asarray(tau),
                                                     jnp.asarray(sc.astype(np.float32))))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=2e-5)
        if zero:
            np.testing.assert_array_equal(got, p)

"""Pose bookkeeping kernels K2 / K3: the port's plain versions
(`pose_pre_ref`, `pose_post_ref`) against the JAX Pallas kernels
(`pose_pre`, `pose_post`, interpret mode on the CPU) on seeded f64 states.
JAX is fed the float-float (hi, lo) split of the f64 state and its outputs
are recombined.

Tolerances: rotation entries 2e-6 and translations 1e-6 m + 1e-7 |t| (the
JAX kernels carry f32 rotations and float-float translations); flags and
counts equal (seeds stay off the gate boundaries); sigma and the threshold
sum rtol 3e-4 (the JAX kernel's model_deviation input is f32, which floors
the small-angle model error at ~1e-4 relative — its own test holds it to
the same bar); deskew twist pieces 1e-5.

The kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py holds them against these plain versions
there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu.ops.pallas import pose_chain as jpc
from lidar_imu_slam_tpu_torch.ops.kernels import _common
from lidar_imu_slam_tpu_torch.ops.kernels import pose_chain as tpc

torch.set_num_threads(1)

KW = dict(min_motion_th=0.1, initial_threshold=2.0, max_range=30.0)


def _rand_pose(rng, scale_t=5.0, scale_r=0.3):
    xi = np.concatenate([rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r])
    return np.array(jlie.se3_exp(jnp.asarray(xi)))


def _split(x):
    x = jnp.asarray(x, jnp.float64)
    hi = x.astype(jnp.float32)
    return hi, (x - hi.astype(jnp.float64)).astype(jnp.float32)


def _state(seed, num_poses, far=0.0):
    rng = np.random.default_rng(seed)
    prev = _rand_pose(rng)
    prev[:3, 3] += far
    pose = prev @ _rand_pose(rng, 0.3, 0.05)
    first = _rand_pose(rng)
    md = _rand_pose(rng, 0.05, 0.01)
    return dict(pose=pose, pose_prev=prev, first_pose=first, sse=1.234, md=md,
                num_poses=num_poses, thr_n=7)


def _port_args(s, device="cpu"):
    def t(a, dtype=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return (t(s["pose"]), t(s["pose_prev"]), t(s["first_pose"]), t(s["sse"]), t(s["md"]),
            t(s["num_poses"], torch.int32), t(s["thr_n"], torch.int32))


def _tol_t(t):
    return 1e-6 + 1e-7 * np.abs(t)


@pytest.mark.parametrize("deskew_on", [True, False])
@pytest.mark.parametrize("num_poses,far", [(0, 0.0), (1, 0.0), (2, 0.0), (5, 0.0),
                                           (5, 1500.0)])
def test_pose_pre_matches_jax(num_poses, far, deskew_on):
    s = _state(10 + num_poses, num_poses, far)
    vec = np.concatenate([s["pose"].reshape(16), s["pose_prev"].reshape(16),
                          s["first_pose"].reshape(16), [s["sse"]]])
    hi, lo = _split(vec)
    rj = np.asarray(jpc.pose_pre(
        hi, lo, jnp.asarray(s["md"].reshape(16), jnp.float32),
        jnp.asarray([num_poses, s["thr_n"]], jnp.int32), deskew_on=deskew_on, **KW),
        np.float64)
    rt = tpc.pose_pre_ref(*_port_args(s), deskew_on=deskew_on, **KW).numpy()
    assert rt.shape == (tpc.PRE_WIDTH,)
    np.testing.assert_allclose(rt[0:9], rj[0:9], atol=2e-6)
    t_j = rj[9:12] + rj[12:15]
    assert np.all(np.abs(rt[9:12] - t_j) <= _tol_t(t_j))
    assert rt[13] == rj[16]  # moved
    assert rt[15] == rj[18]  # threshold sample count
    np.testing.assert_allclose(rt[12], rj[15], rtol=3e-4)  # sigma
    np.testing.assert_allclose(rt[14], rj[17] + rj[32], rtol=3e-4)  # sse
    np.testing.assert_allclose(rt[16:29], rj[19:32], atol=1e-5)  # deskew twist
    if not deskew_on or num_poses <= 2:
        np.testing.assert_array_equal(rt[16:32], 0.0)


def _post_inputs(seed, diverge):
    rng = np.random.default_rng(4 + seed)
    guess = _rand_pose(rng)
    guess[:3, 3] += 800.0 * seed
    corr = _rand_pose(rng, 20.0 if diverge else 0.05, 0.0005)
    return corr, guess


@pytest.mark.parametrize("diverge", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pose_post_matches_jax(seed, diverge):
    corr, guess = _post_inputs(seed, diverge)
    ch, cl = _split(corr[:3, 3])
    gh, gl = _split(guess[:3, 3])
    a = jnp.concatenate([jnp.asarray(corr[:3, :3].reshape(9), jnp.float32), ch, cl,
                         jnp.asarray(guess[:3, :3].reshape(9), jnp.float32), gh, gl])
    rj = np.asarray(jpc.pose_post(a, max_model_deviation=10.0), np.float64)
    ct = torch.from_numpy(np.concatenate([corr[:3, :3].reshape(9), corr[:3, 3]]))
    gt = torch.from_numpy(np.concatenate([guess[:3, :3].reshape(9), guess[:3, 3]]))
    rt = tpc.pose_post_ref(ct, gt, max_model_deviation=10.0).numpy()
    assert rt.shape == (tpc.POST_WIDTH,)
    assert rt[12] == rj[15] == float(diverge)
    np.testing.assert_allclose(rt[0:9], rj[0:9], atol=2e-6)
    t_j = rj[9:12] + rj[12:15]
    assert np.all(np.abs(rt[9:12] - t_j) <= _tol_t(t_j))
    np.testing.assert_allclose(rt[13:22], rj[16:25], atol=2e-6)  # delta R
    assert np.all(np.abs(rt[22:25] - rj[25:28]) <= _tol_t(t_j))  # delta t
    md_t, md_j = rt[25:41].reshape(4, 4), rj[28:44].reshape(4, 4)
    np.testing.assert_allclose(md_t[:3, :3], md_j[:3, :3], atol=2e-6)
    # model deviation: f32 rotations of the JAX kernel act on km-scale
    # translations, so it inherits the translation bar of the pose
    assert np.all(np.abs(md_t[:3, 3] - md_j[:3, 3]) <= _tol_t(np.abs(t_j).max()))
    np.testing.assert_array_equal(md_t[3], [0, 0, 0, 1])
    # the output rotation is orthonormal to f64 noise after the Newton step
    R = rt[0:9].reshape(3, 3)
    assert np.abs(R.T @ R - np.eye(3)).max() < 1e-12


def test_wrappers_take_plain_version_on_cpu():
    s = _state(3, 5)
    before = dict(_common.LAUNCHES)
    row = tpc.pose_pre(*_port_args(s), deskew_on=True, **KW)
    np.testing.assert_array_equal(row.numpy(), tpc.pose_pre_ref(
        *_port_args(s), deskew_on=True, **KW).numpy())
    post = tpc.pose_post(row.clone(), row, max_model_deviation=10.0)
    np.testing.assert_array_equal(post.numpy(), tpc.pose_post_ref(
        row.clone(), row, max_model_deviation=10.0).numpy())
    assert _common.LAUNCHES == before  # no kernel launched on the CPU


def test_wrappers_check_arguments():
    args = list(_port_args(_state(3, 5)))
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        tpc.pose_pre(*args, deskew_on=True, **KW)
    with pytest.raises(ValueError):
        tpc.pose_post(torch.zeros(5, dtype=torch.float64), torch.zeros(32, dtype=torch.float64),
                      max_model_deviation=1.0)

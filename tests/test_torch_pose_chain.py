"""Pose bookkeeping kernels K2 / K3: the port's plain versions
(`pose_pre_ref`, `pose_post_ref`) against the JAX Pallas kernels
(`pose_pre`, `pose_post`, interpret mode on the CPU) on seeded f64 states,
and the next state the fast step builds from their outputs
(`kiss_icp.fast_state`) against the JAX step's bookkeeping and, bit for
bit, against the tensor ops it replaces. JAX is fed the float-float
(hi, lo) split of the f64 state and its outputs are recombined.

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

from lidar_imu_slam_tpu.models import kiss_icp as jkiss
from lidar_imu_slam_tpu.ops import lie as jlie
from lidar_imu_slam_tpu.ops.pallas import pose_chain as jpc
from lidar_imu_slam_tpu_torch.models import kiss_icp as tkiss
from lidar_imu_slam_tpu_torch.ops import lie as tlie
from lidar_imu_slam_tpu_torch.ops.icp import ThresholdState
from lidar_imu_slam_tpu_torch.ops.kernels import _common
from lidar_imu_slam_tpu_torch.ops.kernels import pose_chain as tpc
from lidar_imu_slam_tpu_torch.tools import pose_chain_cases as pcases

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
    rt = tpc.pose_pre_ref(*_port_args(s), deskew_on=deskew_on, **KW).row.numpy()
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
    eye = torch.eye(4, dtype=torch.float64)
    rt = tpc.pose_post_ref(ct, gt, eye, eye, torch.tensor(5, dtype=torch.int32),
                           max_model_deviation=10.0).row.numpy()
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
    args = _port_args(s)
    before = dict(_common.LAUNCHES)
    pre = tpc.pose_pre(*args, deskew_on=True, **KW)
    for a, b in zip(pre, tpc.pose_pre_ref(*args, deskew_on=True, **KW)):
        assert torch.equal(a, b)
    post_args = (pre.row.clone(), pre.row, args[0], args[2], args[5])
    post = tpc.pose_post(*post_args, max_model_deviation=10.0)
    for a, b in zip(post, tpc.pose_post_ref(*post_args, max_model_deviation=10.0)):
        assert torch.equal(a, b)
    assert _common.LAUNCHES == before  # no kernel launched on the CPU


def test_wrappers_check_arguments():
    args = list(_port_args(_state(3, 5)))
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        tpc.pose_pre(*args, deskew_on=True, **KW)
    eye = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        tpc.pose_post(torch.zeros(5, dtype=torch.float64), torch.zeros(32, dtype=torch.float64),
                      eye, eye, torch.tensor(1, dtype=torch.int32), max_model_deviation=1.0)


def _jax_state(s):
    """The JAX fast step's inputs of state `s`: pose_pre's float-float split
    vector, its f32 model deviation and its counters."""
    vec = np.concatenate([s["pose"].reshape(16), s["pose_prev"].reshape(16),
                          s["first_pose"].reshape(16), [s["sse"]]])
    hi, lo = _split(vec)
    return hi, lo, jnp.asarray(s["md"].reshape(16), jnp.float32), jnp.asarray(
        [s["num_poses"], s["thr_n"]], jnp.int32)


@pytest.mark.parametrize("diverge", [False, True])
@pytest.mark.parametrize("num_poses", [0, 1, 5])
def test_fast_state_matches_jax_bookkeeping(num_poses, diverge):
    """K2 -> K3 -> the next KissState: the port's plain versions and
    `kiss_icp.fast_state` against the JAX fast step's bookkeeping
    (`fast_pose_from_prow`, `fast_threshold_state` and the KissState of
    JAX kiss_icp.py:409-420), with the pose_pre row as the guess and a
    seeded correction (30 m past the 10 m gate when diverging)."""
    s = _state(20 + num_poses, num_poses)
    corr = _rand_pose(np.random.default_rng(30 + num_poses), 0.05, 0.0005)
    if diverge:
        corr[:3, 3] += 30.0
    # JAX: the fused pre / post kernels and the step's recombination
    hi, lo, md32, counters = _jax_state(s)
    rj = jpc.pose_pre(hi, lo, md32, counters, deskew_on=True, **KW)
    ch, cl = _split(corr[:3, 3])
    prow_j = jpc.pose_post(jnp.concatenate([
        jnp.asarray(corr[:3, :3].reshape(9), jnp.float32), ch, cl, rj[0:9], rj[9:12],
        rj[12:15]]), max_model_deviation=10.0)
    pose_j = np.asarray(jkiss.fast_pose_from_prow(prow_j))
    thr_j = jkiss.fast_threshold_state(rj, prow_j)
    first = num_poses == 0
    prev_j = pose_j if first else s["pose"]
    first_j = pose_j if first else s["first_pose"]
    # the port: K2's plain version, K3's on its row, the shared helper
    args = _port_args(s)
    pre = tpc.pose_pre(*args, deskew_on=True, **KW)
    post = tpc.pose_post(torch.from_numpy(np.concatenate([corr[:3, :3].reshape(9),
                                                          corr[:3, 3]])),
                         pre.row, args[0], args[2], args[5], max_model_deviation=10.0)
    st = tkiss.fast_state(None, pre, post)
    assert float(post.row[12]) == float(np.asarray(prow_j)[15]) == float(diverge)
    for got, want in ((st.pose, pose_j), (st.pose_prev, prev_j), (st.first_pose, first_j)):
        got = got.numpy()
        np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=2e-6)
        assert np.all(np.abs(got[:3, 3] - want[:3, 3]) <= _tol_t(want[:3, 3]))
        np.testing.assert_array_equal(got[3], [0, 0, 0, 1])
    assert int(st.num_poses) == num_poses + 1
    assert int(st.threshold.num_samples) == int(thr_j.num_samples)
    np.testing.assert_allclose(float(st.threshold.model_error_sq),
                               float(thr_j.model_error_sq), rtol=3e-4)
    md_t, md_j = st.threshold.model_deviation.numpy(), np.asarray(thr_j.model_deviation)
    np.testing.assert_allclose(md_t[:3, :3], md_j[:3, :3], atol=2e-6)
    assert np.all(np.abs(md_t[:3, 3] - md_j[:3, 3]) <= _tol_t(np.abs(prev_j[:3, 3]).max()))
    np.testing.assert_array_equal(md_t[3], [0, 0, 0, 1])


@pytest.mark.parametrize("case", pcases.CASES)
def test_fast_state_equals_the_op_sequence(case):
    """The shared helper's state (`kiss_icp.fast_state` on the plain K2 /
    K3 outputs) equals, bit for bit, the state the fast step built with
    tensor ops after the kernels before they wrote it: `make_transform` of
    the row, the accumulators cloned and cast from the pose_pre row, the
    first-scan selects and the count; and the f32 map delta equals the
    row's delta cast as `rotate_points` cast it."""
    a, kw, corr = pcases.case(case)
    pre = tpc.pose_pre(*a, **kw)
    post = tpc.pose_post(*pcases.post_args(a, corr, pre.row),
                         max_model_deviation=pcases.MAX_MODEL_DEVIATION)
    st = tkiss.fast_state("map", pre, post)
    row, prow, num_poses = pre.row, post.row, a[5]
    new_pose = tlie.make_transform(prow[0:9].reshape(3, 3), prow[9:12])
    first = num_poses == 0
    want = tkiss.KissState(
        map="map", pose=new_pose,
        pose_prev=torch.where(first, new_pose, a[0]),
        first_pose=torch.where(first, new_pose, a[2]),
        num_poses=num_poses + 1,
        threshold=ThresholdState(row[14].clone(), row[15].to(torch.int32),
                                 prow[25:41].reshape(4, 4).clone()))
    assert st.map == "map"
    for name in ("pose", "pose_prev", "first_pose", "num_poses"):
        got, exp = getattr(st, name), getattr(want, name)
        assert got.dtype == exp.dtype and got.shape == exp.shape and torch.equal(got, exp), name
    for got, exp in zip(st.threshold, want.threshold):
        assert got.dtype == exp.dtype and got.shape == exp.shape and torch.equal(got, exp)
    assert torch.equal(post.delta_R, prow[13:22].reshape(3, 3).to(torch.float32))
    assert torch.equal(post.delta_t, prow[22:25].to(torch.float32))
    assert pcases.delta_is_own_rounding(post)

"""The port's quaternion helpers (`ops/lie.py`), IMU initialization
(`ops/imu.py`) and EKF (`models/ekf.py`) against the JAX package's, on the
CPU, from the same numpy inputs.

Tolerances (all f64 unless stated):
* quaternion helpers and the IMU running statistics: 1e-14 absolute
  (the same formulas; only libm's last bits differ);
* EKF mean `m`: 1e-10 absolute; covariance `P`: 1e-10 relative to its
  largest entry (matmul summation order, and the log-depth scans in place
  of `lax.associative_scan`, reorder rounding at ~1e-15);
* deskewed points (f32): 1e-5 m (f32 per-point arithmetic, exact sin /
  cos in place of the JAX polynomial);
* the port's batched predict / deskew against its own sequential ones: the
  bars of tests/test_ekf_batched.py (m 1e-9, P 1e-7, points 1e-5, trail
  end state 1e-10);
* Kalman updates on a matrix that is not positive definite: NaN
  everywhere, in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu.models import ekf as je
from lidar_imu_slam_tpu.ops import imu as jimu
from lidar_imu_slam_tpu.ops import lie as jl
from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch import interop
from lidar_imu_slam_tpu_torch.models import ekf as te
from lidar_imu_slam_tpu_torch.ops import imu as timu
from lidar_imu_slam_tpu_torch.ops import lie as tl

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=1e-14):
    np.testing.assert_allclose(_n(b), np.asarray(a), rtol=0, atol=atol)


def _cfgs(trail=4, **kw):
    return jcfg.EkfConfig(lidar_pose_trail=trail, **kw), tcfg.EkfConfig(lidar_pose_trail=trail, **kw)


def _assert_states(js, ts, atol_m=1e-10, rtol_P=1e-10):
    np.testing.assert_allclose(_n(ts.m), np.asarray(js.m), rtol=0, atol=atol_m)
    P = np.asarray(js.P)
    scale = max(np.abs(P).max(), 1e-300)
    np.testing.assert_allclose(_n(ts.P) / scale, P / scale, rtol=0, atol=rtol_P)
    for f in je.EkfState._fields[2:]:
        np.testing.assert_allclose(_n(getattr(ts, f)).astype(np.float64),
                                   np.asarray(getattr(js, f)).astype(np.float64),
                                   rtol=0, atol=1e-12, err_msg=f)


def _rand_state(cfg, seed, **over):
    """A generic (non-fresh) JAX state and the same state in the port."""
    rng = np.random.default_rng(seed)
    s = je.init(cfg)
    d = cfg.state_dim
    m = np.asarray(s.m).copy()
    m[je.POS:je.POS + 3] = rng.normal(0, 2.0, 3)
    m[je.VEL:je.VEL + 3] = rng.normal(0, 1.0, 3)
    q = rng.normal(0, 1, 4)
    m[je.ORI:je.ORI + 4] = q / np.linalg.norm(q)
    m[je.BGA:je.BGA + 3] = rng.normal(0, 0.01, 3)
    m[je.BAA:je.BAA + 3] = rng.normal(0, 0.05, 3)
    m[je.INNER:] = rng.normal(0, 1.0, d - je.INNER)
    a = rng.normal(0, 0.1, (d, d))
    P = a @ a.T + np.eye(d) * 1e-3
    fields = dict(m=m, P=P, first_sample=False, prev_sample_t=0.99, first_sample_t=0.0,
                  time=0.7)
    fields.update(over)
    js = s._replace(**{k: jnp.asarray(v, getattr(s, k).dtype) for k, v in fields.items()})
    return js, _port_state(js)


def _port_state(js):
    return te.EkfState(*(_t(x) for x in js))


def _packet(seed, cap=12, n_valid=12, t0=1.0, dup_at=None):
    rng = np.random.default_rng(seed)
    t = t0 + np.arange(cap) * 0.01
    if dup_at is not None:
        t[dup_at] = t[dup_at - 1]
    gyro = rng.normal(0, 0.3, (cap, 3))
    acc = rng.normal([0, 0, 9.81], 0.4, (cap, 3))
    mask = np.arange(cap) < n_valid
    jp = je.ImuPacket(jnp.asarray(t), jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(mask))
    return jp, interop.imu_packet_from_numpy(jp, "cpu")


def _extrinsics(js, ts):
    return ((js.m[je.PIL:je.PIL + 3], jl.quat_to_rot(js.m[je.RIL:je.RIL + 4])),
            (ts.m[te.PIL:te.PIL + 3], tl.quat_to_rot(ts.m[te.RIL:te.RIL + 4])))


# ---------------------------------------------------------------------------
# quaternion helpers
# ---------------------------------------------------------------------------


def test_quaternion_helpers_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 4))
    q[0] = 0.0  # a zero quaternion stays zero under normalization
    _close(jl.quat_conj(jnp.asarray(q)), tl.quat_conj(_t(q)))
    _close(jl.quat_normalize(jnp.asarray(q)), tl.quat_normalize(_t(q)))
    qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    _close(jl.dquat_to_rot(jnp.asarray(qn)), tl.dquat_to_rot(_t(qn)))
    _close(jl.quat_to_rot(jnp.asarray(qn)), tl.quat_to_rot(_t(qn)))


@pytest.mark.parametrize("case", ["random", "parallel", "antiparallel", "antiparallel_x"])
def test_quat_from_two_vectors_matches(case):
    rng = np.random.default_rng(1)
    a = rng.normal(size=3)
    b = {"random": rng.normal(size=3), "parallel": 2.5 * a, "antiparallel": -0.5 * a}.get(case)
    if case == "antiparallel_x":
        a, b = np.array([3.0, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])
    _close(jl.quat_from_two_vectors(jnp.asarray(a), jnp.asarray(b)),
           tl.quat_from_two_vectors(_t(a), _t(b)))


@pytest.mark.parametrize("scale", [0.0, 1e-8, 0.3, 4.0])
def test_quat_propagator_matches(scale):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(5, 3)) * scale
    dt = np.array([0.01, 0.0, -0.02, 0.5, 0.005])
    _close(jl.quat_propagator(jnp.asarray(w), jnp.asarray(dt)),
           tl.quat_propagator(_t(w), _t(dt)))
    _close(jl.quat_propagator(jnp.asarray(w[3]), 0.01), tl.quat_propagator(_t(w[3]), 0.01))
    # orthogonal: A^T A = I
    A = tl.quat_propagator(_t(w), _t(dt))
    _close(np.broadcast_to(np.eye(4), (5, 4, 4)), A.transpose(-1, -2) @ A, atol=1e-14)


# ---------------------------------------------------------------------------
# IMU static initialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coordinate", ["ned", "enu"])
def test_remap_axes_matches(coordinate):
    acc = np.random.default_rng(3).normal(size=(7, 3))
    _close(jimu.remap_axes(jnp.asarray(acc), coordinate), timu.remap_axes(_t(acc), coordinate),
           atol=0)


def test_imu_accumulate_matches_across_completion():
    cfg_j, cfg_t = jcfg.ImuConfig(max_init_count=25), tcfg.ImuConfig(max_init_count=25)
    rng = np.random.default_rng(4)
    sj, st = jimu.init_state(), timu.init_state("cpu")
    for k in range(5):  # 11-sample packets with a masked tail; done after packet 3
        gyro = rng.normal(0, 0.01, (11, 3))
        acc = rng.normal([0.1, -0.2, 9.8], 0.05, (11, 3))
        mask = np.arange(11) < (11 - k)
        sj = jimu.accumulate(sj, jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(mask), cfg_j)
        st = timu.accumulate(st, _t(gyro), _t(acc), _t(mask), cfg_t)
        for f in jimu.ImuInitState._fields:
            _close(getattr(sj, f), getattr(st, f), atol=1e-15)
    assert bool(st.done) and int(st.count) == 30  # the packet that crosses 25 is consumed whole
    _close(jimu.gravity_estimate(sj), timu.gravity_estimate(st), atol=1e-14)


# ---------------------------------------------------------------------------
# EKF: initialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trail", [2, 20])
def test_init_matches(trail):
    cj, ct = _cfgs(trail)
    _assert_states(je.init(cj), te.init(ct, "cpu"), atol_m=0, rtol_P=0)


def test_initialize_gravity_alignment_matches():
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 5)
    ma = np.array([0.3, -0.2, 9.7])
    _assert_states(je.initialize_gravity_alignment(js, jnp.asarray(ma), cj),
                   te.initialize_gravity_alignment(ts, _t(ma), ct))


@pytest.mark.parametrize("speed", [3.0, 0.01])
@pytest.mark.parametrize("window", [None, 1.5, 0.5])
def test_initialize_from_odometry_matches(speed, window):
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 6)
    rng = np.random.default_rng(6)
    ma = np.array([0.3, -0.2, 9.7])
    T_wi = np.asarray(jl.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6))))
    vel = np.array([1.0, 0.2, 0.0]) * speed
    kw_j, kw_t = {}, {}
    if window is not None:
        acc = np.array([0.2, 0.1, 0.0])
        kw_j = dict(accel_world=jnp.asarray(acc), window_time=jnp.float64(window))
        kw_t = dict(accel_world=_t(acc), window_time=torch.tensor(window, dtype=F64))
    _assert_states(
        je.initialize_from_odometry(js, jnp.asarray(ma), jnp.asarray(T_wi), jnp.asarray(vel),
                                    cj, **kw_j),
        te.initialize_from_odometry(ts, _t(ma), _t(T_wi), _t(vel), ct, **kw_t))


# ---------------------------------------------------------------------------
# EKF: predict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["step", "first_sample", "skip"])
def test_predict_and_predict_mean_match(case):
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 7)
    if case == "first_sample":
        js = js._replace(first_sample=jnp.asarray(True))
        ts = _port_state(js)
    t = {"step": 1.004, "first_sample": 1.004, "skip": 0.98}[case]
    rng = np.random.default_rng(7)
    g, a = rng.normal(0, 0.3, 3), rng.normal([0, 0, 9.81], 0.4, 3)
    (jt, jR), (tt, tR) = _extrinsics(js, ts)
    grav_j, grav_t = js.m[je.GRAV_I:je.GRAV_I + 3], ts.m[te.GRAV_I:te.GRAV_I + 3]
    for fj, ft in ((je.predict, te.predict), (je.predict_mean, te.predict_mean)):
        out_j = fj(js, jnp.float64(t), jnp.asarray(g), jnp.asarray(a), grav_j, jt, jR, cj)
        out_t = ft(ts, torch.tensor(t, dtype=F64), _t(g), _t(a), grav_t, tt, tR, ct)
        _assert_states(out_j, out_t)
        if case != "step":  # dt <= 0: m and P unchanged
            assert torch.equal(out_t.m, ts.m) and torch.equal(out_t.P, ts.P)


PACKETS = {
    "full": dict(),
    "masked_tail": dict(n_valid=7),
    "duplicate": dict(dup_at=5),
    "all_masked": dict(n_valid=0),
}


@pytest.mark.parametrize("packet", sorted(PACKETS))
@pytest.mark.parametrize("batched", [False, True])
def test_predict_over_packet_matches(packet, batched):
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 8)
    jp, tp = _packet(8, **PACKETS[packet])
    (jt, jR), (tt, tR) = _extrinsics(js, ts)
    fj = je.predict_over_packet_batched if batched else je.predict_over_packet
    ft = te.predict_over_packet_batched if batched else te.predict_over_packet
    _assert_states(fj(js, jp, jt, jR, cj), ft(ts, tp, tt, tR, ct))


@pytest.mark.parametrize("packet", sorted(PACKETS))
@pytest.mark.parametrize("first_sample", [False, True])
def test_batched_predict_matches_own_sequential(packet, first_sample):
    _, ct = _cfgs()
    js, ts = _rand_state(_cfgs()[0], 9, first_sample=first_sample)
    _, tp = _packet(9, **PACKETS[packet])
    tt, tR = ts.m[te.PIL:te.PIL + 3], tl.quat_to_rot(ts.m[te.RIL:te.RIL + 4])
    seq = te.predict_over_packet(ts, tp, tt, tR, ct)
    bat = te.predict_over_packet_batched(ts, tp, tt, tR, ct)
    torch.testing.assert_close(bat.m, seq.m, rtol=0, atol=1e-9)
    torch.testing.assert_close(bat.P, seq.P, rtol=0, atol=1e-7)
    for f in ("time", "first_sample_t", "prev_sample_t", "first_sample"):
        assert float(getattr(bat, f)) == pytest.approx(float(getattr(seq, f)), abs=1e-12)


def test_batched_predict_ignores_nonfinite_padding():
    # masked samples are zeroed before they enter: inf padding changes nothing
    _, ct = _cfgs()
    _, ts = _rand_state(_cfgs()[0], 10)
    _, tp = _packet(10, n_valid=7)
    bad = tp._replace(gyro=torch.where(tp.mask[:, None], tp.gyro, float("inf")),
                      acc=torch.where(tp.mask[:, None], tp.acc, float("nan")))
    tt, tR = ts.m[te.PIL:te.PIL + 3], tl.quat_to_rot(ts.m[te.RIL:te.RIL + 4])
    a = te.predict_over_packet_batched(ts, tp, tt, tR, ct)
    b = te.predict_over_packet_batched(ts, bad, tt, tR, ct)
    assert torch.equal(a.m, b.m) and torch.equal(a.P, b.P)


# ---------------------------------------------------------------------------
# EKF: updates and the trail
# ---------------------------------------------------------------------------


def test_kalman_update_matches_and_nan_when_not_positive_definite():
    rng = np.random.default_rng(11)
    d = 12
    a = rng.normal(size=(d, d))
    P = a @ a.T + np.eye(d)
    m = rng.normal(size=d)
    H = rng.normal(size=(3, 8))
    y = rng.normal(size=3)
    Rn = np.eye(3) * 0.01
    mj, Pj = je.kalman_update(jnp.asarray(m), jnp.asarray(P), jnp.asarray(y), jnp.asarray(H),
                              jnp.asarray(Rn))
    mt, Pt = te.kalman_update(_t(m), _t(P), _t(y), _t(H), _t(Rn))
    _close(mj, mt, atol=1e-10)
    _close(Pj, Pt, atol=1e-10)
    # an innovation covariance that is not positive definite
    mj, Pj = je.kalman_update(jnp.asarray(m), jnp.asarray(-P), jnp.asarray(y), jnp.asarray(H),
                              jnp.asarray(Rn))
    mt, Pt = te.kalman_update(_t(m), _t(-P), _t(y), _t(H), _t(Rn))
    for j, t in ((mj, mt), (Pj, Pt)):
        assert np.isnan(np.asarray(j)).all() and bool(torch.isnan(t).all())


def test_nan_on_the_branch_not_taken_does_not_leak():
    # a moving filter whose ZUPT innovation is not positive definite: the
    # stationary side turns NaN, the selected side stays finite
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 12)
    P = ts.P.clone()
    P[te.VEL:te.VEL + 3, te.VEL:te.VEL + 3] = -1e6 * torch.eye(3, dtype=F64)
    out = te.update_and_propagate(ts._replace(P=P, zupt_time=torch.tensor(-5.0, dtype=F64)), ct)
    assert bool(torch.isfinite(out.m).all())


@pytest.mark.parametrize("gate", [True, False])
def test_zero_vel_update_matches(gate):
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 13, zupt_time=(-1.0 if gate else 0.6))
    _assert_states(je.zero_vel_update(js, cj), te.zero_vel_update(ts, ct))


@pytest.mark.parametrize("trail", [2, 4])
def test_trail_augmentation_matches(trail):
    cj, ct = _cfgs(trail)
    js, ts = _rand_state(cj, 14, augment_count=1)
    _assert_states(je.update_visual_pose_aug(js, cj), te.update_visual_pose_aug(ts, ct))
    _assert_states(je.update_undo_augmentation(js, cj), te.update_undo_augmentation(ts, ct))
    _assert_states(je.normalize_quaternions(js, cj), te.normalize_quaternions(ts, ct))


@pytest.mark.parametrize("stationary", [False, True])
def test_update_and_propagate_matches(stationary):
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 15, zupt_time=-1.0)
    if stationary:
        js = js._replace(m=js.m.at[je.VEL:je.VEL + 3].set(1e-5))
        ts = _port_state(js)
    _assert_states(je.update_and_propagate(js, cj), te.update_and_propagate(ts, ct))


def test_lidar_pose_update_and_accessors_match():
    cj, ct = _cfgs()
    js, ts = _rand_state(cj, 16)
    rng = np.random.default_rng(16)
    for k in range(2):  # the second measurement flips the quaternion sign
        pose = np.array(jl.se3_exp(jnp.asarray(rng.normal(0, 0.8, 6))))
        if k:
            pose[:3, :3] = np.asarray(jl.quat_to_rot(-js.m[je.ORI:je.ORI + 4])).T
        _assert_states(je.lidar_pose_update(js, jnp.asarray(pose), 0.02, 0.005, cj),
                       te.lidar_pose_update(ts, _t(pose), 0.02, 0.005, ct))
    _close(je.pose_matrix(js), te.pose_matrix(ts))
    _close(je.speed(js), te.speed(ts))


# ---------------------------------------------------------------------------
# EKF: IMU motion compensation
# ---------------------------------------------------------------------------


def _deskew_inputs(seed, last_end, mask_tail):
    rng = np.random.default_rng(seed)
    n = 12
    t = np.sort(rng.uniform(1.0, 1.1, n))
    gyro = rng.normal(0, 0.4, (n, 3))
    acc = rng.normal([0, 0, 9.8], 0.3, (n, 3))
    mask = np.ones(n, bool)
    if mask_tail:
        mask[-mask_tail:] = False
    pts = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    rel = np.sort(rng.uniform(0, 0.1, 512))
    pmask = np.ones(512, bool)
    pmask[::7] = False
    return (t, gyro, acc, mask), pts, rel, pmask


def _deskew_both(batched, seed, last_end, mask_tail, port_only=False):
    cj, ct = _cfgs(2, batched_deskew=batched)
    js, ts = _rand_state(cj, seed, last_lidar_end_time=last_end)
    pk, pts, rel, pmask = _deskew_inputs(seed, last_end, mask_tail)
    tp = te.ImuPacket(*(_t(x) for x in pk))
    t_out = te.motion_compensation_with_imu(ts, tp, _t(pts), _t(rel), _t(pmask),
                                            torch.tensor(9.8, dtype=F64),
                                            torch.tensor(1.0, dtype=F64), ct)
    if port_only:
        return t_out
    jp = je.ImuPacket(*(jnp.asarray(x) for x in pk))
    j_out = je.motion_compensation_with_imu(js, jp, jnp.asarray(pts), jnp.asarray(rel),
                                            jnp.asarray(pmask), jnp.float64(9.8),
                                            jnp.float64(1.0), cj)
    return j_out, t_out


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("last_end,mask_tail", [(0.0, 0), (1.03, 3)])
def test_motion_compensation_matches(batched, last_end, mask_tail):
    (sj, dj, gj), (st, dt, gt) = _deskew_both(batched, 17, last_end, mask_tail)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    for k in ("vel_end", "pos_end", "rot_end"):
        _close(gj[k], gt[k], atol=1e-10)
    assert int(gj["n_pairs"]) == int(gt["n_pairs"])
    _close(sj.last_lidar_end_time, st.last_lidar_end_time, atol=1e-12)


@pytest.mark.parametrize("last_end,mask_tail", [(0.0, 0), (1.03, 3)])
def test_batched_deskew_matches_own_sequential(last_end, mask_tail):
    _, d_seq, g_seq = _deskew_both(False, 18, last_end, mask_tail, port_only=True)
    _, d_bat, g_bat = _deskew_both(True, 18, last_end, mask_tail, port_only=True)
    torch.testing.assert_close(d_bat, d_seq, rtol=0, atol=1e-5)
    for k, tol in (("vel_end", 1e-10), ("pos_end", 1e-10), ("rot_end", 1e-12)):
        torch.testing.assert_close(g_bat[k], g_seq[k], rtol=0, atol=tol)


def test_batched_deskew_ignores_nonfinite_padding():
    ct = _cfgs(2)[1]
    _, ts = _rand_state(_cfgs(2)[0], 19)
    pk, pts, rel, pmask = _deskew_inputs(19, 0.0, 4)
    good = te.ImuPacket(*(_t(x) for x in pk))
    bad = good._replace(gyro=torch.where(good.mask[:, None], good.gyro, float("inf")))
    args = (_t(pts), _t(rel), _t(pmask), torch.tensor(9.8, dtype=F64),
            torch.tensor(1.0, dtype=F64), ct)
    _, a, _ = te.motion_compensation_with_imu(ts, good, *args)
    _, b, _ = te.motion_compensation_with_imu(ts, bad, *args)
    assert bool(torch.isfinite(b).all()) and torch.equal(a, b)

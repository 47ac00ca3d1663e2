"""Plain PyTorch reference of the LiDAR-inertial step, written from the
configuration's stated semantics (the `pipeline` dict of a configuration
file: its `ekf`, `imu` and registration groups). It imports nothing of the
port and takes nothing the port made beyond what the comparison feeds it:
the port's registration guesses and poses, which it follows (as
`reference/odometry.py` follows the port's poses).

State per stream, f64 (`filter_dtype`; the control runs f32): the 30-dim
inner state [pos 3 | vel 3 | quat 4 (w, x, y, z), world->body | gyro bias
3 | acc bias 3 | acc scale 3 | gravity 3 | imu-lidar translation 3 | quat
4 | time shift 1] and a trail of `lidar_pose_trail` 7-dim poses, its
covariance, the IMU static initialization and the constant-velocity
history. One call of `RefLio.step` takes one scan of each of B streams:

1. the IMU packet with the previous packet's last sample in front
   (reference ekf.cpp:295);
2. static initialization while it is open: the running mean and variance
   of acc and gyro over `max_init_count` samples (imu/frame.cpp:94-118);
3. a stream initialized before this scan: the EKF predict walked sample by
   sample (EKF::predict, ekf.cpp:214-290): quaternion propagator
   exp(S(w)(-dt/2)), mean propagation (ekf.cpp:486-519), Jacobians
   (ekf.cpp:521-578), P's inner block and cross strips (ekf.cpp:284-289),
   the current quaternions renormalized after each sample, masked samples
   and dt <= 0 leaving m and P as they are; the mean held to scan end on
   the last sample; the IMU pose trail walked pair by pair (ekf.cpp:315-
   391) and every point undistorted to scan end in f64 (ekf.cpp:420-456),
   then cast to f32; the registration guess is the filter pose composed
   with the imu-lidar transform;
   An initializing stream's scan is deskewed at constant velocity from
   the third scan on where the configuration deskews (`icp.deskew`), as
   `reference/odometry.py` does, and its guess is the constant-velocity
   one;
4. registration (`reference/odometry.RefOdometry`'s downsample, source,
   threshold, fixed-unroll ICP, gate and map update) of those points from
   the port's guess, carrying the port's pose;
5. a stream initialized before this scan: the pose measurement (the
   port's registered pose) y = [t; q] with H selecting position and
   orientation, then ZUPT when the speed is under its threshold (rate
   limited) with the trail's newest pose dropped, then the trail
   augmentation with a Joseph-form update (ekf.cpp:680-734); while
   initializing, the odometry velocity history and, on the scan that
   completes the initialization, the filter seeded from the odometry.

Departures, from the C++ reference (PARITY.md numbering) and from the JAX
module, all shared with the port:
* #6 the analytic dR/dq in place of the perturbation "derivative";
* #8 the dead covariance propagation inside motion compensation is left
  out; #13 the trail's velocity update rotates body->world;
* #9 the pose measurement update, which the reference never runs;
* #26-#28 the filter seeded in motion from the odometry, the scan-end
  extrapolation and the seed refinements; #27 d(vel)/d(grav) = dt I;
* the quirks the port keeps: the gyro bias decays at `gyro_process_noise`
  and the gravity block starts at the lidar-imu time noise (ekf.cpp:595);
* against the JAX module and the port: the predict walks each sample
  (PARITY #19 is the port's composed form), the trail walks each pair, the
  per-point undistortion and the point's interval search run in f64 (#15
  is the port's f32), the innovation solves are LU solves, and the
  registration is `reference/odometry.py`'s.
"""

from __future__ import annotations

import math

import torch

from .odometry import (F32, F64, RefOdometry, _where4, deskew, downsample, inverse, iqr_fence,
                       orthonormalize, quat, quat_to_rot, rotate, rt, se3_log, source_points)

GRAVITY = 9.81
INNER, POSE = 30, 7
POS, VEL, ORI, BGA, BAA, BAT, GRAV, PIL, RIL, SFT = 0, 3, 6, 10, 13, 16, 19, 22, 25, 29
VEL_RING = 8


def scan_times(time, stamp, mask):
    """(rel_t (B, N) f64 from the first valid point, t_begin (B,), t_end
    (B,)) of stamped scans (their per-point times)."""
    rel = time - stamp[:, None]
    t0 = torch.amin(torch.where(mask, rel, torch.full_like(rel, math.inf)), -1)
    t0 = torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))
    rel = torch.where(mask, rel - t0[:, None], torch.zeros_like(rel))
    t_begin = stamp + t0
    return rel, t_begin, t_begin + torch.amax(rel, -1)


def _smat(w):
    """The 4x4 S(w) of ekf.cpp:471-484."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack([torch.stack([z, -w0, -w1, -w2], -1), torch.stack([w0, z, -w2, w1], -1),
                        torch.stack([w1, w2, z, -w0], -1), torch.stack([w2, -w1, w0, z], -1)],
                       -2)


def propagator(w, dt):
    """exp(S(w) (-dt / 2)) = cos(|w| dt / 2) I - sin(|w| dt / 2) / |w| S(w)."""
    n = torch.linalg.norm(w, dim=-1)
    h = 0.5 * dt
    small = n * h < 1e-8
    c = torch.cos(n * h)
    s = torch.where(small, h * (1 - (n * h) ** 2 / 6),
                    torch.sin(n * h) / torch.where(small, 1.0, n))
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    return c[..., None, None] * eye - s[..., None, None] * _smat(w)


def _unit(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _dquat(q):
    """dR(q)/dq_i, (..., 4, 3, 3), of `quat_to_rot`."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    o = torch.zeros_like(w)

    def m(r):
        return torch.stack([torch.stack(row, -1) for row in r], -2)

    return torch.stack([
        m([[o, -2 * z, 2 * y], [2 * z, o, -2 * x], [-2 * y, 2 * x, o]]),
        m([[o, 2 * y, 2 * z], [2 * y, -4 * x, -2 * w], [2 * z, 2 * w, -4 * x]]),
        m([[-4 * y, 2 * x, 2 * w], [2 * x, o, 2 * z], [-2 * w, 2 * z, -4 * y]]),
        m([[-4 * z, -2 * w, 2 * x], [2 * w, -4 * z, 2 * y], [2 * x, 2 * y, o]]),
    ], -3)


def _from_two(a, b):
    """The quaternion rotating a onto b (not antiparallel)."""
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = torch.sum(a * b, -1)
    axis = torch.linalg.cross(a, b, dim=-1)
    n = torch.linalg.norm(axis, dim=-1)
    s = torch.sqrt(torch.clamp(0.5 * (1 - c), min=0.0)) / torch.where(n < 1e-12, 1.0, n)
    return _unit(torch.cat([torch.sqrt(torch.clamp(0.5 * (1 + c), min=0.0))[..., None],
                            axis * s[..., None]], -1))


def _col(x):
    return x[..., None]


class _Odometry(RefOdometry):
    """`RefOdometry` registering given points from a given guess."""

    def register_at(self, pts, smask, guess, forced=None):
        """The reference's registration of points (B, N, 3) f32 from `guess`
        (B, 4, 4), carrying `forced` (default its own pose) into its state
        and map. Returns (own pose, sigma)."""
        pd, vs = self.pd, self.mapc["voxel_size"]
        guess = guess.to(pd)
        rel = inverse(self.first_pose) @ self.pose
        moved = (self.num_poses > 0) & (torch.linalg.norm(rel[:, :3, 3], dim=-1)
                                        > 5.0 * self.icp["min_motion_th"])
        sigma = self._sigma(moved)
        tg = guess[:, :3, 3].to(F32)
        world = rotate(guess[:, :3, :3], pts) + tg[:, None, :]
        g_pts, g_kept, g_vox, g_rank = downsample(world, smask, vs, self.icp["max_map_points"])
        src, src_kept = source_points(g_pts, g_kept, vs, self.icp["max_source_points"])
        src_kept = iqr_fence(torch.sum((src - tg[:, None, :]) ** 2, -1).to(F64), src_kept)
        T_icp, empty = self._icp(src, src_kept, sigma)
        pose_icp = _where4(empty, guess, T_icp @ guess)
        dev_ = inverse(guess) @ pose_icp
        diverged = torch.linalg.norm(dev_[:, :3, 3], dim=-1) > self.icp["max_model_deviation"]
        own = orthonormalize(_where4(diverged, guess, pose_icp))
        if forced is None:
            pose = own
            self.model_dev = _where4(diverged, torch.eye(4, dtype=pd, device=self.dev), dev_)
        else:
            pose = forced.to(pd)
            self.model_dev = inverse(guess) @ pose
        delta = pose @ inverse(guess)
        self.map.insert(rotate(delta[:, :3, :3], g_pts) + delta[:, None, :3, 3].to(F32), g_kept,
                        g_vox, g_rank)
        if self.mapc["auto_evict"]:
            self.map.evict(pose[:, :3, 3], vs, self.mapc["max_range"])
        first = self.num_poses == 0
        self.pose_prev = _where4(first, pose, self.pose)
        self.first_pose = _where4(first, pose, self.first_pose)
        self.pose = pose
        self.num_poses = self.num_poses + 1
        return own, sigma


class RefLio:
    def __init__(self, pipeline: dict, b: int, grid: dict, device, filter_dtype=F64):
        self.ekf, self.imu = pipeline["ekf"], pipeline["imu"]
        if self.imu["coordinate"] != "ned":
            raise ValueError("the reference reads NED accelerations (no axis remap)")
        self.odo = _Odometry(pipeline, b, grid, device)
        self.fd, self.dev, self.b = filter_dtype, device, b
        e = self.ekf
        self.trail = int(e["lidar_pose_trail"])
        self.d = d = INNER + POSE * self.trail
        self.ns = e["noise_scale"] ** 2
        fd = filter_dtype
        m = torch.zeros(d, dtype=fd)
        m[ORI] = m[RIL] = 1.0
        m[BAT:BAT + 3] = 1.0
        m[GRAV + 2] = -GRAVITY
        diag = torch.zeros(d, dtype=F64)
        diag[POS:POS + 3] = e["init_pos_noise"] ** 2
        diag[VEL:VEL + 3] = e["init_vel_noise"] ** 2
        diag[ORI:ORI + 4] = 1.0
        diag[BGA:BGA + 3] = e["init_bga_noise"] ** 2
        diag[BAA:BAA + 3] = e["init_baa_noise"] ** 2
        diag[BAT:BAT + 3] = e["init_bat_noise"] ** 2
        diag[GRAV:GRAV + 3] = e["init_lidar_imu_time_noise"] ** 2  # ekf.cpp:595's quirk
        diag[PIL:PIL + 3] = e["init_pos_noise"] ** 2
        diag[RIL:RIL + 4] = 1.0
        diag[SFT] = e["init_lidar_imu_time_noise"] ** 2
        for i in range(self.trail):
            j = INNER + POSE * i
            diag[j:j + 3] = e["init_pos_trail_noise"] ** 2
            diag[j + 3:j + POSE] = e["init_ori_trail_noise"] ** 2
        self.m = m.to(device).expand(b, d).clone()
        self.P = torch.diag(diag * self.ns).to(fd).to(device).expand(b, d, d).clone()
        self.c = self._constants()

        def full(v, dtype=F64):
            return torch.full((b,), v, dtype=dtype, device=device)

        self.time, self.first_t, self.prev_t = full(0.0), full(0.0), full(-1.0)
        self.first_sample = full(True, torch.bool)
        self.zupt_time, self.augments = full(-1.0), full(0, torch.int64)
        self.lle = full(0.0)
        self.count = full(0, torch.int64)
        self.mean_acc = torch.zeros((b, 3), dtype=F64, device=device)
        self.mean_gyro = torch.zeros_like(self.mean_acc)
        self.done = full(False, torch.bool)
        self.last_imu = torch.zeros((b, 7), dtype=F64, device=device)
        self.ring = torch.zeros((b, VEL_RING, 3), dtype=F64, device=device)
        self.ring_n = full(0, torch.int64)
        self.init_v0, self.init_t0 = torch.zeros((b, 3), dtype=F64, device=device), full(-1.0)
        self.guess = None  # the last step's registration guess

    def _constants(self) -> dict:
        """The constant matrices of the updates and the trail shifts, built
        once on the host and moved to the device."""
        e, d, ns = self.ekf, self.d, self.ns
        c = {"H_pose": torch.zeros((POSE, d), dtype=F64),
             "H_zupt": torch.zeros((3, d), dtype=F64),
             "H_aug": torch.zeros((POSE, d), dtype=F64),
             "up": torch.zeros((d, d), dtype=F64), "down": torch.zeros((d, d), dtype=F64)}
        c["H_pose"][0:3, POS:POS + 3] = torch.eye(3, dtype=F64)
        c["H_pose"][3:7, ORI:ORI + 4] = torch.eye(4, dtype=F64)
        c["H_zupt"][:, VEL:VEL + 3] = torch.eye(3, dtype=F64)
        c["H_aug"][:] = c["H_pose"]
        c["H_aug"][:, INNER:INNER + POSE] = -torch.eye(POSE, dtype=F64)
        c["R_pose"] = torch.diag(torch.tensor([e["lidar_pos_noise"] ** 2] * 3
                                              + [e["lidar_ori_noise"] ** 2] * 4, dtype=F64)) * ns
        c["R_zupt"] = torch.eye(3, dtype=F64) * e["visual_zupt_r"] * ns
        c["R_aug"] = torch.eye(POSE, dtype=F64) * 1e-9 * ns
        q = torch.zeros(d, dtype=F64)
        q[INNER:INNER + 3] = e["init_pos_trail_noise"] ** 2 * ns
        q[INNER + 3:INNER + POSE] = e["init_ori_trail_noise"] ** 2 * ns
        c["Q_aug"] = torch.diag(q)
        # the trail moved one slot newer (up: the newest pose dropped) or
        # older (down: the oldest dropped, the newest slot cleared)
        for name, step in (("up", POSE), ("down", -POSE)):
            c[name][:INNER, :INNER] = torch.eye(INNER, dtype=F64)
            for i in range(INNER, d):
                if INNER <= i + step < d:
                    c[name][i, i + step] = 1.0
        c["eye_d"] = torch.eye(d, dtype=F64)
        c["eye_inner"] = torch.eye(INNER, dtype=F64)
        c["dS"] = torch.stack([_smat(torch.eye(3, dtype=F64)[g]) for g in range(3)])
        c["ori_block"] = torch.diag(torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=F64))
        c["conj"] = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=F64)
        out = {k: v.to(self.fd).to(self.dev) for k, v in c.items()}
        out["conj"] = out["conj"].to(F64)
        return out

    # -- helpers ----------------------------------------------------------
    def _renorm(self, m, trail=False):
        m = m.clone()
        m[:, ORI:ORI + 4] = _unit(m[:, ORI:ORI + 4])
        m[:, RIL:RIL + 4] = _unit(m[:, RIL:RIL + 4])
        if trail:
            t = m[:, INNER:].reshape(self.b, self.trail, POSE)
            n = torch.linalg.norm(t[..., 3:], dim=-1, keepdim=True)
            t[..., 3:] = torch.where(n > 1e-12, t[..., 3:] / torch.where(n > 1e-12, n, 1.0),
                                     t[..., 3:])
            m[:, INNER:] = t.reshape(self.b, -1)
        return m

    def _kalman(self, m, P, y, H, Rn):
        """Kalman update with y = H m + noise: (m', P', K)."""
        HP = H @ P
        S = HP @ H.transpose(-1, -2) + Rn
        K = torch.linalg.solve(S, HP).transpose(-1, -2)
        return m + (K @ _col(y - (H @ _col(m))[..., 0]))[..., 0], P - K @ HP, K

    # -- IMU --------------------------------------------------------------
    def _accumulate(self, gyro, acc, mask):
        for i in range(mask.shape[1]):
            take = mask[:, i] & ~self.done
            n = (self.count + 1).to(F64)[:, None]
            ma = self.mean_acc + (acc[:, i] - self.mean_acc) / n
            mg = self.mean_gyro + (gyro[:, i] - self.mean_gyro) / n
            self.count = torch.where(take, self.count + 1, self.count)
            self.mean_acc = torch.where(take[:, None], ma, self.mean_acc)
            self.mean_gyro = torch.where(take[:, None], mg, self.mean_gyro)
        return self.count >= self.imu["max_init_count"]

    def _mean_step(self, m, dt, xg, xa, grav, t_il, q_il):
        """Mean propagation over dt; returns (m', A, R, T_ab, previous quat)."""
        e = self.ekf
        A = propagator(xg - m[:, BGA:BGA + 3], dt)
        q_prev = m[:, ORI:ORI + 4]
        q = (A @ _col(q_prev))[..., 0]
        R = quat_to_rot(q)
        T_ab = m[:, BAT:BAT + 3] * xa - m[:, BAA:BAA + 3]
        dtc = dt[:, None]
        g_rate = e["gyro_process_noise"]  # the bias decays at the noise (quirk kept)
        a_rate = e["acc_process_noise_rev"]
        m2 = torch.cat([
            m[:, POS:POS + 3] + m[:, VEL:VEL + 3] * dtc,
            m[:, VEL:VEL + 3] + ((R.transpose(-1, -2) @ _col(T_ab))[..., 0] + m[:, GRAV:GRAV + 3])
            * dtc,
            q,
            m[:, BGA:BGA + 3] * (torch.exp(-dtc * g_rate) if g_rate > 0 else 1.0),
            m[:, BAA:BAA + 3] * (torch.exp(-dtc * a_rate) if a_rate > 0 else 1.0),
            m[:, BAT:BAT + 3], grav, t_il, q_il, m[:, SFT:]], -1)
        return m2, A, R, q, T_ab, q_prev

    def _predict_sample(self, t, xg, xa, ok, grav, t_il, q_il):
        """EKF::predict for one sample of each stream (masked streams keep
        everything)."""
        e, fd, b = self.ekf, self.fd, self.b
        dt = torch.where(self.first_sample, torch.zeros_like(t), t - self.prev_t)
        new_time = torch.where(self.first_sample, self.time, t - self.first_t)
        new_first_t = torch.where(self.first_sample, t, self.first_t)
        m, P = self.m, self.P
        dtf = dt.to(fd)
        m2, A, R, q, T_ab, q_prev = self._mean_step(m, dtf, xg.to(fd), xa.to(fd), grav, t_il,
                                                    q_il)
        # Jacobians (ekf.cpp:521-578, with d(vel)/d(grav) = dt I, PARITY #27)
        eye3 = self.c["eye_inner"][:3, :3].expand(b, 3, 3)
        dtm = dtf[:, None, None]
        Fx = self.c["eye_inner"].expand(b, INNER, INNER).clone()
        Fw = torch.zeros((b, INNER, 12), dtype=fd, device=self.dev)
        Fx[:, POS:POS + 3, VEL:VEL + 3] = eye3 * dtm
        Fx[:, VEL:VEL + 3, GRAV:GRAV + 3] = eye3 * dtm
        RT = R.transpose(-1, -2)
        dv_dq = torch.einsum("bqji,bj->biq", _dquat(q), T_ab) * dtm @ A
        Fx[:, VEL:VEL + 3, ORI:ORI + 4] = dv_dq
        Fx[:, ORI:ORI + 4, ORI:ORI + 4] = A
        Fw[:, VEL:VEL + 3, 0:3] = RT * dtm
        # d(quat)/d(gyro noise): A (dS_g dt / 2) q_prev, dS_g = d S(w) / d w_g
        dq_dw = torch.einsum("bac,gcd,bd->bag", A, self.c["dS"], q_prev) * (-0.5 * dtm)
        Fw[:, ORI:ORI + 4, 3:6] = dq_dw
        Fw[:, BGA:BGA + 3, 6:9] = eye3
        Fw[:, BAA:BAA + 3, 9:12] = eye3
        dv_dw = dv_dq @ dq_dw
        Fw[:, VEL:VEL + 3, 3:6] = dv_dw
        Fx[:, VEL:VEL + 3, BGA:BGA + 3] = -dv_dw
        Fx[:, ORI:ORI + 4, BGA:BGA + 3] = -dq_dw
        Fx[:, VEL:VEL + 3, BAA:BAA + 3] = -RT * dtm
        Fx[:, VEL:VEL + 3, BAT:BAT + 3] = RT * xa.to(fd)[:, None, :] * dtm
        # process noise with Ornstein-Uhlenbeck bias terms (ekf.cpp:112-116, 244-263)
        acc2, gyro2 = e["acc_process_noise"] ** 2, e["gyro_process_noise"] ** 2

        def ou(qc, theta, on):
            if not on:
                return torch.zeros_like(dtf)
            if theta > 0:
                return qc * (1 - torch.exp(-2 * dtf * theta)) / (2 * theta)
            return torch.full_like(dtf, qc)

        qd = torch.stack([torch.full_like(dtf, acc2)] * 3 + [torch.full_like(dtf, gyro2)] * 3
                         + [ou(gyro2, e["gyro_process_noise_rev"], e["gyro_process_noise"] > 0)] * 3
                         + [ou(acc2, e["acc_process_noise_rev"], e["acc_process_noise"] > 0)] * 3,
                         -1) * self.ns
        P2 = P.clone()
        P2[:, :INNER, :INNER] = (Fx @ P[:, :INNER, :INNER] @ Fx.transpose(-1, -2)
                                 + (Fw * qd[:, None, :]) @ Fw.transpose(-1, -2))
        P2[:, INNER:, :INNER] = P[:, INNER:, :INNER] @ Fx.transpose(-1, -2)
        P2[:, :INNER, INNER:] = Fx @ P[:, :INNER, INNER:]
        run = ok & (dt > 0)  # ekf.cpp:235-240: dt <= 0 skips the propagation
        m2 = self._renorm(m2)
        self.m = torch.where(run[:, None], m2, m)
        self.P = torch.where(run[:, None, None], P2, P)
        self.time = torch.where(ok, new_time, self.time)
        self.first_t = torch.where(ok, new_first_t, self.first_t)
        self.prev_t = torch.where(ok, t, self.prev_t)
        self.first_sample = self.first_sample & ~ok

    def _predict_to(self, t, xg, xa, grav, t_il, q_il, run):
        """The mean held on the last sample to time t (scan end)."""
        dt = torch.where(self.first_sample, torch.zeros_like(t), t - self.prev_t)
        m2 = self._mean_step(self.m, dt.to(self.fd), xg.to(self.fd), xa.to(self.fd), grav, t_il,
                             q_il)[0]
        go = run & (dt > 0)
        self.m = torch.where(go[:, None], m2, self.m)
        self.time = torch.where(run, torch.where(self.first_sample, self.time, t - self.first_t),
                                self.time)
        self.first_t = torch.where(run & self.first_sample, t, self.first_t)
        self.prev_t = torch.where(run, t, self.prev_t)
        self.first_sample = self.first_sample & ~run

    def _deskew(self, pts, rel, mask, t_beg, times, gyro, acc, pmask, run):
        """The IMU pose trail and every point moved to scan end, in f64;
        returns f32 points (B, N, 3)."""
        m = self.m.to(F64)
        bga, baa, bat = m[:, BGA:BGA + 3], m[:, BAA:BAA + 3], m[:, BAT:BAT + 3]
        grav, t_il = m[:, GRAV:GRAV + 3], m[:, PIL:PIL + 3]
        man = torch.linalg.norm(self.mean_acc, dim=-1)[:, None]
        lle = self.lle
        pcl_end = t_beg + torch.amax(torch.where(mask, rel, torch.zeros_like(rel)), -1)
        imu_end = torch.amax(torch.where(pmask, times, torch.full_like(times, -math.inf)), -1)
        qc = m[:, ORI:ORI + 4] * self.c["conj"]
        quat_, vel, pos = qc, m[:, VEL:VEL + 3], m[:, POS:POS + 3]
        rows = [(torch.zeros_like(lle), quat_to_rot(qc), torch.zeros_like(vel), pos, vel,
                 torch.zeros_like(vel))]
        n_pairs = torch.zeros_like(self.count)
        last_g, last_a = torch.zeros_like(vel), torch.zeros_like(vel)
        for i in range(times.shape[1] - 1):
            valid = pmask[:, i] & pmask[:, i + 1]
            head, tail = times[:, i], times[:, i + 1]
            ok = valid & (tail >= lle)
            dt = torch.where(ok, torch.where(head < lle, tail - lle, tail - head), 0.0)
            g = 0.5 * (gyro[:, i] + gyro[:, i + 1])
            a = 0.5 * (acc[:, i] + acc[:, i + 1])
            qn = _unit((propagator(g - bga, -dt) @ _col(quat_))[..., 0])
            xa = a / man * GRAVITY
            vn = vel + ((quat_to_rot(qn) @ _col(bat * xa - baa))[..., 0] + grav) * dt[:, None]
            pn = pos + vn * dt[:, None]
            quat_ = torch.where(ok[:, None], qn, quat_)
            vel = torch.where(ok[:, None], vn, vel)
            pos = torch.where(ok[:, None], pn, pos)
            off = torch.where(valid, torch.where(ok, torch.clamp(tail - t_beg, min=0.0), 0.0),
                              math.inf)
            rows.append((off, quat_to_rot(quat_), g, pos, vel, xa))
            n_pairs = n_pairs + valid.to(n_pairs.dtype)
            last_g = torch.where(valid[:, None], g, last_g)
            last_a = torch.where(valid[:, None], xa, last_a)
        dt_end = torch.abs(pcl_end - imu_end)[:, None]
        rot_end = quat_to_rot(_unit((propagator(last_g - bga, -dt_end[:, 0]) @ _col(quat_))
                                    [..., 0]))
        vel_end = vel + ((rot_end @ _col(bat * last_a - baa))[..., 0] + grav) * dt_end
        pos_end = pos + vel_end * dt_end
        ple = (rot_end @ _col(t_il))[..., 0] + pos_end
        off = torch.stack([r[0] for r in rows], 1)  # (B, K)
        k = torch.clamp(torch.searchsorted(off, rel, side="left") - 1, 0, off.shape[1] - 1)

        def pick(j, shape):
            x = torch.stack([r[j] for r in rows], 1).reshape(self.b, off.shape[1], -1)
            return torch.gather(x, 1, k[..., None].expand(k.shape + (x.shape[-1],))).reshape(
                k.shape + shape)

        R_i, g_i, p_i, v_i, a_i = (pick(1, (3, 3)), pick(2, (3,)), pick(3, (3,)), pick(4, (3,)),
                                   pick(5, (3,)))
        dtp = (rel - torch.gather(torch.where(torch.isfinite(off), off, 0.0), 1, k))[..., None]
        w = g_i * dtp
        th = torch.linalg.norm(w, dim=-1, keepdim=True)
        small = th < 1e-6
        ths = torch.where(small, 1.0, th)
        s1 = torch.where(small, 1.0 - th ** 2 / 6, torch.sin(ths) / ths)
        c1 = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)

        def rodrigues(v):
            return (v * torch.cos(th) + torch.linalg.cross(w, v, dim=-1) * s1
                    + w * torch.sum(w * v, -1, keepdim=True) * c1)

        def rot(Rm, v):
            return (Rm @ v[..., None])[..., 0]

        p = pts.to(F64)
        c = (rot(R_i, rodrigues(p)) + rot(R_i, rodrigues(t_il[:, None, :].expand_as(p)))
             + p_i + v_i * dtp + 0.5 * a_i * dtp * dtp - ple[:, None, :])
        out = (rot_end.transpose(-1, -2)[:, None] @ c[..., None])[..., 0].to(F32)
        self.lle = torch.where(run, pcl_end, self.lle)
        return torch.where((mask & run[:, None])[..., None], out, pts)

    def _pose_update(self, T_wi):
        e = self.ekf
        R = T_wi[:, :3, :3].transpose(-1, -2)
        q = quat(R).to(self.fd)
        q = torch.where(torch.sum(q * self.m[:, ORI:ORI + 4], -1, keepdim=True) < 0, -q, q)
        y = torch.cat([T_wi[:, :3, 3].to(self.fd), q], -1)
        m, P, _ = self._kalman(self.m, self.P, y, self.c["H_pose"], self.c["R_pose"])
        return self._renorm(m), 0.5 * (P + P.transpose(-1, -2))

    def _shift(self, m, P, down: bool):
        """The trail moved one slot older (down: the newest slot cleared) or
        newer (the oldest slot cleared): m' = A m, P' = A P A^T."""
        A = self.c["down" if down else "up"]
        return (A @ m[..., None])[..., 0], A @ P @ A.T

    def _after_update(self, m, P):
        """ZUPT + undo when stationary, then the trail augmentation
        (ekf.cpp:657-734)."""
        e = self.ekf
        time = self.time
        still = torch.linalg.norm(m[:, VEL:VEL + 3], dim=-1) < e["zupt_speed_threshold"]
        gate = (time - self.zupt_time) >= e["zupt_min_interval"]
        mz, Pz, _ = self._kalman(m, P, torch.zeros_like(m[:, :3]), self.c["H_zupt"],
                                 self.c["R_zupt"])
        mz = torch.where(gate[:, None], self._renorm(mz), self._renorm(m))
        Pz = torch.where(gate[:, None, None], Pz, P)
        mu, Pu = self._shift(mz, Pz, down=False)
        mu, Pu = self._renorm(mu, trail=True), 0.5 * (Pu + Pu.transpose(-1, -2))
        m = torch.where(still[:, None], mu, m)
        P = torch.where(still[:, None, None], Pu, P)
        self.zupt_time = torch.where(still & gate, time, self.zupt_time)
        self.augments = torch.where(still, torch.clamp(self.augments - 1, min=0), self.augments)
        # augmentation: shift, trail noise on the new slot, pin it to the pose
        m, P = self._shift(m, P, down=True)
        P = P + self.c["Q_aug"]
        Ha, Ra = self.c["H_aug"], self.c["R_aug"]
        m, _, K = self._kalman(m, P, torch.zeros_like(m[:, :POSE]), Ha, Ra)
        IKH = self.c["eye_d"] - K @ Ha
        P = IKH @ P @ IKH.transpose(-1, -2) + K @ Ra @ K.transpose(-1, -2)  # Joseph form
        self.augments = torch.clamp(self.augments + 1, max=self.trail)
        return self._renorm(m, trail=True), 0.5 * (P + P.transpose(-1, -2))

    def _ring_accel(self, dt):
        n = torch.clamp(self.ring_n, max=VEL_RING)
        idx = torch.arange(VEL_RING, dtype=F64, device=self.dev)
        w = (idx >= (VEL_RING - n)[:, None]).to(F64)
        t = idx * dt[:, None]
        tbar = torch.sum(w * t, -1) / torch.clamp(w.sum(-1), min=1.0)
        ct = w * (t - tbar[:, None])
        den = torch.sum(ct * t, -1)
        slope = torch.sum(ct[..., None] * self.ring, 1) / torch.where(den > 0, den, 1.0)[:, None]
        return torch.where(((n >= 3) & (den > 0))[:, None], slope, 0.0)

    def _seed(self, T_wi, vel, accel, window):
        """The filter seeded from the odometry on the scan that completes the
        static initialization (PARITY #26-#28)."""
        e, ns = self.ekf, self.ns
        moving = torch.linalg.norm(vel, dim=-1) > 0.25
        R_wb = T_wi[:, :3, :3]
        up = self.c["H_pose"][2, :3].to(F64).expand_as(vel)  # (0, 0, 1)
        q = torch.where(moving[:, None], quat(R_wb.transpose(-1, -2)), _from_two(up, self.mean_acc))
        mdir = self.mean_acc / torch.linalg.norm(self.mean_acc, dim=-1, keepdim=True)
        g = torch.where(moving[:, None], -(R_wb @ _col(mdir))[..., 0] * GRAVITY, -up * GRAVITY)
        g_est = accel - (R_wb @ _col(self.mean_acc))[..., 0]
        gn = torch.linalg.norm(g_est, dim=-1, keepdim=True)
        g = torch.where(moving[:, None] & (gn > 0.5 * GRAVITY), g_est / torch.clamp(gn, min=1e-9)
                        * GRAVITY, g)
        m = self.m.clone()
        m[:, ORI:ORI + 4] = q.to(self.fd)
        m[:, POS:POS + 3] = T_wi[:, :3, 3].to(self.fd)
        m[:, VEL:VEL + 3] = torch.where(moving[:, None], vel.to(self.fd), m[:, VEL:VEL + 3])
        m[:, GRAV:GRAV + 3] = g.to(self.fd)
        trusted = moving & (window >= 1.0)

        def pick(cond, a, b):  # a where of Python floats would be float32
            return torch.where(cond, torch.full_like(window, a), b)

        ori = pick(trusted, 0.02 ** 2, pick(moving, 0.2 ** 2,
                                           torch.full_like(window, e["init_ori_noise"] ** 2)))
        P = self.P.clone()
        P[:, ORI:ORI + 4, ORI:ORI + 4] = (self.c["ori_block"].to(F64)
                                          * (ori * ns)[:, None, None]).to(self.fd)
        for i in range(3):
            v, gg = VEL + i, GRAV + i
            P[:, v, v] = torch.where(moving, pick(trusted, 0.3 ** 2, torch.ones_like(window)) * ns,
                                     P[:, v, v].to(F64)).to(self.fd)
            P[:, gg, gg] = torch.where(moving, pick(trusted, 1.0, torch.full_like(window, 9.0))
                                       * ns, P[:, gg, gg].to(F64)).to(self.fd)
        return m, P

    # -- one step ---------------------------------------------------------
    def step(self, pts, tau, rel, mask, t_beg, t_end, times, gyro, acc, pmask, guess=None,
             forced=None):
        """One scan of each stream: points (B, N, 3) f32, tau (B, N) f32 in
        [0, 1] and rel (B, N) f64 from the scan's first point, mask (B, N),
        t_beg / t_end (B,), the
        IMU packet (times (B, M), gyro / acc (B, M, 3), pmask (B, M)), the
        registration guess and the registered pose (B, 4, 4) to follow
        (default: its own guess and pose). Returns (own pose, sigma,
        deskewed points, used: the IMU branch)."""
        times = torch.cat([self.last_imu[:, :1], times], 1)
        gyro = torch.cat([self.last_imu[:, None, 1:4], gyro], 1)
        acc = torch.cat([self.last_imu[:, None, 4:7], acc], 1)
        pmask = torch.cat([self.last_imu[:, :1] > 0, pmask], 1)
        used = self.done.clone()
        if not bool(used.all()):
            done = self._accumulate(gyro, acc, pmask)
        else:
            done = used
        just_done = done & ~self.done
        self.done = done

        # IMU branch (the initializing streams' samples masked out): predict,
        # hold to scan end, deskew
        m0 = self.m
        grav = m0[:, GRAV:GRAV + 3]
        t_il, q_il = m0[:, PIL:PIL + 3], _unit(m0[:, RIL:RIL + 4])
        for i in range(times.shape[1]):
            self._predict_sample(times[:, i], gyro[:, i], acc[:, i], pmask[:, i] & used, grav,
                                 t_il, q_il)
        n = torch.clamp(pmask.sum(1) - 1, min=0)
        lg = torch.gather(gyro, 1, n[:, None, None].expand(-1, 1, 3))[:, 0]
        la = torch.gather(acc, 1, n[:, None, None].expand(-1, 1, 3))[:, 0]
        self._predict_to(t_end, lg, la, grav, t_il, q_il, used)
        desk = self._deskew(pts, rel, mask, t_beg, times, gyro, acc, pmask, used)
        o = self.odo
        if o.icp["deskew"]:  # the initializing streams: constant velocity
            v, w = se3_log(inverse(o.pose_prev) @ o.pose)
            cv = deskew(pts, tau, v.to(F32), w.to(F32))
            desk = torch.where((~used & (o.num_poses > 2))[:, None, None], cv, desk)

        T_il = rt(quat_to_rot(self.m[:, RIL:RIL + 4].to(F64)), self.m[:, PIL:PIL + 3].to(F64))
        if guess is None:
            m = self.m.to(F64)
            o = self.odo
            eye = torch.eye(4, dtype=F64, device=self.dev).expand(self.b, 4, 4)
            last_pose = _where4(o.num_poses == 0, eye, o.pose)
            cv = last_pose @ _where4(o.num_poses < 2, eye, inverse(o.pose_prev) @ o.pose)
            imu = rt(quat_to_rot(m[:, ORI:ORI + 4]).transpose(-1, -2), m[:, POS:POS + 3]) @ T_il
            guess = _where4(used, imu, cv)
        self.guess = guess
        prev_pose = self.odo.pose  # the pose before this scan
        own, sigma = self.odo.register_at(desk, mask, guess, forced)
        carried = self.odo.pose

        # measurement update and trail, IMU streams
        T_wi = carried @ inverse(T_il)
        m, P = self._pose_update(T_wi)
        m, P = self._after_update(m, P)
        self.m = torch.where(used[:, None], m, self.m)
        self.P = torch.where(used[:, None, None], P, self.P)

        # constant-velocity history and the seed, initializing streams
        dt_scan = torch.clamp(t_end - t_beg, min=1e-3)
        v_fd = (carried[:, :3, 3] - prev_pose[:, :3, 3]) / dt_scan[:, None]
        track = (self.odo.num_poses > 1) & ~used
        self.ring = torch.where(track[:, None, None],
                                torch.cat([self.ring[:, 1:], v_fd[:, None]], 1), self.ring)
        self.ring_n = torch.where(track, torch.clamp(self.ring_n + 1, max=VEL_RING), self.ring_n)
        latch = track & (self.init_t0 < 0)
        self.init_v0 = torch.where(latch[:, None], v_fd, self.init_v0)
        self.init_t0 = torch.where(latch, t_end, self.init_t0)
        anchor = carried
        if self.odo.icp["deskew"]:  # the odometry anchors mid-scan, the filter at scan end
            anchor = anchor.clone()
            anchor[:, :3, 3] += 0.5 * dt_scan[:, None] * v_fd
        vel = torch.where((self.odo.num_poses > 1)[:, None], v_fd, 0.0)
        tw = t_end - self.init_t0
        window = (self.init_t0 >= 0) & (tw > 0.25)
        accel = torch.where(window[:, None], (v_fd - self.init_v0) / torch.clamp(tw, min=1e-3)
                            [:, None], self._ring_accel(dt_scan))
        ms, Ps = self._seed(anchor @ inverse(T_il), vel, accel, torch.clamp(tw, min=0.0))
        self.m = torch.where(just_done[:, None], ms, self.m)
        self.P = torch.where(just_done[:, None, None], Ps, self.P)

        # the packet's last valid sample, carried
        nv = pmask.sum(1)
        last = torch.clamp(nv - 1, min=0)
        tail = torch.cat([torch.gather(times, 1, last[:, None]),
                          torch.gather(gyro, 1, last[:, None, None].expand(-1, 1, 3))[:, 0],
                          torch.gather(acc, 1, last[:, None, None].expand(-1, 1, 3))[:, 0]], 1)
        self.last_imu = torch.where((nv > 0)[:, None], tail, self.last_imu)
        return own, sigma, desk, used

"""The LiDAR-inertial Monte-Carlo driver (`"driver": "lio_ensemble"`): E
ensembles of M perturbed copies of one drive's LiDAR scans and IMU
stream, S = E × M streams, each carrying the full filter. Each ensemble
follows the lap from its own position, drawn from the seed; every stream's
clock starts at 0 and a step k's scan spans [k dt, (k + 1) dt).

Each step gathers the E raw scans (per-point times) and preprocesses them
once, builds the E IMU packets of the step (the circuit's exact angular
rate and specific force, gravity included, at `imu_rate`: samples at
k dt + i / imu_rate, i = 1 .. imu_rate dt), copies each scan and packet
into its M streams with iid point noise (`parallel.streams.perturb_scans`)
and iid gyro and accelerometer noise (`perturb_imu`), each from the card's
generator reseeded from (seed, k, ensemble) (the IMU noise under seeds of
its own), and runs the port's `parallel.streams.batched_lio_step`,
telling it how many IMU samples every stream has had. Once that count says
every stream is initialized and one step has run the IMU branch alone,
the step is captured as a CUDA graph (`streams.LioStepGraph`) and replayed
from then on. Poses are at scan end (ATE shift 1.0). What it shares with
the lidar-only ensemble (lap offsets, the scans' gather, preprocess and
point noise) is `drivers/ensemble.py`'s.

The reference (`reference/lio.py`) follows the compared streams from step
0 on its own preprocess of the raw scans and its own packets, with the
step's noise drawn again after the window (`scan_gap` and `imu_gap` hold
its inputs against those the port took at the window's last step). It
runs its own filter with the port's registered poses as measurements and
its own registration from the port's guesses, and compares: the poses and
`sigma_gap_rel`, the filter mean (position, velocity, orientation and
biases) at every step (`filter_mean_gap`), the covariance at the end
(`filter_cov_gap_rel`), the scan's deskewed points at the last step
(`deskew_gap_m`) and the packed map mirror."""

from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from odom_bench import check
from odom_bench.common import ate as ate_mod
from odom_bench.common import manifest, render
from odom_bench.drivers import ensemble
from odom_bench.reference import lio as ref_lio

GRAVITY = 9.81
MEAN = 16  # the compared filter mean: position, velocity, orientation, gyro and acc bias
IMU_NOISE = 512  # an ensemble e's IMU noise is drawn from noise_seed(k, IMU_NOISE + e)


def circuit_imu(drive: dict, phases: np.ndarray) -> np.ndarray:
    """Body-frame (gyro, specific force) (..., 6) at lap phases (in scans)
    of the circuit: the exact derivatives of `render.circuit`'s poses,
    gravity's reaction included (+g up at rest)."""
    n = int(drive["scans_per_lap"])
    rate = 2.0 * math.pi / (n * float(drive["dt"]))  # rad/s
    radius = render.circuit_radius(drive)
    th = 2.0 * math.pi * phases / n
    c, s = np.cos(th), np.sin(th)
    acc_w = np.stack([-radius * rate ** 2 * s, radius * rate ** 2 * c, np.zeros_like(th)], -1)
    f_w = acc_w + np.array([0.0, 0.0, GRAVITY])
    f_b = np.stack([c * f_w[..., 0] + s * f_w[..., 1], -s * f_w[..., 0] + c * f_w[..., 1],
                    f_w[..., 2]], -1)  # R(th)^T f
    gyro = np.broadcast_to(np.array([0.0, 0.0, rate]), f_b.shape)
    return np.concatenate([gyro, f_b], -1)


class Driver(ensemble.Driver):
    """The cell's E ensembles of M perturbed LIO streams and the port's
    batched LIO step over them."""

    def __init__(self, cell: manifest.Cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.states = None  # the lidar-only states; the LIO state carries its own maps
        if self.drive.time is None:
            raise ValueError("the LIO ensemble deskews by per-point times: a rolling drive")
        if self.e > IMU_NOISE:
            raise ValueError(f"{self.e} ensembles: at most {IMU_NOISE}")
        t0 = time.perf_counter()
        mix, drive = cell.mix, cell.config["drive"]
        self.gyro_sigma, self.acc_sigma = float(mix["gyro_sigma"]), float(mix["acc_sigma"])
        self.dt = float(drive["dt"])
        self.per_scan = int(round(float(mix["imu_rate"]) * self.dt))
        self.cap = self.cfg.imu.max_samples_per_scan
        if self.per_scan > self.cap:
            raise ValueError(f"{self.per_scan} IMU samples a scan > packet capacity {self.cap}")
        # the IMU of every lap position's scan: (L, per_scan, 6) f64
        frac = np.arange(1, self.per_scan + 1) / self.per_scan
        imu = circuit_imu(drive, np.arange(self.lap)[:, None] + frac[None, :])
        self.imu = torch.as_tensor(imu, dtype=torch.float64, device=device)
        self.imu_t = torch.as_tensor(frac * self.dt, dtype=torch.float64, device=device)
        self.rel_time = self.drive.time - self.drive.stamp[:, None]  # (L, P) from the scan's stamp
        self.lio = self.streams.init_batched_lio_state(self.cfg, self.s, device)
        self.states = types.SimpleNamespace(map=self.lio.odo.map)  # what the harness reads
        self.render_s += time.perf_counter() - t0
        self.guesses, self.means = [], []
        self.seen = 0  # IMU samples every stream has had (the packets' own)
        self.imu_steps = 0  # eager steps of the IMU branch alone
        self.graph = None  # the step as a CUDA graph, once every stream is initialized
        self.cuda = torch.device(device).type == "cuda"
        self.ekf_end = None  # the filter after the last step

    def raw(self, k: int, ens=None):
        """The raw scans of step k of the ensembles `ens` (default all),
        stamped on the streams' clock."""
        from lidar_imu_slam_tpu_torch.ops.preprocess import RawScan

        idx = self.table[k % self.lap]
        if ens is not None:
            idx = idx[ens]
        stamp = torch.full((idx.shape[0],), k * self.dt, dtype=torch.float64, device=self.device)
        return RawScan(xyz=self.drive.xyz.index_select(0, idx),
                       time=self.rel_time.index_select(0, idx) + stamp[:, None],
                       ring=self.drive.ring.index_select(0, idx), mask=self.mask[:idx.shape[0]],
                       stamp=stamp)

    def packets(self, k: int, ens=None):
        """The exact IMU packets (E, cap) of step k (time, gyro, acc, mask)."""
        idx = self.table[k % self.lap]
        if ens is not None:
            idx = idx[ens]
        b, p, cap = idx.shape[0], self.per_scan, self.cap
        vals = torch.zeros((b, cap, 6), dtype=torch.float64, device=self.device)
        vals[:, :p] = self.imu.index_select(0, idx)
        t = torch.zeros((b, cap), dtype=torch.float64, device=self.device)
        t[:, :p] = self.imu_t + k * self.dt
        mask = torch.zeros((b, cap), dtype=torch.bool, device=self.device)
        mask[:, :p] = True
        return t, vals[..., :3], vals[..., 3:], mask

    def batch(self, k: int):
        """The S perturbed scans and packets of step k, as the step takes them."""
        from lidar_imu_slam_tpu_torch.models.ekf import ImuPacket

        scans = super().batch(k)
        with torch.profiler.record_function("odom_bench.perturb"):
            pk = ImuPacket(*self.packets(k))
            imus = []
            for e in range(self.e):
                self.gen.manual_seed(self.noise_seed(k, IMU_NOISE + e))
                imus.append(self.streams.perturb_imu(ImuPacket(*(f[e] for f in pk)), self.gen,
                                                     self.m, self.gyro_sigma, self.acc_sigma))
            packets = ImuPacket(*(torch.cat(f) for f in zip(*imus)))
        return scans, packets

    def step(self, run=None):
        """One step of the port (`run(lio, scans, packets)` in its place, for
        the faults)."""
        scans, packets = self.batch(self.k)
        with torch.profiler.record_function("odom_bench.register"):
            if run is not None:
                self.lio, out = run(self.lio, scans, packets)
            else:
                ready = self.seen >= self.cfg.imu.max_init_count
                if self.graph is None and ready and self.cuda and self.imu_steps:
                    self.graph = self.streams.LioStepGraph(self.lio, scans, packets, self.cfg)
                if self.graph is not None:
                    self.lio, out = self.graph(self.lio, scans, packets)
                else:
                    self.lio, out = self.streams.batched_lio_step(
                        self.lio, scans, packets, self.cfg, init_samples=self.seen)
                    self.imu_steps += ready
        self.record(scans, packets, out, self.lio.ekf, self.lio.odo.map)

    def record(self, scans, packets, out, ekf_state, map_):
        """Keep what `compare` reads of the step just taken (copies: a graph's
        outputs are written over by its next replay)."""
        self.seen += self.per_scan
        self.poses.append(out.pose.clone())
        self.sigmas.append(out.sigma.clone())
        self.guesses.append(out.guess.clone())
        self.means.append(ekf_state.m[:, :MEAN].to(torch.float64, copy=True))
        self.last = (self.k, scans, packets, out)
        self.ekf_end = ekf_state
        self.states = types.SimpleNamespace(map=map_)
        self.k += 1

    # -- the reference ----------------------------------------------------
    def imu_noise(self, k: int, cols) -> torch.Tensor:
        """Step k's IMU noise (B, cap, 6) f64 of the streams `cols` (B,), before
        its sigmas and the packet mask, drawn again as the step drew it."""
        out = torch.empty((cols.numel(), self.cap, 6), dtype=torch.float64, device=self.device)
        gen = torch.Generator(device=self.device)
        for e in torch.unique(cols // self.m).tolist():
            gen.manual_seed(self.noise_seed(k, IMU_NOISE + e))
            here = (cols // self.m) == e
            out[here] = torch.randn((self.m, self.cap, 6), generator=gen, dtype=torch.float64,
                                    device=self.device)[cols[here] % self.m]
        return out

    def ref_inputs(self, k: int, cols):
        """The reference's own preprocess of step k's raw scans and its own
        packets, with the step's noise of the streams `cols` added: (points,
        tau, rel_t, mask, t_begin, t_end, times, gyro, acc, packet mask)."""
        pts, tau, mask = super().ref_inputs(k, cols)
        ens, inv = torch.unique(cols // self.m, return_inverse=True)
        raw = self.raw(k, ens)
        rel, tb, te = ref_lio.scan_times(raw.time[inv], raw.stamp[inv], mask)
        t, g, a, pm = (x[inv] for x in self.packets(k, ens))
        di = self.imu_noise(k, cols) * pm[..., None]
        return (pts, tau, rel, mask, tb, te, t, g + di[..., :3] * self.gyro_sigma,
                a + di[..., 3:] * self.acc_sigma, pm)

    def reference(self, b: int, pose_dtype=torch.float64) -> ref_lio.RefLio:
        cfg = self.cell.config
        return ref_lio.RefLio(cfg["pipeline"], b, cfg["reference_grid"], self.device,
                              filter_dtype=pose_dtype)

    def ref_step(self, ref: ref_lio.RefLio, k: int, cols=None, forced=None):
        """The reference's step on step k's inputs (streams `cols`), from the
        port's guess of step k, carrying `forced` (default the port's pose):
        (own pose, sigma)."""
        if cols is None:
            cols = torch.arange(self.s, device=self.device)
        forced = self.poses[k][cols] if forced is None else forced
        own, sigma, _, _ = ref.step(*self.ref_inputs(k, cols), self.guesses[k][cols], forced)
        return own, sigma

    def failed_scans(self, poses: np.ndarray) -> tuple[int, list]:
        """`ate.failed_scans` against each ensemble's lap from its offset, at
        scan end."""
        laps = self.offsets[:, None] + np.arange(poses.shape[0] + 1)
        return ate_mod.failed_scans(poses, lambda s: self.drive.gt[laps[s // self.m] % self.lap],
                                    1.0)

    def compare(self, cols, port_map, poses, sigmas):
        """Follow the compared streams `cols` with the reference and return the
        numbers of `check` and the filter's. poses (steps, S, 4, 4), sigmas
        (steps, S) on the device; port_map holds MAP_FIELDS of the compared
        streams."""
        self.lio = self.graph = None  # the port's state is done with
        ref = self.reference(cols.numel())
        own, ref_sig = [], []
        mean_gap, extra = 0.0, {}
        last = self.last[0] if self.last is not None else -1
        for k in range(poses.shape[0]):
            inputs = self.ref_inputs(k, cols)
            if k == last:
                extra.update(_input_gaps(inputs, self.last[1], self.last[2], cols))
            p, sg, desk, _ = ref.step(*inputs, self.guesses[k][cols], poses[k, cols])
            own.append(p)
            ref_sig.append(sg)
            mean_gap = max(mean_gap, float(torch.amax(torch.abs(
                ref.m[:, :MEAN].to(torch.float64) - self.means[k][cols]))))
            if k == last:
                port_desk = self.last[3].scan_deskewed[cols]
                valid = inputs[3][..., None]
                extra["deskew_gap_m"] = float(torch.amax(torch.where(
                    valid, torch.abs(desk - port_desk), 0.0)))
        P = self.ekf_end.P[cols].to(torch.float64)
        extra["filter_mean_gap"] = mean_gap
        extra["filter_cov_gap_rel"] = float(torch.amax(torch.abs(P - ref.P.to(P.dtype)))
                                            / torch.amax(torch.abs(P)))
        mapc = self.cell.config["pipeline"]["map"]
        vs, kp = mapc["voxel_size"], mapc["nn_points"] or mapc["max_points_per_voxel"]
        pose_t = poses[-1, cols, :3, 3]
        like = ref.odo.map.packed(kp, vs)
        port_pts = check.packed_points(port_map.keys, port_map.packed, pose_t, vs)
        pts, cnt, lost = check.port_map_dense(port_map.keys, port_pts, port_map.npts, pose_t,
                                              vs, like)
        numbers, detail = check.compare(poses, torch.stack(own), sigmas, torch.stack(ref_sig),
                                        cols, ref.odo.map, pts, cnt, lost, like=like)
        numbers.update(extra)
        if self.last is not None:
            out = self.last[3]
            detail["streams_initialized"] = int(out.streams_initialized)
            detail["streams_imu"] = int(out.streams_imu)
        return numbers, detail


def _input_gaps(inputs, scans, packets, cols) -> dict:
    """`scan_gap` (points, tau, times from the first point, scan begin and end)
    and `imu_gap` (sample times, gyro, acc) between the reference's inputs
    of the compared streams and those the port took; inf where a mask
    differs."""
    pts, tau, rel, mask, tb, te, t, g, a, pm = inputs
    if not torch.equal(mask, scans.mask[cols]):
        scan_gap = math.inf
    else:
        scan_gap = max(float(torch.amax(torch.abs(x - y))) for x, y in (
            (pts, scans.xyz[cols]), (tau, scans.tau[cols]), (rel, scans.rel_t[cols]),
            (tb, scans.t_begin[cols]), (te, scans.t_end[cols])))
    if not torch.equal(pm, packets.mask[cols]):
        imu_gap = math.inf
    else:
        imu_gap = max(float(torch.amax(torch.abs(x - y))) for x, y in (
            (t, packets.time[cols]), (g, packets.gyro[cols]), (a, packets.acc[cols])))
    return {"scan_gap": scan_gap, "imu_gap": imu_gap}

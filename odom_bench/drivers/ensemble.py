"""The Monte-Carlo ensemble driver (`"driver": "ensemble"`): E ensembles of
M perturbed copies of one sensor's drive, S = E × M streams. Each ensemble
follows the lap from its own position, drawn from the seed. Each step
takes the E raw scans of the ensembles' lap positions, preprocesses them
once (one scan an ensemble), replicates each into its M streams with iid
normal point noise of `noise_sigma` (`parallel.streams.perturb_scans`,
from a generator on the card reseeded from (seed, k, ensemble)) and
registers all S with the port's batched step. Stream j belongs to
ensemble j // M.

The reference follows the compared streams on the same points: it
preprocesses the raw scans itself, redraws the step's noise from the same
(seed, k, ensemble) after the window, and adds it as the port does;
`scan_gap` holds its points and times against those the port registered
at the window's last step. The port's map keeps only its packed mirror
here, so the maps are compared as that mirror: each voxel's first
`nn_points` points, 10 bits an axis."""

from __future__ import annotations

import time

import numpy as np
import torch

from odom_bench import check
from odom_bench.common import ate as ate_mod
from odom_bench.common import manifest, render
from odom_bench.common.pipeline import port_config
from odom_bench.reference import odometry as ref_mod


class Driver:
    """The cell's E ensembles of M perturbed streams, and the port's batched
    step over them."""

    MAP_FIELDS = ("keys", "packed", "npts")  # the map tables `compare` reads

    def __init__(self, cell: manifest.Cell, seed: int, device):
        from lidar_imu_slam_tpu_torch.parallel import streams

        self.streams = streams
        self.cell = cell
        self.cfg = port_config(cell.config)
        if not self.cfg.map.packed_nn:
            raise ValueError("the ensemble compares the port's packed map mirror")
        self.e = int(cell.mix["ensembles"])
        self.m = int(cell.mix["members"])
        self.s = self.e * self.m
        self.noise_sigma = float(cell.mix["noise_sigma"])
        self.seed = int(seed)
        self.device = device
        t0 = time.perf_counter()
        self.drive = render.render_drive(cell.config, seed, device)
        self.render_s = time.perf_counter() - t0
        self.lap = self.drive.xyz.shape[0]
        rng = np.random.default_rng(seed)
        self.offsets = rng.choice(self.lap, size=self.e, replace=self.e > self.lap)
        table = (self.offsets[None, :] + np.arange(self.lap)[:, None]) % self.lap
        self.table = torch.as_tensor(table, dtype=torch.int64, device=device)
        n = self.drive.xyz.shape[1]
        # every slot holds a return or NaN (an empty one), as an organized cloud
        self.mask = torch.ones((self.e, n), dtype=torch.bool, device=device)
        self.zero_time = torch.zeros((self.e, n), dtype=torch.float64, device=device)
        self.gen = torch.Generator(device=device)
        self.states = streams.init_batched_state(self.cfg, self.s, device)
        self.poses, self.sigmas = [], []
        self.k = 0
        self.last = None  # (k, the scans step k registered)

    def raw(self, k: int, ens=None):
        """The raw scans of step k of the ensembles `ens` (default all)."""
        from lidar_imu_slam_tpu_torch.ops.preprocess import RawScan

        idx = self.table[k % self.lap]
        if ens is not None:
            idx = idx[ens]
        n = idx.shape[0]
        time_ = (self.drive.time.index_select(0, idx) if self.drive.time is not None
                 else self.zero_time[:n])
        return RawScan(xyz=self.drive.xyz.index_select(0, idx), time=time_,
                       ring=self.drive.ring.index_select(0, idx), mask=self.mask[:n],
                       stamp=self.drive.stamp.index_select(0, idx))

    def noise_seed(self, k: int, e: int) -> int:
        return ((self.seed * 1_000_003 + k) * 1024 + e) % (1 << 63)

    def batch(self, k: int):
        """The S perturbed scans of step k, as the step registers them."""
        from lidar_imu_slam_tpu_torch.ops.preprocess import Scan, preprocess_scan

        with torch.profiler.record_function("odom_bench.gather"):
            raw = self.raw(k)
        with torch.profiler.record_function("odom_bench.preprocess"):
            scans = preprocess_scan(raw, self.cfg.lidar)
        with torch.profiler.record_function("odom_bench.perturb"):
            parts = []
            for e in range(self.e):
                self.gen.manual_seed(self.noise_seed(k, e))
                parts.append(self.streams.perturb_scans(Scan(*(f[e] for f in scans)),
                                                        self.gen, self.m, self.noise_sigma))
            scans = Scan(*(torch.cat(f) for f in zip(*parts)))
        self.last = (k, scans)
        return scans

    def step(self):
        scans = self.batch(self.k)
        with torch.profiler.record_function("odom_bench.register"):
            self.states, out = self.streams.batched_register_frame_step(self.states, scans,
                                                                        self.cfg)
        self.poses.append(out.pose)
        self.sigmas.append(out.sigma)
        self.k += 1

    def noise(self, k: int, cols) -> torch.Tensor:
        """Step k's noise (B, N, 3) f32 of the streams `cols` (B,), drawn
        again as the step drew it."""
        out = torch.empty((cols.numel(),) + tuple(self.drive.xyz.shape[1:]),
                          dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device)
        for e in torch.unique(cols // self.m).tolist():
            gen.manual_seed(self.noise_seed(k, e))
            draw = torch.randn((self.m,) + tuple(out.shape[1:]), generator=gen,
                               dtype=torch.float32, device=self.device) * self.noise_sigma
            here = (cols // self.m) == e
            out[here] = draw[cols[here] % self.m]
        return out

    def ref_inputs(self, k: int, cols=None):
        """The reference's own preprocess of step k's raw scans, with the
        step's noise of the streams `cols` (default all) added to their
        valid points: (points (B, N, 3), tau (B, N), mask (B, N))."""
        if cols is None:
            cols = torch.arange(self.s, device=self.device)
        ens, inv = torch.unique(cols // self.m, return_inverse=True)
        raw = self.raw(k, ens)
        pts, tau, mask = ref_mod.preprocess(raw.xyz, raw.time, raw.ring, raw.mask, raw.stamp,
                                            self.cell.config["pipeline"]["lidar"])
        pts, tau, mask = pts[inv], tau[inv], mask[inv]
        return pts + self.noise(k, cols) * mask[..., None], tau, mask

    def reference(self, b: int, pose_dtype=torch.float64) -> ref_mod.RefOdometry:
        cfg = self.cell.config
        return ref_mod.RefOdometry(cfg["pipeline"], b, cfg["reference_grid"], self.device,
                                   pose_dtype=pose_dtype)

    def ref_step(self, ref: ref_mod.RefOdometry, k: int, cols=None, forced=None):
        """The reference's step on step k's points (streams `cols`)."""
        return ref.register(*self.ref_inputs(k, cols), forced=forced)

    def failed_scans(self, poses: np.ndarray) -> tuple[int, list]:
        """`ate.failed_scans` against each ensemble's lap from its offset (the
        sources' `tracking_frac == 1.0`)."""
        laps = self.offsets[:, None] + np.arange(poses.shape[0] + 1)
        return ate_mod.failed_scans(poses, lambda s: self.drive.gt[laps[s // self.m] % self.lap],
                                    0.5 if self.drive.rolling else 0.0)

    def compare(self, cols, port_map, poses, sigmas):
        """Follow the compared streams `cols` with the reference and return the
        numbers of `check`, with `scan_gap` where the port's step ran.
        poses (steps, S, 4, 4), sigmas (steps, S) on the device; port_map
        holds MAP_FIELDS of the compared streams."""
        ref = self.reference(cols.numel())
        own, ref_sig = [], []
        gap = None
        for k in range(poses.shape[0]):
            inputs = self.ref_inputs(k, cols)
            if self.last is not None and self.last[0] == k:
                gap = _scan_gap(inputs, self.last[1], cols)
            p, sg = ref.register(*inputs, forced=poses[k, cols])
            own.append(p)
            ref_sig.append(sg)
        mapc = self.cell.config["pipeline"]["map"]
        vs, kp = mapc["voxel_size"], mapc["nn_points"] or mapc["max_points_per_voxel"]
        pose_t = poses[-1, cols, :3, 3]
        like = ref.map.packed(kp, vs)
        port_pts = check.packed_points(port_map.keys, port_map.packed, pose_t, vs)
        pts, cnt, lost = check.port_map_dense(port_map.keys, port_pts, port_map.npts, pose_t,
                                              vs, like)
        numbers, detail = check.compare(poses, torch.stack(own), sigmas, torch.stack(ref_sig),
                                        cols, ref.map, pts, cnt, lost, like=like)
        if gap is not None:
            numbers["scan_gap"] = gap
        return numbers, detail


def _scan_gap(inputs, scans, cols) -> float:
    """The largest gap between the reference's points and tau of the
    compared streams and those of the scans the port registered; inf where
    their masks differ."""
    pts, tau, mask = inputs
    if not torch.equal(mask, scans.mask[cols]):
        return float("inf")
    return max(float(torch.amax(torch.abs(pts - scans.xyz[cols]))),
               float(torch.amax(torch.abs(tau - scans.tau[cols]))))

"""The fleet driver (a configuration file without a `driver` key): S
streams of one rendered lap, each from its own lap position drawn from the
seed, S raw scans gathered from the drive on the card a step, preprocessed
and registered by the port's batched step. The reference follows the
compared streams on the same raw scans."""

from __future__ import annotations

import time

import numpy as np
import torch

from odom_bench import check
from odom_bench.common import ate as ate_mod
from odom_bench.common import manifest, render
from odom_bench.common.pipeline import port_config
from odom_bench.reference.odometry import RefOdometry


class Driver:
    """The cell's streams on the card: the drive, the stream offsets along
    the lap, and the port's batched step over them."""

    MAP_FIELDS = ("keys", "points", "npts")  # the map tables `compare` reads

    def __init__(self, cell: manifest.Cell, seed: int, device):
        from lidar_imu_slam_tpu_torch.parallel import streams

        self.streams = streams
        self.cell = cell
        self.cfg = port_config(cell.config)
        self.s = int(cell.mix["streams"])
        self.device = device
        t0 = time.perf_counter()
        self.drive = render.render_drive(cell.config, seed, device)
        self.render_s = time.perf_counter() - t0
        self.lap = self.drive.xyz.shape[0]
        rng = np.random.default_rng(seed)
        self.offsets = rng.choice(self.lap, size=self.s, replace=self.s > self.lap)
        table = (self.offsets[None, :] + np.arange(self.lap)[:, None]) % self.lap
        self.table = torch.as_tensor(table, dtype=torch.int64, device=device)
        n = self.drive.xyz.shape[1]
        # every slot holds a return or NaN (an empty one), as an organized cloud
        self.mask = torch.ones((self.s, n), dtype=torch.bool, device=device)
        self.zero_time = torch.zeros((self.s, n), dtype=torch.float64, device=device)
        self.states = streams.init_batched_state(self.cfg, self.s, device)
        self.poses, self.sigmas = [], []
        self.k = 0

    def raw(self, k: int, cols=None):
        """The raw scans of step k (of the streams `cols`, default all)."""
        from lidar_imu_slam_tpu_torch.ops.preprocess import RawScan

        idx = self.table[k % self.lap]
        if cols is not None:
            idx = idx[cols]
        n = idx.shape[0]
        time_ = (self.drive.time.index_select(0, idx) if self.drive.time is not None
                 else self.zero_time[:n])
        return RawScan(xyz=self.drive.xyz.index_select(0, idx), time=time_,
                       ring=self.drive.ring.index_select(0, idx), mask=self.mask[:n],
                       stamp=self.drive.stamp.index_select(0, idx))

    def batch(self, k: int):
        """The preprocessed scans of step k, as the step registers them."""
        from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

        return preprocess_scan(self.raw(k), self.cfg.lidar)

    def step(self):
        from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

        with torch.profiler.record_function("odom_bench.gather"):
            raw = self.raw(self.k)
        with torch.profiler.record_function("odom_bench.preprocess"):
            scans = preprocess_scan(raw, self.cfg.lidar)
        with torch.profiler.record_function("odom_bench.register"):
            self.states, out = self.streams.batched_register_frame_step(self.states, scans,
                                                                        self.cfg)
        self.poses.append(out.pose)
        self.sigmas.append(out.sigma)
        self.k += 1

    def reference(self, b: int, pose_dtype=torch.float64) -> RefOdometry:
        cfg = self.cell.config
        return RefOdometry(cfg["pipeline"], b, cfg["reference_grid"], self.device,
                           pose_dtype=pose_dtype)

    def ref_step(self, ref: RefOdometry, k: int, cols=None, forced=None):
        """The reference's step on the raw scans of step k (streams `cols`)."""
        raw = self.raw(k, cols)
        return ref.step(raw.xyz, raw.time, raw.ring, raw.mask, raw.stamp, forced=forced)

    def failed_scans(self, poses: np.ndarray) -> tuple[int, list]:
        """`ate.failed_scans` against each stream's lap from its offset."""
        laps = self.offsets[:, None] + np.arange(poses.shape[0] + 1)
        return ate_mod.failed_scans(poses, lambda s: self.drive.gt[laps[s] % self.lap],
                                    0.5 if self.drive.rolling else 0.0)

    def compare(self, cols, port_map, poses, sigmas):
        """Follow the compared streams `cols` with the reference and return the
        numbers of `check`. poses (steps, S, 4, 4), sigmas (steps, S) on the
        device; port_map holds MAP_FIELDS of the compared streams."""
        ref = self.reference(cols.numel())
        own, ref_sig = [], []
        for k in range(poses.shape[0]):
            p, sg = self.ref_step(ref, k, cols, forced=poses[k, cols])
            own.append(p)
            ref_sig.append(sg)
        vs = self.cell.config["pipeline"]["map"]["voxel_size"]
        pts, cnt, lost = check.port_map_dense(port_map.keys, port_map.points, port_map.npts,
                                              poses[-1, cols, :3, 3], vs, ref.map)
        return check.compare(poses, torch.stack(own), sigmas, torch.stack(ref_sig), cols,
                             ref.map, pts, cnt, lost)

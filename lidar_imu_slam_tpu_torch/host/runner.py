"""Host-side odometry runners (counterpart of the JAX package's
`host/runner.py`): feed scans to the step, collect poses, checkpoint,
report metrics.

Replaces the reference's ROS node main loop (reference src/odom_run.cpp:154-
185) with a double-buffered producer: a one-worker thread packs, uploads
and preprocesses scan k+1 while scan k runs. The upload is one
non-blocking copy from pinned memory (`ops/preprocess.to_device`), so the
worker does not wait for scan k's queued work as a copy from pageable
memory would.

The runners keep each scan's pose and scalar outputs on the device and
fetch them in ONE copy at the end of the run: no host read per scan of
their own. That is safe because every kept output is a tensor the step
allocated for that scan; the steps update only the map tables in place
(`kiss_icp.register_frame_step`, `lio.step_donated`), and no kept output
is a view of them. Host reads that remain: the step's own (one per ICP
round on the fast path, one per GN iteration on the classic one, LIO's
branch read, the compaction check under `auto_rebuild`), two map
scalars every 64 scans (`_maybe_rebuild`), and one pose read every
`sync_every` scans when asked. With the loop-closure backend
(`cfg.backend.enabled`), one pose copy every `cfg.backend.chunk` scans,
one copy of the new keyframes' keypoints, and the backend's own reads
when it verifies loops and optimizes (`host/keyframes.py`).

Checkpoints are `torch.save` files: the state's tensors in a dict keyed
by field path, plus the step. The JAX package's orbax checkpoints are not
read.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..models import kiss_icp, lio
from ..ops import voxel_map
from ..ops.preprocess import pack_raw_scan, preprocess_scan, split_scan_compact
from ..utils import trajectory
from ..utils.metrics import MetricsLog, StepTimer
from .keyframes import OnlineBackend
from .stream_sync import StreamSynchronizer

F64 = torch.float64
# the scalar outputs kept per scan (beside the pose and the scan's t_begin)
ODOMETRY_FIELDS = ("icp_iterations", "num_correspondences", "residual_rms", "sigma",
                   "map_voxels", "icp_converged", "window_drops")
LIO_FIELDS = ODOMETRY_FIELDS + ("imu_initialized", "used_imu")


def _flatten(state, prefix: str = "") -> dict:
    """A state's tensors keyed by field path ("map.keys", "odo.pose", ...)."""
    out = {}
    for name, value in zip(state._fields, state):
        key = prefix + name
        if isinstance(value, torch.Tensor):
            out[key] = value
        else:
            out.update(_flatten(value, key + "."))
    return out


def _unflatten(template, flat: dict, device, prefix: str = ""):
    """The NamedTuple structure of `template`, with the tensors of `flat`
    on `device`; each must have the template's dtype and shape. Each is
    laid out as the map's tables are (the front view of a buffer with one
    spare element), so the next in-place step updates it without a copy."""
    fields = []
    for name, value in zip(template._fields, template):
        key = prefix + name
        if isinstance(value, torch.Tensor):
            if key not in flat:
                raise KeyError(f"checkpoint has no tensor {key!r}")
            t = flat[key]
            if t.dtype != value.dtype or t.shape != value.shape:
                raise ValueError(f"checkpoint tensor {key!r} is {t.dtype} {tuple(t.shape)}, "
                                 f"the state needs {value.dtype} {tuple(value.shape)}")
            fields.append(voxel_map._with_spare(t.to(device)))
        else:
            fields.append(_unflatten(value, flat, device, key + "."))
    return type(template)(*fields)


def _checkpoint_file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step:06d}.pt")


def checkpoint_save(path: str, state, step: int) -> None:
    """Save a `KissState` or `LioState` (its tensors, keyed by field path,
    copied to the host) and the step to `<path>/step_<step>.pt`."""
    os.makedirs(os.path.abspath(path), exist_ok=True)
    tensors = {k: v.detach().to("cpu", copy=True) for k, v in _flatten(state).items()}
    torch.save({"step": int(step), "state": tensors}, _checkpoint_file(path, step))


def checkpoint_restore(path: str, template, step: int, device: torch.device | str = "cuda"):
    """The state saved at `step`, with the structure, dtypes and shapes of
    `template` (a state of the same config, e.g. `kiss_icp.init_state`),
    on `device`. Loaded with `weights_only=True`: the file holds tensors,
    a dict and an int, nothing else."""
    data = torch.load(_checkpoint_file(path, step), map_location="cpu", weights_only=True)
    if data.get("step") != step:
        raise ValueError(f"checkpoint file holds step {data.get('step')}, not {step}")
    return _unflatten(template, data["state"], torch.device(device))


class OdometryRunner:
    """Drives the KISS-ICP (lidar-only) pipeline over a scan iterable on
    `device`."""

    def __init__(self, cfg: PipelineConfig, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = self._init_state()
        self.poses: list[np.ndarray] = []
        self.stamps: list[float] = []
        self.metrics = MetricsLog()
        self.timer = StepTimer()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self._seg_cfg: Optional[PipelineConfig] = None
        self.backend: Optional[OnlineBackend] = (
            OnlineBackend(cfg, self.device) if cfg.backend.enabled else None)
        self._chunk: list = []  # (scan index, pose, keypoints, mask) on the device

    def _backend_observe(self, i: int, out, final: bool = False) -> None:
        """Feed the online backend in chunks of `cfg.backend.chunk` scans:
        the open chunk keeps its poses and keypoints on the device; when it
        closes, its poses come to the host in one copy (the backend copies
        the keypoints of the scans it selects as keyframes) and the chunk
        is released. `final` flushes the last chunk and optimizes once
        more."""
        if self.backend is None:
            return
        if out is not None:
            self._chunk.append((i, out.pose, out.keypoints, out.keypoints_mask))
        if self._chunk and (len(self._chunk) >= self.cfg.backend.chunk or final):
            idxs = [c[0] for c in self._chunk]
            poses = torch.stack([c[1] for c in self._chunk]).cpu().numpy()
            self.backend.observe_chunk(idxs, poses, [c[2] for c in self._chunk],
                                       [c[3] for c in self._chunk])
            self._chunk = []
        if final and self.backend.kf_poses:
            self.backend.optimize()

    def optimized_poses(self) -> np.ndarray:
        """The loop-closure-corrected trajectory (the raw odometry poses when
        the backend is off or found no loop)."""
        poses = np.stack(self.poses)
        if self.backend is None:
            return poses
        return self.backend.correct(poses)

    def _init_state(self):
        return kiss_icp.init_state(self.cfg, self.device)

    def _pack(self, scan_msg: dict):
        raw = pack_raw_scan(
            scan_msg["xyz"],
            time=scan_msg.get("time"),
            ring=scan_msg.get("ring"),
            stamp=scan_msg.get("stamp", 0.0),
            max_points=self.cfg.lidar.max_points,
            device=self.device,
        )
        return preprocess_scan(raw, self.cfg.lidar)

    def _segments(self, scan, scan_index: int):
        """Frame splitting (reference split_clouds + MIN_SCAN_COUNT warmup
        gate, frame.cpp:5,64): one segment for the first `min_scan_count`
        scans, then `frame_split_num` compact sub-frames, which run under
        a config whose downsample budgets fit the segment shape."""
        n = self.cfg.lidar.frame_split_num
        if n <= 1 or scan_index < self.cfg.min_scan_count:
            return [scan], self.cfg
        return split_scan_compact(scan, n), self._segment_cfg()

    def _segment_cfg(self) -> PipelineConfig:
        if self._seg_cfg is None:
            seg_len = -(-self.cfg.lidar.max_points // self.cfg.lidar.frame_split_num)
            self._seg_cfg = self.cfg.replace(
                lidar=dataclasses.replace(self.cfg.lidar, max_points=seg_len),
                icp=dataclasses.replace(
                    self.cfg.icp,
                    max_map_points=min(self.cfg.icp.max_map_points, seg_len),
                    max_source_points=min(self.cfg.icp.max_source_points, seg_len),
                ),
            )
        return self._seg_cfg

    def _on_loop_back(self, scan_index: int) -> None:
        """Reset the SLAM state after a LiDAR loop-back (stamp regression).
        Already-collected poses/metrics are kept — the replayed section
        restarts odometry from identity."""
        logging.getLogger(__name__).warning(
            "LiDAR loop back at scan %d: resetting SLAM state", scan_index)
        self.state = self._init_state()

    def _map(self) -> voxel_map.VoxelMap:
        return self.state.map

    def _set_map(self, m: voxel_map.VoxelMap) -> None:
        self.state = self.state._replace(map=m)

    def _maybe_rebuild(self, scan_index: int) -> None:
        """Compact the slab when eviction tombstones accumulate or the
        append-only bump cursor nears capacity (every 64 scans: two host
        reads)."""
        if scan_index % 64 != 0 or scan_index == 0:
            return
        m = self._map()
        cap = self.cfg.map.capacity
        tombs = int(m.tombstones)
        cursor = int(m.next_slot)
        if tombs > cap // 8 or (cursor > cap - cap // 4 and tombs > 0):
            self._set_map(voxel_map.rebuild(m, self.cfg.map))

    def _drive(self, scan_msgs: Iterable[dict], prepare: Callable, step: Callable,
               fields: tuple, progress: Optional[Callable], sync_every: int) -> None:
        """The double-buffered loop shared by `run` and `run_lio`: the
        worker packs scan k+1 while `step(i, scan, prepare(i, msg))` runs
        scan k (it returns the last output and a dict of host metrics);
        the kept outputs come to the host in one copy at the end."""
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        it = iter(scan_msgs)

        def fetch_next():
            try:
                msg = next(it)
            except StopIteration:
                return None
            return pool.submit(self._pack, msg), msg

        kept, host = [], []
        try:
            nxt = fetch_next()
            i = 0
            while nxt is not None:
                fut, msg = nxt
                scan = fut.result()
                nxt = fetch_next()
                ctx = prepare(i, msg)
                t0 = time.perf_counter()
                out, host_metrics = step(i, scan, ctx)
                if sync_every and (i + 1) % sync_every == 0:
                    out.pose.cpu()  # a host read: the step's true latency
                dt = time.perf_counter() - t0
                if i > 0:
                    self.timer.record(dt)
                # the pose and the scalar outputs only (the point-cloud
                # fields would pin ~400 KB a scan of device memory)
                kept.append((out.pose, scan.t_begin, *(getattr(out, f) for f in fields)))
                host.append(host_metrics)
                if (self.checkpoint_dir and self.checkpoint_every
                        and (i + 1) % self.checkpoint_every == 0):
                    checkpoint_save(self.checkpoint_dir, self.state, i + 1)
                if progress:
                    progress(i, out)
                self._backend_observe(i, out)
                self._maybe_rebuild(i)
                i += 1
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        self._backend_observe(i, None, final=True)
        self._collect(kept, host, fields)

    def _collect(self, kept: list, host: list, fields: tuple) -> None:
        """Every kept output of the run in one device-to-host copy: one
        stack per field, one (n, 17 + len(fields)) f64 table."""
        if not kept:
            return
        n = len(kept)
        cols = list(zip(*kept))
        table = torch.cat(
            [torch.stack(cols[0]).reshape(n, 16).to(F64)]
            + [torch.stack(c).reshape(n, 1).to(F64) for c in cols[1:]], dim=1).cpu().numpy()
        for i, row in enumerate(table):
            self.poses.append(row[:16].reshape(4, 4).copy())
            self.stamps.append(float(row[16]))
            self.metrics.append(i, **dict(zip(fields, row[17:])), **host[i])

    def run(self, scan_msgs: Iterable[dict], progress: Optional[Callable] = None,
            sync_every: int = 0):
        """Double-buffered loop over scan messages {"xyz", optional "time",
        "ring", "stamp"}. `sync_every=N` reads the pose every N scans
        (true per-scan latency in `timer`); `progress(i, out)` receives the
        device-side output (fetch in the callback only if needed)."""
        prev = {"stamp": None}

        def prepare(i, msg):
            stamp = float(msg.get("stamp", 0.0))
            if prev["stamp"] is not None and stamp < prev["stamp"]:
                # LiDAR loop-back (bag replay wrapped): reset the SLAM state
                # so the replay does not register against the stale map
                # (the reference keeps it, frame.cpp:16-22; PARITY.md)
                self._on_loop_back(i)
            prev["stamp"] = stamp

        def step(i, scan, _):
            segs, seg_cfg = self._segments(scan, i)
            for seg in segs:
                # in place: the map tables update without a copy
                self.state, out = kiss_icp.register_frame_step(self.state, seg, seg_cfg)
            return out, {}

        self._drive(scan_msgs, prepare, step, ODOMETRY_FIELDS, progress, sync_every)
        return self

    def write_trajectory(self, path: str, fmt: str = "tum") -> None:
        if fmt == "tum":
            trajectory.write_tum(path, self.stamps, self.poses)
        elif fmt == "kitti":
            trajectory.write_kitti(path, self.poses)
        else:
            raise ValueError(f"unknown format {fmt}")

    def ate_against(self, gt_poses, align: bool = True) -> float:
        return trajectory.ate_rmse(np.stack(self.poses), gt_poses, align=align)


class LioRunner(OdometryRunner):
    """Drives the LiDAR-inertial pipeline: scans + an IMU stream, with the
    lidar-only runner's prefetch, checkpoints, map maintenance and one
    fetch at the end, plus the reference's stream hygiene (lidar-imu time
    offset latch, loop-back resets, IMU rate warning) through
    `stream_sync.StreamSynchronizer`."""

    def _init_state(self):
        return lio.init_state(self.cfg, self.device)

    def _map(self) -> voxel_map.VoxelMap:
        return self.state.odo.map

    def _set_map(self, m: voxel_map.VoxelMap) -> None:
        self.state = self.state._replace(odo=self.state.odo._replace(map=m))

    @staticmethod
    def _host_t_end(msg: dict) -> float:
        """Scan end time from the raw message (the host's, not a read of
        the device scan's t_end)."""
        t = msg.get("time")
        stamp = float(msg.get("stamp", 0.0))
        if t is not None and len(t):
            tmax = float(np.max(t))
            return tmax if tmax > stamp else stamp + tmax
        return stamp

    def _on_loop_back(self, scan_index: int) -> None:
        logging.getLogger(__name__).warning(
            "LiDAR loop back at scan %d: resetting LIO state", scan_index)
        self.state = self._init_state()

    def run_lio(self, scan_msgs: Iterable[dict], imu_stream, progress=None,
                sync_every: int = 0):
        """`imu_stream`: array-like of (t, gx, gy, gz, ax, ay, az) rows in
        arrival order. Samples go through the stream synchronizer (offset
        shift, loop-back resets) and are bucketed to the scan (with frame
        splitting, the segment) that covers them; `imu_overflow` counts the
        samples a full packet dropped."""
        imu = np.asarray(imu_stream, np.float64)
        sync = StreamSynchronizer(self.cfg.imu)
        cap = self.cfg.imu.max_samples_per_scan
        cursor = [0]

        def push(k):
            sync.push_imu(imu[k, 0], imu[k, 1:4], imu[k, 4:7])

        def prepare(i, msg):
            t_end, stamp = self._host_t_end(msg), float(msg.get("stamp", 0.0))
            # the reference's imu_callback arrival order: at least one IMU
            # sample is visible before the offset latch fires
            if not sync.offset_set and cursor[0] < len(imu):
                push(cursor[0])
                cursor[0] += 1
            if sync.push_scan(stamp):
                self._on_loop_back(i)
            while cursor[0] < len(imu) and imu[cursor[0], 0] - sync.time_offset <= t_end:
                push(cursor[0])
                cursor[0] += 1
            return t_end, stamp

        def step(i, scan, ctx):
            t_end, stamp = ctx
            segs, seg_cfg = self._segments(scan, i)
            # per-segment IMU windows: segments are equal-COUNT slices of
            # the time-sorted scan, their time boundaries approximated by
            # equal-time interpolation over [stamp, t_end] (the reference
            # buckets IMU per sub-frame by accumulated segment time,
            # frame.cpp:53-99 — documented deviation, PARITY.md)
            overflow = 0
            for s, seg in enumerate(segs):
                seg_t_end = (t_end if s == len(segs) - 1
                             else stamp + (t_end - stamp) * (s + 1) / len(segs))
                take = sync.take_until(seg_t_end, cap)
                overflow += sync.last_overflow
                packet = lio.pack_imu_packet(take[:, 0], take[:, 1:4], take[:, 4:7], cap,
                                             device=self.device)
                self.state, out = lio.step_donated(self.state, seg, packet, seg_cfg)
            return out, {"imu_overflow": overflow}

        self._drive(scan_msgs, prepare, step, LIO_FIELDS, progress, sync_every)
        return self

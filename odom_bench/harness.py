"""One run of one cell: render the drive on the card from the seed, make S
fresh stream states, warm up, drive the port's batched step in a closed
loop for the window, then judge what the window produced against the
plain reference and print the result line.

The entry the window drives, per step: one index op a field gathers the
step's S raw scans from the drive on the card, then
`ops.preprocess.preprocess_scan` and
`parallel.streams.batched_register_frame_step` (the port's one path that
reads nothing from the host). The next step is enqueued as soon as the
loop gets back round; CUDA events after each step time it without a
synchronisation.

With `trace`, the same run profiles a fixed number of steady steps
instead of the timed window, then times the host's enqueue of a few steps
started on an idle card and counts the aten ops of a few more: the
per-layer metrics read these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch

from . import check
from .common import ate as ate_mod
from .common import manifest, render
from .common import trace as trace_mod
from .common.opcount import OpCounter
from .reference.odometry import RefOdometry

TRACK_GATE_M = 0.5  # chip_smoke.py:monte_carlo_phase's tracking gate
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_imu_slam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since the
    interpreter imported this module where /proc is not readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def port_config(config: dict):
    """The port's configuration of a configuration file: its preset, the
    file's overrides, then `streams.batch_config` with the file's unroll;
    raises unless it equals the file's `pipeline` record."""
    from lidar_imu_slam_tpu_torch import config as lis_config
    from lidar_imu_slam_tpu_torch.parallel import streams

    cfg = getattr(lis_config, config["preset"])()
    for group, fields in config.get("overrides", {}).items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **fields)})
    cfg = streams.batch_config(cfg, config["batch"]["outer"], config["batch"]["inner"])
    as_run = dataclasses.asdict(cfg)
    if as_run != config["pipeline"]:
        diff = {g: {k: (v, config["pipeline"].get(g, {}).get(k)) for k, v in f.items()
                    if config["pipeline"].get(g, {}).get(k) != v}
                for g, f in as_run.items()}
        raise ValueError(f"the configuration file's pipeline is not what runs: "
                         f"{ {g: d for g, d in diff.items() if d} }")
    return cfg


def _load_metric(name: str, bench_dir: str):
    spec = importlib.util.spec_from_file_location(f"odom_bench_metric_{name}",
                                                  manifest.metric_file(name, bench_dir))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Driver:
    """The cell's streams on the card: the drive, the stream offsets along
    the lap, and the port's batched step over them."""

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


def map_occupancy(m) -> dict:
    """Mean over the streams of the port's map counters: live voxels and
    points, slots ever allocated, voxels evicted, points dropped (those the
    map lacked room for)."""
    out = {"live_voxels": (m.keys >= 0) & (m.npts > 0), "points": m.npts}
    for name in ("next_slot", "tombstones", "drops"):
        if hasattr(m, name):
            out[name] = getattr(m, name)
    s = m.keys.shape[0]
    return {k: round(float(v.to(torch.float64).sum()) / s, 1) for k, v in out.items()}


def failed_scans(driver: Driver, poses: np.ndarray) -> tuple[int, list]:
    """Scans with a non-finite pose, plus every scan of a stream whose ATE
    against the ground truth passes the tracking gate. Returns (failed,
    per-stream ATE)."""
    steps = poses.shape[0]
    shift = 0.5 if driver.drive.rolling else 0.0
    failed, ates = 0, []
    for s in range(driver.s):
        p = poses[:, s]
        finite = np.isfinite(p).all(axis=(-1, -2))
        gt = driver.drive.gt[(driver.offsets[s] + np.arange(steps + 1)) % driver.lap]
        a = ate_mod.ate(p, gt, shift) if finite.all() else float("inf")
        ates.append(a)
        failed += steps if not a <= TRACK_GATE_M else int((~finite).sum())
    return failed, ates


def compared_streams(driver: Driver, mix: dict, seed: int) -> torch.Tensor:
    """The streams the reference follows: `compare_streams` of them, drawn
    from the seed."""
    pick = np.random.default_rng(seed + 1).choice(driver.s, size=int(mix["compare_streams"]),
                                                  replace=False)
    return torch.as_tensor(np.sort(pick), device=driver.device)


def compare(driver: Driver, cell: manifest.Cell, cols, port_map, poses, sigmas):
    """Follow the compared streams `cols` with the reference and return the
    numbers of `check`. poses (steps, S, 4, 4), sigmas (steps, S) on the
    device; port_map = (keys, points, npts) of the compared streams."""
    b = cols.numel()
    ref = RefOdometry(cell.config["pipeline"], b, cell.config["reference_grid"], driver.device)
    own, ref_sig = [], []
    steps = poses.shape[0]
    for k in range(steps):
        raw = driver.raw(k, cols)
        p, sg = ref.step(raw.xyz, raw.time, raw.ring, raw.mask, raw.stamp,
                         forced=poses[k, cols])
        own.append(p)
        ref_sig.append(sg)
    own, ref_sig = torch.stack(own), torch.stack(ref_sig)
    gap_m, gap_rad = check.pose_gaps(poses[:, cols], own)
    keys, points, npts = port_map
    vs = cell.config["pipeline"]["map"]["voxel_size"]
    pts, cnt, lost = check.port_map_dense(keys, points, npts, poses[-1, cols, :3, 3], vs, ref.map)
    off, tot = check.map_mismatch(ref.map, pts, cnt)
    numbers = {
        "pose_gap_m": gap_m,
        "pose_gap_rad": gap_rad,
        "sigma_gap_rel": check.sigma_gap(sigmas[:, cols], ref_sig),
        "map_off_share": float(off.sum() / max(tot.sum(), 1)),
        "ref_out_of_box": float(ref.map.out_of_box.sum().item() + lost),
        "scans_compared": float(steps * b),
    }
    detail = {"streams": cols.tolist(), "map_off_per_stream": off.tolist(),
              "map_points_per_stream": tot.tolist()}
    return numbers, detail


def _card(device) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench_dir: str = manifest.BENCH_DIR, steps: int | None = None,
             wrap_step=None, log=print) -> dict:
    """Run one cell; returns the result object (with `checks` last).
    `steps` fixes the window's step count instead of its length and
    `wrap_step` replaces the driver's step (both for the benchmark's own
    tests)."""
    cell = manifest.resolve(root, workload, bench_dir)
    mix = cell.mix
    driver = Driver(cell, seed, device)
    step = (lambda: wrap_step(driver)) if wrap_step else driver.step
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    from lidar_imu_slam_tpu_torch.ops.kernels import _build

    for _ in range(int(mix["warmup_steps"])):
        step()
    sync()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s (kernel build {_build.build_seconds} s, render "
        f"{driver.render_s:.3f} s, {driver.k} warm-up steps)", file=sys.stderr)

    ctx = types.SimpleNamespace(streams=driver.s, setup_s=setup_s,
                                pipeline=cell.config["pipeline"], trace=None)
    if not trace:
        first = driver.k
        ends = []
        ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
        sync()
        t0 = time.perf_counter()
        if cuda:
            ev0.record()
        while (driver.k - first < steps) if steps is not None else (
                time.perf_counter() - t0 < seconds):
            step()
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ends.append(e)
        sync()
        ctx.wall_s = time.perf_counter() - t0
        ctx.window_steps = driver.k - first
        ctx.step_ms = ([ev0.elapsed_time(ends[0])] + [a.elapsed_time(b) for a, b in
                                                     zip(ends[:-1], ends[1:])]) if cuda else []
        log(f"window {ctx.wall_s:.3f} s, {ctx.window_steps} steps of {driver.s} streams, "
            f"{len(ctx.step_ms)} step intervals", file=sys.stderr)
    else:
        n_prof = int(mix["profile_steps"])
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with tempfile.TemporaryDirectory() as tmp:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            sync()
            with torch.profiler.record_function(trace_mod.WINDOW_RANGE):
                for _ in range(n_prof):
                    step()
                sync()
            prof.stop()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            ctx.trace = trace_mod.load(path)
        ctx.window_s = ctx.trace.window[1] - ctx.trace.window[0]
        ctx.profiled_steps = n_prof
        ctx.busy_s = trace_mod.busy_s(ctx.trace)
        enq = []
        for _ in range(int(mix["enqueue_steps"])):
            sync()
            t = time.perf_counter()
            step()
            enq.append((time.perf_counter() - t) * 1e3)
        ctx.enqueue_ms = enq
        sync()
        counter = OpCounter()
        with counter:
            for _ in range(int(mix["opcount_steps"])):
                step()
        ctx.ops, ctx.opcount_steps = counter.ops, int(mix["opcount_steps"])
        sync()

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    poses = torch.stack(driver.poses)
    sigmas = torch.stack(driver.sigmas)
    cols = compared_streams(driver, mix, seed)
    m = driver.states.map
    port_map = (m.keys[cols].clone(), m.points[cols].clone(), m.npts[cols].clone())
    log(f"port maps after {poses.shape[0]} steps, mean of {driver.s} streams: "
        f"{map_occupancy(m)}", file=sys.stderr)
    driver.states = None
    if cuda:
        torch.cuda.empty_cache()

    failed, ates = failed_scans(driver, poses.cpu().numpy())
    t_ref = time.perf_counter()
    numbers, detail = compare(driver, cell, cols, port_map, poses, sigmas)
    correct, checks = check.judge(numbers, cell.config["limits"])
    log(f"reference: {time.perf_counter() - t_ref:.3f} s over {poses.shape[0]} steps of "
        f"{cols.numel()} streams; {detail}; worst stream ATE {max(ates):.4f} m", file=sys.stderr)

    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = _load_metric(entry["name"], bench_dir).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev_info = _card(device) if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    dev_info["memory_peak_bytes"] = int(peak)
    result = {"correct": correct, "attempted": int(poses.shape[0] * driver.s),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = ctx.busy_s
        dev_info["window_s"] = ctx.window_s
        result["breakdown"] = {"device_ops": trace_mod.top_device_ops(ctx.trace),
                               "idle_gaps": trace_mod.idle_gaps(ctx.trace)}
    result["checks"] = checks
    return result

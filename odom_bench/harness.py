"""One run of one cell: the configuration's driver renders its drive on
the card from the seed and makes fresh stream states; the harness warms
up, drives the driver's step in a closed loop for the window, then has the
driver judge what the window produced against the plain reference, and
prints the result line.

A driver (`drivers/<name>.py`, named by the configuration file's `driver`
key, `fleet` where it has none) owns what differs between deployments:
the drive, the inputs of a step, the port's entry it calls and the
reference that follows it (`load_driver` lists its interface). The
harness owns the window, the timing, the trace, the op count, the metric
readers and the verdict. A step ends with the port's
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

import importlib.util
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch

from . import check
from .common import manifest
from .common import trace as trace_mod
from .common.opcount import OpCounter

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


def _load_file(module: str, path: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_metric(name: str, bench_dir: str):
    return _load_file(f"odom_bench_metric_{name}", manifest.metric_file(name, bench_dir))


def load_driver(config: dict, bench_dir: str = manifest.BENCH_DIR):
    """The `Driver` class of the driver that the configuration file names
    (`driver`, default `fleet`), from bench_dir/drivers/<driver>.py.

    A driver is constructed from (cell, seed, device) and has: `s` (streams),
    `device`, `k` (steps taken), `render_s`, `cfg` (the port's configuration),
    `step()` (one step of the port, appending its poses (S, 4, 4) and
    sigmas (S,) to `poses` and `sigmas`), `states.map` (the port's maps),
    `MAP_FIELDS` (the map tables its `compare` reads), `failed_scans(poses)`
    -> (failed, per-stream ATE) and `compare(cols, port_map, poses, sigmas)`
    -> (numbers, detail). The faults and the control add `batch(k)` (the
    scans step k registers), `reference(b, pose_dtype)` and
    `ref_step(ref, k, cols, forced)`."""
    name = config.get("driver", "fleet")
    return _load_file(f"odom_bench_driver_{name}",
                      manifest.driver_file(name, bench_dir)).Driver


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


def compared_streams(driver, mix: dict, seed: int) -> torch.Tensor:
    """The streams the reference follows: `compare_streams` of them, drawn
    from the seed."""
    pick = np.random.default_rng(seed + 1).choice(driver.s, size=int(mix["compare_streams"]),
                                                  replace=False)
    return torch.as_tensor(np.sort(pick), device=driver.device)


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
    driver = load_driver(cell.config, bench_dir)(cell, seed, device)
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
            f"{len(ctx.step_ms)} step intervals, the longest (ms) "
            f"{[round(t, 2) for t in sorted(ctx.step_ms)[-4:]]}", file=sys.stderr)
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
    port_map = types.SimpleNamespace(**{f: getattr(m, f)[cols].clone()
                                        for f in driver.MAP_FIELDS})
    log(f"port maps after {poses.shape[0]} steps, mean of {driver.s} streams: "
        f"{map_occupancy(m)}", file=sys.stderr)
    driver.states = None
    if cuda:
        torch.cuda.empty_cache()

    failed, ates = driver.failed_scans(poses.cpu().numpy())
    t_ref = time.perf_counter()
    numbers, detail = driver.compare(cols, port_map, poses, sigmas)
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

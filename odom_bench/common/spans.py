"""Device time by the program's spans: each kernel, copy and fill of the
profiled window is charged to the host ranges (`user_annotation`: the
port's `utils/profiling.annotate` spans and the harness's step ranges)
open around the call that launched it.

The launch is the `cuda_runtime` or `cuda_driver` event with the device
operation's `args.correlation`; the ranges are those open on the
launching thread when it started. An operation whose launch is not in the
trace is charged to `NO_LAUNCH`, one launched under no range to
`NO_SPAN`. Ranges on one thread nest (record_function is a stack), so the
ranges open at a launch form a path from the outermost to the innermost.

`common/trace.Trace`, which the harness keeps on `ctx.trace`, drops the
correlation, and the profiler writes its Chrome trace only once, so
`of(ctx)` reads the same events from the profiler that the harness's
`run_cell` still holds while its readers run (`events_of`), and keeps the
result on `ctx.spans` for the other readers."""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import NamedTuple

from . import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "no span"
NO_LAUNCH = "no launch"


class Spans(NamedTuple):
    """Seconds on the profiler's clock, over the device operations that
    start inside the window (`trace.kernel_seconds`'s rule)."""

    total: dict  # range -> device seconds launched inside it, nested ranges included
    self: dict  # innermost range (or NO_SPAN / NO_LAUNCH) -> device seconds
    device_s: float  # every device operation of the window
    ops: dict  # (innermost range, operation name) -> [device seconds, count]
    opened: dict  # range -> times it opened in the window
    host_self: dict  # range -> host seconds of its openings less their nested ranges
    parents: dict  # range -> set of the ranges it opened directly inside (None: outermost)


def attribute(events: list) -> Spans:
    """Charge the device operations of the window of a Chrome trace's
    `traceEvents` to the ranges open at their launch."""
    device, launches, ranges, window = [], {}, defaultdict(list), None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat in trace.DEVICE_CATS:
            device.append((e.get("args", {}).get("correlation"), e["name"], start, dur))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")), start)
        elif cat == "user_annotation":
            if e["name"] == trace.WINDOW_RANGE:
                window = (start, start + dur)
            else:
                ranges[(e.get("pid"), e.get("tid"))].append((start, start + dur, e["name"]))
    if window is None:
        raise ValueError(f"the trace holds no {trace.WINDOW_RANGE} range")
    w0, w1 = window

    # the ranges open at each launch, by a sweep along each thread
    wanted = defaultdict(list)
    for corr, (thread, t) in launches.items():
        wanted[thread].append((t, corr))
    path_of, opened, host_self = {}, defaultdict(int), defaultdict(float)
    parents = defaultdict(set)
    for thread in set(wanted) | set(ranges):
        marks = sorted([(s, 0, e, name) for s, e, name in ranges[thread]]
                       + [(t, 1, corr, None) for t, corr in wanted[thread]],
                       key=lambda m: (m[0], m[1], -m[2] if m[1] == 0 else 0))
        stack = []  # (end, name)
        for t, kind, x, name in marks:
            while stack and stack[-1][0] <= t:
                stack.pop()
            if kind == 1:
                path_of[x] = tuple(n for _, n in stack)
                continue
            if w0 <= t < w1:
                opened[name] += 1
                host_self[name] += x - t
                if stack:
                    host_self[stack[-1][1]] -= x - t
                parents[name].add(stack[-1][1] if stack else None)
            stack.append((x, name))

    total, self_, ops, device_s = defaultdict(float), defaultdict(float), {}, 0.0
    for corr, name, start, dur in device:
        if not w0 <= start < w1:
            continue
        secs = dur * 1e-6
        device_s += secs
        path = path_of.get(corr)
        inner = NO_LAUNCH if path is None else (path[-1] if path else NO_SPAN)
        self_[inner] += secs
        for r in set(path or ()):
            total[r] += secs
        acc = ops.setdefault((inner, name), [0.0, 0])
        acc[0] += secs
        acc[1] += 1
    return Spans(dict(total), dict(self_), device_s, ops, dict(opened),
                 {k: v * 1e-6 for k, v in host_self.items()}, dict(parents))


def load(path: str) -> Spans:
    with open(path) as f:
        return attribute(json.load(f)["traceEvents"])


def _profiler_holding(ctx):
    """The torch profiler in the frame, up the stack, that holds `ctx`
    (the harness's `run_cell` while it calls its readers), or None."""
    import torch

    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if any(v is ctx for v in local.values()):
            for v in local.values():
                if isinstance(v, torch.profiler.profile):
                    return v
        frame = frame.f_back
    return None


def events_of(prof) -> list:
    """A stopped profiler's events as the Chrome trace's `traceEvents` hold
    them: complete events with `ts` and `dur` in µs, `tid`, and
    `args.correlation` on launches and device operations. Each event's
    category is told from what every torch version's events carry: device
    operations run on the card and are not ranges (the card's copies of
    the ranges, `gpu_user_annotation`, are left out); launches are the
    CUDA runtime's and driver's calls (`cu*`, no `::`), whose correlation
    numbers are CUPTI's, not those of the torch ops. A launch takes the
    thread of the op it ran under, where it has one."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    if not evs:
        return []
    base = min(e.start_ns() for e in evs)
    out, op_thread = [], {}
    for e in evs:
        name, cuda, ann = e.name(), e.device_type() == DeviceType.CUDA, e.is_user_annotation()
        if cuda:
            cat = None if ann else "kernel"
        elif ann:
            cat = "user_annotation"
        elif name.startswith("cu") and "::" not in name:
            cat = "cuda_runtime"
        else:
            op_thread[e.correlation_id()] = e.start_thread_id()
            continue
        if cat is not None:
            out.append((e, cat))
    return [{"ph": "X", "cat": cat, "name": e.name(), "pid": 0,
             "tid": (op_thread.get(e.linked_correlation_id(), e.start_thread_id())
                     if cat == "cuda_runtime" else e.start_thread_id()),
             "ts": (e.start_ns() - base) * 1e-3, "dur": e.duration_ns() * 1e-3,
             "args": {"correlation": e.correlation_id()}} for e, cat in out]


def of(ctx) -> Spans | None:
    """The spans of the run's profiled window (kept on `ctx.spans`), or None
    without a trace."""
    cached = getattr(ctx, "spans", None)
    if cached is not None or getattr(ctx, "trace", None) is None:
        return cached
    prof = _profiler_holding(ctx)
    if prof is None:
        return None
    ctx.spans = attribute(events_of(prof))
    return ctx.spans


def ms_per_step(ctx, field: str, names) -> float | None:
    """Device ms per profiled step of the ranges `names`, summed from the
    `field` ("total" or "self") of `of(ctx)`; None without device time in
    the window or where none of the ranges opened in it (a program
    without the spans)."""
    sp = of(ctx)
    if sp is None or sp.device_s <= 0 or not any(sp.opened.get(n) for n in names):
        return None
    amounts = getattr(sp, field)
    return sum(amounts.get(n, 0.0) for n in names) * 1e3 / ctx.profiled_steps

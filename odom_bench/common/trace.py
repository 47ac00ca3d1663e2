"""Reduction of a torch.profiler Chrome trace to what the per-layer metrics
and the result's `breakdown` read: device intervals, kernel sums by name,
busy time and the idle gaps, each gap named by the host ranges open when
it ended (the op whose launch closed it)."""

from __future__ import annotations

import bisect
import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_RANGE = "odom_bench.window"


class Trace(NamedTuple):
    """Times in seconds on the profiler's clock."""

    device: list  # [(name, start, end)] every kernel, copy and fill
    host: list  # [(name, start, end, cat)] host ops and the harness's ranges
    window: tuple  # (start, end) of the harness's window range


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, start = e.get("cat", ""), e["ts"] * 1e-6
        end = start + e.get("dur", 0) * 1e-6
        if cat in DEVICE_CATS:
            device.append((e["name"], start, end))
        elif cat in HOST_CATS:
            host.append((e["name"], start, end, cat))
            if e["name"] == WINDOW_RANGE:
                window = (start, end)
    if window is None:
        raise ValueError(f"trace {path} holds no {WINDOW_RANGE} range")
    device.sort(key=lambda d: d[1])
    return Trace(device, host, window)


def _clipped(tr: Trace) -> list:
    """The device intervals inside the window, clipped to it and merged."""
    w0, w1 = tr.window
    merged = []
    for _, s, e in tr.device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(e - s for s, e in _clipped(tr))


def kernel_seconds(tr: Trace, patterns) -> tuple[float, int]:
    """(summed device seconds, count) of the window's kernels whose name
    holds any of `patterns` (compared in lower case)."""
    w0, w1 = tr.window
    pats = [p.lower() for p in patterns]
    total, count = 0.0, 0
    for name, s, e in tr.device:
        if w0 <= s < w1 and any(p in name.lower() for p in pats):
            total += e - s
            count += 1
    return total, count


def top_device_ops(tr: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time in
    the window, summed by name."""
    w0, w1 = tr.window
    sums: dict[str, float] = {}
    for name, s, e in tr.device:
        if w0 <= s < w1:
            sums[name] = sums.get(name, 0.0) + (e - s)
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], secs] for name, secs in top]


def _open_at(host: list, starts: list, t: float) -> str:
    """'range/op': the innermost harness range and the innermost host op
    open at time t."""
    best = {"user_annotation": None, "cpu_op": None}
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, s, e, cat = host[i]
        if s <= t <= e:
            cur = best[cat]
            if cur is None or e - s < cur[1]:
                best[cat] = (name, e - s)
    parts = [best[c][0] for c in ("user_annotation", "cpu_op") if best[c] is not None]
    return "/".join(parts) if parts else "no host range"


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """[[label, seconds]] of the n longest idle gaps of the window, each
    labelled by the host ranges open when it ended."""
    w0, w1 = tr.window
    gaps, cursor = [], w0
    for s, e in _clipped(tr):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted((h for h in tr.host if h[0] != WINDOW_RANGE), key=lambda h: h[1])
    starts = [h[1] for h in host]
    return [[_open_at(host, starts, e), e - s] for s, e in gaps[:n]]

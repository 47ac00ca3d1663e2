"""Tracing / profiling helpers (counterpart of the JAX package's
`utils/profiling.py`; the reference has none — its diagnostics are cout
pose dumps, reference src/odom_run.cpp:111-112).

`device_trace` records a torch.profiler trace (CPU and, where there is a
card, CUDA activity) and writes it as a Chrome trace; `annotate` names a
region in it (and, on a card, an NVTX range); `StageTimer` is a host-side
stage timer for the runner loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: `with device_trace("/tmp/trace"): step(...)` writes
    `<log_dir>/trace.json` (chrome://tracing, Perfetto) when the block
    ends. Yields the profiler (`key_averages()` for sums by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up in the trace (`record_function`), and as
    an NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StageTimer:
    """Accumulating host-side stage timer.

    with timer.stage("preprocess"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:8.3f}s total  {t / max(n, 1) * 1e3:8.2f}ms avg  x{n}")
        return "\n".join(lines)


def _synchronize(out) -> None:
    """Wait for the devices of every CUDA tensor in `out` (nested tuples,
    lists, dicts)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)

    visit(out)
    for d in devices:
        torch.cuda.synchronize(d)


def block_and_time(fn, *args, repeats: int = 10, **kw):
    """Wall-clock a callable (after one warm-up call), synchronizing the
    devices of its outputs; returns seconds a call."""
    out = fn(*args, **kw)
    _synchronize(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    _synchronize(out)
    return (time.perf_counter() - t0) / repeats

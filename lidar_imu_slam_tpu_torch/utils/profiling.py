"""Tracing helpers (counterpart of the JAX package's `utils/profiling.py`;
the reference has none — its diagnostics are cout pose dumps, reference
src/odom_run.cpp:111-112).

`device_trace` records a torch.profiler trace (CPU and, where there is a
card, CUDA activity) and writes it as a Chrome trace; `annotate` is the
port's one span primitive: a named range in that trace, opened only while
a profiler records, so the spans on the hot path cost a flag read when
tracing is off.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class annotate:
    """A named span, as a `with` block or a function decorator:

        with annotate("kiss_icp.deskew"): ...

        @annotate("voxel_map.insert")
        def insert_grouped(...): ...

    While a profiler records (`torch.profiler.profile`, or
    `torch.autograd.profiler.emit_nvtx`, which turns each range into an
    NVTX range), the span is a `record_function` range on the profiler's
    clock, the clock of the device events in the same trace. Otherwise it
    opens nothing and dispatches no op: the check is one flag read."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned

"""step_ms_p95 (ms, host clock of CUDA events): the 95th percentile of the
intervals between consecutive step-end events over all steps of the
window (the first from the window's start event). Events are recorded on
the stream without a synchronisation and read after the window."""

import numpy as np


def read(ctx):
    steps = getattr(ctx, "step_ms", None)
    if not steps:
        return None
    return float(np.percentile(np.asarray(steps, dtype=np.float64), 95))

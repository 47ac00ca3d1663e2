"""host_enqueue_ms (ms/step, host clock): the host's time to enqueue one
batched step started on an idle card, without a synchronisation inside:
the pace the step would run at if the card took no time. The mean over a
fixed number of steps."""

import numpy as np


def read(ctx):
    enq = getattr(ctx, "enqueue_ms", None)
    if not enq:
        return None
    return float(np.mean(enq))

"""register_self_device_ms (ms/step, device trace): device time per step
of the operations launched inside the port's `kiss_icp.step` and
`icp.register` spans but in none of their nested spans: the registration
glue (guess and pose math, the threshold, ICP anchors, stacks and the
rounds' f64 composition, the map keys and the corrected points)."""

from odom_bench.common import spans

SPANS = ("kiss_icp.step", "icp.register")


def read(ctx):
    return spans.ms_per_step(ctx, "self", SPANS)

"""icp_fetch_device_ms (ms/step, device trace): device time per step of
the operations launched inside the port's `icp.fetch` spans: each ICP
round's f64 -> f32 casts of its transformed source points, their stack
and the candidate fetch from the map. The round's source transform, anchor
and centred queries run before the span opens, in `icp.register`'s self
time (`register_self_device_ms`)."""

from odom_bench.common import spans

SPANS = ("icp.fetch",)


def read(ctx):
    return spans.ms_per_step(ctx, "total", SPANS)

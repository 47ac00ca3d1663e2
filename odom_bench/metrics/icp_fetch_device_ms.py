"""icp_fetch_device_ms (ms/step, device trace): device time per step of
the operations launched inside the port's `icp.fetch` spans: each ICP
round's transform of the source and its candidate gather from the map."""

from odom_bench.common import spans

SPANS = ("icp.fetch",)


def read(ctx):
    return spans.ms_per_step(ctx, "total", SPANS)

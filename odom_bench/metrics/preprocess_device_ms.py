"""preprocess_device_ms (ms/step, device trace): device time per step of
the operations launched inside the port's `preprocess.scan` and
`kiss_icp.deskew` spans (nested spans included): range gate, relative
time, the rotation model's scatter-min, the time sort, the CV deskew."""

from odom_bench.common import spans

SPANS = ("preprocess.scan", "kiss_icp.deskew")


def read(ctx):
    return spans.ms_per_step(ctx, "total", SPANS)

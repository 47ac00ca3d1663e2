"""map_device_ms (ms/step, device trace): device time per step of the
operations launched inside the port's voxel-map spans (nested spans
included): the grouped downsample, the ICP source (first point per voxel
and the IQR mask), the insert and the eviction."""

from odom_bench.common import spans

SPANS = ("voxel_map.downsample", "kiss_icp.source", "voxel_map.insert", "voxel_map.evict")


def read(ctx):
    return spans.ms_per_step(ctx, "total", SPANS)

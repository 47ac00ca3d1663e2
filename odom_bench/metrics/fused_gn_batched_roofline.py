"""fused_gn_batched_roofline (%, device trace): kernel K5's share of its
roofline: the least time of its launches in the profiled window (bytes
once at 3.35 TB/s or f32 operations at 67 TFLOP/s, the longer; counted
from the cell's shapes and the fixed unroll schedule, `batch_unroll_outer`
launches a step of `batch_unroll_inner` iterations each, never from what
the kernel reports) over the device time of the kernels named below."""

from odom_bench.common import roofline, trace

KERNELS = ("gn_cluster_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    secs, count = trace.kernel_seconds(ctx.trace, KERNELS)
    if count == 0 or secs <= 0:
        return None
    icp, mapc = ctx.pipeline["icp"], ctx.pipeline["map"]
    width = mapc["nn_points"] or mapc["max_points_per_voxel"]
    candidates = width * mapc["neighborhood"]
    launch_s, _ = roofline.gn_launch_bound_s(ctx.streams, icp["max_source_points"], candidates,
                                             icp["batch_unroll_inner"])
    launches = ctx.profiled_steps * icp["batch_unroll_outer"]
    return 100.0 * launches * launch_s / secs

"""sort_ms_per_step (ms/step, device trace): device time per step of the
sort kernels (the preprocess time sort and the voxel map's grouping sorts
in `fused_downsample`, `first_point_per_voxel` and the IQR), summed over
the profiled steps by kernel name."""

from odom_bench.common import trace

KERNELS = ("sort",)  # every torch.sort kernel's name holds it (cub radix, bitonic, segmented)


def read(ctx):
    if ctx.trace is None:
        return None
    secs, count = trace.kernel_seconds(ctx.trace, KERNELS)
    if count == 0:
        return None
    return secs * 1e3 / ctx.profiled_steps

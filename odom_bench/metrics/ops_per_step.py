"""ops_per_step (ops/step, program counter): aten ops dispatched per
batched step (gather, preprocess, register), counted by the benchmark's
TorchDispatchMode over a fixed number of steady steps after the profiled
window. The kernels' ctypes launches are not aten ops."""


def read(ctx):
    if getattr(ctx, "opcount_steps", 0) <= 0:
        return None
    return ctx.ops / ctx.opcount_steps

"""setup_s (s, host clock): process start to the window's start: imports,
the kernels' build or load, rendering the drive on the card, fresh
states and the warm-up steps."""


def read(ctx):
    return ctx.setup_s

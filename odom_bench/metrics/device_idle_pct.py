"""device_idle_pct (%, device trace): the share of the profiled window in
which no kernel, copy or fill runs on the card."""


def read(ctx):
    if ctx.trace is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

"""scans_per_s (scans/s, host clock): the scans of every stream whose step
completed in the window, over the window's wall time (which ends in a
synchronize)."""


def read(ctx):
    if not getattr(ctx, "wall_s", None):
        return None
    return ctx.window_steps * ctx.streams / ctx.wall_s

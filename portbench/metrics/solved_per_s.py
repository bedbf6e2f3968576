"""Programs solved at the configuration's accuracy per second: every
program the window solved over the whole window (host clock)."""


def read(ctx):
    return float(ctx.programs.solved(ctx.tolerance).sum()) / ctx.window_s

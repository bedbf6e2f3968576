"""Kernel launches per Newton iteration of the traced call: its kernel
events over its iterations (a batch runs in lockstep, so a batched call
has as many iterations as its longest program)."""


def read(ctx):
    if ctx.trace is None or ctx.traced_iterations <= 0:
        return None
    return ctx.trace.kernels / ctx.traced_iterations

"""Milliseconds of one cone update, prepare_step then take_step of every
cone block, at the window's final iterate and batch (host clock around a
synchronize, median of blocks of repeats): cones/psd.py, algebra/sym.py."""

import torch

from portbench.measure import host_ms


def read(ctx):
    from conex_tpu_torch.cones.base import local_vars

    f = ctx.final
    c_weight = f.k * f.c_scaling

    def update():
        for blk, w in zip(f.blocks, f.ws):
            y = local_vars(f.y, blk.vars_, blk.num_vars)
            cache, norminf, _ = blk.prepare_step(w, y, c_weight, 1.0)
            blk.take_step(w, cache, torch.clamp(2.0 / (norminf * norminf), max=1.0))

    return host_ms(update, ctx.device)

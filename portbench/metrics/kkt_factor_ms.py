"""Milliseconds of one KKT factorization (solver/kkt.py's factor, in the
configuration's KKT mode) of the matrix assembled at the window's final
iterate and batch (host clock around a synchronize, median of blocks of
repeats)."""

from portbench.measure import host_ms


def read(ctx):
    from conex_tpu_torch.solver import kkt, loop

    f, m = ctx.final, ctx.config["m"]
    G = loop.assemble(f.blocks, (), f.ws, m, m, f.y.dtype)[0]
    island = kkt.island_dtype(ctx.solver.kkt_island_dtype)
    return host_ms(lambda: kkt.factor(G, ctx.solver.kkt_solver, island_dtype=island),
                   ctx.device)

"""Share of its roofline that the clamped LDLT of the KKT matrix reaches,
whatever implements it: the least time the card could take for one
factor of the batch (portbench/roofline.py's peaks; the operations and
bytes below, counted from shapes) over the device time of one factor in
one traced call, the busy and idle time charged to the spans conex.ldlt
and conex.ldlt.update (portbench/phases.py) over the port's counter
kkt.ldlt.calls.  Nothing to read off a card the peak table does not hold,
or from a port without the spans or the counter."""

from portbench import phases, roofline

SPANS = ("conex.ldlt", "conex.ldlt.update")


def ldlt_ops(programs: int, order: int) -> int:
    """One LDLT of each of ``programs`` dense symmetric matrices of
    ``order`` N: N^3 / 3 operations, the trailing updates of the
    elimination, (N - j)^2 / 2 multiply-adds at step j by symmetry."""
    return programs * order**3 // 3


def ldlt_bytes(programs: int, order: int, itemsize: int) -> int:
    """The matrix read once and its factor written once."""
    return 2 * programs * order * order * itemsize


def kkt_order(config: dict) -> int:
    """n + k primal variables and k + 1 equality rows: the portfolio QP."""
    return config["n"] + 2 * config["k"] + 1


def read(ctx):
    ph = phases.measure(ctx)
    calls = (ph.counters or {}).get("kkt.ldlt.calls", 0)
    rows = [ph.rows[name] for name in SPANS if name in ph.rows]
    if not calls or not rows or ctx.device.type != "cuda":
        return None
    S, N = ctx.traffic["batch"], kkt_order(ctx.config)
    itemsize = 8 if ctx.dtype == "float64" else 4
    bound = roofline.bound_s(ldlt_ops(S, N), ldlt_bytes(S, N, itemsize), ctx.kind, ctx.dtype)
    if bound is None:
        return None
    spent = sum(r.busy_s + r.idle_s for r in rows) / calls
    ctx.note(f"ldlt at S = {S}, N = {N} {ctx.dtype}: {spent * 1e3!r} ms a factor, "
             f"bound {bound[0] * 1e3!r} ms by {bound[1]}")
    return 100.0 * bound[0] / spent

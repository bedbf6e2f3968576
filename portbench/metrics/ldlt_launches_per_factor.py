"""Kernels launched per clamped LDLT factor in one traced call: the kernel
launches charged to the spans conex.ldlt and conex.ldlt.update
(portbench/phases.py) over the port's counter kkt.ldlt.calls of the call
(solver/kkt.py).  A port without the spans or the counter reads
nothing."""

from portbench import phases

SPANS = ("conex.ldlt", "conex.ldlt.update")


def read(ctx):
    ph = phases.measure(ctx)
    calls = (ph.counters or {}).get("kkt.ldlt.calls", 0)
    rows = [ph.rows[name] for name in SPANS if name in ph.rows]
    if not calls or not rows:
        return None
    return sum(r.launches for r in rows) / calls

"""Share of one traced call's wall in which the device sat idle waiting for
a launch from the clamped LDLT of the KKT matrix: the idle gaps charged to
the spans conex.ldlt and conex.ldlt.update (solver/kkt.py;
portbench/phases.py), over the call's wall.  A port without the spans
reads nothing."""

from portbench import phases

SPANS = ("conex.ldlt", "conex.ldlt.update")


def read(ctx):
    ph = phases.measure(ctx)
    if not any(name in ph.rows for name in SPANS):
        return None
    return ph.idle_pct(SPANS)

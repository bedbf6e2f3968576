"""Share of one traced call's wall in which the device sat idle waiting for
a launch from a Lorentz-cone block: the idle gaps charged to the spans
conex.soc.schur and conex.soc.step (cones/soc.py; portbench/phases.py),
over the call's wall.  A port without the spans reads nothing."""

from portbench import phases

SPANS = ("conex.soc.schur", "conex.soc.step")


def read(ctx):
    ph = phases.measure(ctx)
    if not any(name in ph.rows for name in SPANS):
        return None
    return ph.idle_pct(SPANS)

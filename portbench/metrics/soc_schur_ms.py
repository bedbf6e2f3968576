"""Device busy time a pass of the Lorentz-cone blocks' Schur contribution:
the device time charged to the span conex.soc.schur (SOCCone.schur,
cones/soc.py) in one traced call (portbench/phases.py) over its conex.pass
spans, in ms.  A port without the span, or a call without passes, reads
nothing."""

from portbench import phases

SPAN = "conex.soc.schur"


def read(ctx):
    ph = phases.measure(ctx)
    if SPAN not in ph.rows or not ph.passes:
        return None
    return 1e3 * ph.rows[SPAN].busy_s / ph.passes

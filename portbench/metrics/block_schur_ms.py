"""Device busy time a pass of the cone blocks' Schur contributions: the
device time charged to the span conex.schur in one traced call
(portbench/phases.py) over its conex.pass spans, in ms.  In the portfolio
cell the span holds the LinearCone's and the QuadraticCost's products
(cones/lp.py, cones/qcost.py).  A port without the span, or a call
without passes, reads nothing."""

from portbench import phases

SPAN = "conex.schur"


def read(ctx):
    ph = phases.measure(ctx)
    if SPAN not in ph.rows or not ph.passes:
        return None
    return 1e3 * ph.rows[SPAN].busy_s / ph.passes

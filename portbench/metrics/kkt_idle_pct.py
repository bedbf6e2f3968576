"""Share of one traced call's wall in which the device sat idle waiting for
a launch from the KKT phases: the idle gaps charged to the spans
conex.assemble (outside its conex.schur spans), conex.factor and
conex.kkt_solve (portbench/phases.py), over the call's wall."""

from portbench import phases

SPANS = ("conex.assemble", "conex.factor", "conex.kkt_solve")


def read(ctx):
    return phases.measure(ctx).idle_pct(SPANS)

"""Share of one traced call's wall in which the device sat idle waiting for
a launch from the solve loop's own work: the idle gaps charged to the spans
conex.pass, conex.mu, conex.select, conex.solve and conex.epilogue, each
outside its child spans (portbench/phases.py), over the call's wall."""

from portbench import phases

SPANS = ("conex.pass", "conex.mu", "conex.select", "conex.solve", "conex.epilogue")


def read(ctx):
    return phases.measure(ctx).idle_pct(SPANS)

"""Share of one traced call's wall in which the device sat idle waiting for
a launch from the cone's phases: the idle gaps charged to the spans
conex.prepare_step, conex.take_step, conex.slack_stats and
conex.line_search (portbench/phases.py), over the call's wall."""

from portbench import phases

SPANS = ("conex.prepare_step", "conex.take_step", "conex.slack_stats", "conex.line_search")


def read(ctx):
    return phases.measure(ctx).idle_pct(SPANS)

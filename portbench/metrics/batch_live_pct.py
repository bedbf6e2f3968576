"""Share of a batched call's scenario passes that went to programs not yet
done: the port's counters over one call of batch 0 (portbench/phases.py),
100 x loop.live_scenario_passes / loop.scenario_passes.  Every pass of the
solve loop computes all S scenarios, so 100 less this share is the most
that compacting finished scenarios out of a batch could save."""

from portbench import phases


def read(ctx):
    c = phases.measure(ctx).counters
    if not c or not c.get("loop.scenario_passes"):
        return None
    return 100.0 * c.get("loop.live_scenario_passes", 0) / c["loop.scenario_passes"]

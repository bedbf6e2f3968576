"""Share of one call's warm eigenvalue estimates on the card that replayed
a captured CUDA graph: the port's counters over one call of batch 0
(portbench/phases.py), 100 x sym.warm.replays / sym.warm.calls.  Below 100
the cone launched the estimator's kernels one by one; a port that keeps no
such counters reads nothing."""

from portbench import phases


def read(ctx):
    c = phases.measure(ctx).counters
    if not c or not c.get("sym.warm.calls"):
        return None
    return 100.0 * c.get("sym.warm.replays", 0) / c["sym.warm.calls"]

"""Host syncs per pass of the solve loop in one call (portbench/phases.py):
the sum of the port's sync.<site> counters (each a host read of device data,
or a copy to the device that waits for it) over loop.passes.  A CUDA graph
of the iteration can hold none of them."""

from portbench import phases


def read(ctx):
    c = phases.measure(ctx).counters
    if not c or not c.get("loop.passes"):
        return None
    return sum(v for k, v in c.items() if k.startswith("sync.")) / c["loop.passes"]

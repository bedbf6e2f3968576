"""Share of one call's clamped-LDLT column steps that the port's panel
kernel took: its counters over one call of batch 0 (portbench/phases.py),
100 x kkt.ldlt.kernel_columns / kkt.ldlt.columns (solver/kkt.py).  Below
100 the column steps ran as the plain torch loop; a call without LDLT
columns, or a port without the counters, reads nothing."""

from portbench import phases


def read(ctx):
    c = phases.measure(ctx).counters
    if not c or not c.get("kkt.ldlt.columns"):
        return None
    return 100.0 * c.get("kkt.ldlt.kernel_columns", 0) / c["kkt.ldlt.columns"]

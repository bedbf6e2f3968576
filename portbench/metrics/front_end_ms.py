"""Milliseconds of host time one request spends in the front end, outside
the solve: the self time of the spans conex.call/<n> and conex.program.*
(the checks and copies of add_lmi_constraint, the copy of the result to
numpy, the reads of the duals) in one traced request (portbench/phases.py)."""

from portbench import phases


def read(ctx):
    rows = phases.measure(ctx).rows
    front = [r for name, r in rows.items()
             if name == phases.CALL or name.startswith("conex.program.")]
    if not front:
        return None
    return 1e3 * sum(r.self_s for r in front)

"""Scenario batching: many independent same-structure programs as one solve.

Twin of ``solve_scenarios`` in ``conex_tpu/parallel/sharded.py``.  The JAX
package vmaps one program over the leading scenario axis; the port's solve
loop carries that axis itself, so this is a direct call.  Sharding over
several cards (the ``mesh`` argument, cone sharding) is not ported yet.
"""

from __future__ import annotations

from ..config import SolverConfig, not_ported
from ..solver.loop import _solve_impl


def solve_scenarios(blocks, eq_blocks, b, init_ws, init_scalars,
                    config: SolverConfig, mesh=None, axis: str = "dp"):
    """Solve a batch of same-structure programs, batched over the leading
    scenario axis of every tensor (block data, b, initial state, scalars).
    All tensors live on one device: the solve runs there.  ``mesh`` and
    ``axis`` (the mesh axis the JAX package shards the scenarios over)
    keep the JAX signature; any mesh raises, since sharding is not ported."""
    if mesh is not None:
        raise not_ported("multi-device solves (mesh)", "14")
    return _solve_impl(blocks, eq_blocks, b, init_ws, init_scalars, config)

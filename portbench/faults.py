"""Faults planted in the port's answers, for the readings of the
correctness check (``calibrate.py --faults``) and its CPU tests.

Each wraps the solve that both entries call (``_solve_impl`` as
``parallel/sharded.py`` and ``program.py`` import it) and alters what it
returns, keeping the solver's flags, so every altered program still says
it is solved:

- ``altered``: every program's y moved off its answer, y_0 by 1e-4 of
  (1 + its largest |y|): the gap shows it;
- ``rows``: one program in 16, counted over every program the solve
  returns, altered so: only the share of unsolved programs shows it;
- ``zero``: every answer left at zero, y = 0 and the cone iterates 0,
  so X = 0: the gap is 0, and only the infeasibility shows it
  (err1 = ||b|| / (1 + max|b|)).
"""

from __future__ import annotations

import torch

EVERY = 16


def _move(res, which):
    y = res.y.clone()
    y[which, 0] += 1e-4 * (1.0 + y[which].abs().amax(dim=1))
    return res._replace(y=y)


def altered(res, index):
    return _move(res, torch.ones_like(index, dtype=torch.bool))


def rows(res, index):
    return _move(res, index % EVERY == 0)


def zero(res, index):
    from conex_tpu_torch.cones.base import tree_map

    return res._replace(y=torch.zeros_like(res.y), ws=tree_map(torch.zeros_like, res.ws))


FAULTS = {"altered": altered, "rows": rows, "zero": zero}


def plant(name: str, set_attr=setattr):
    """Plant fault ``name`` with ``set_attr(module, attribute, value)``
    (``monkeypatch.setattr`` in a test); returns a function that takes it
    out again."""
    from conex_tpu_torch import program
    from conex_tpu_torch.parallel import sharded

    alter, solve, seen = FAULTS[name], sharded._solve_impl, [0]

    def planted(*args, **kw):
        res = solve(*args, **kw)
        count = res.y.shape[0]
        index = torch.arange(seen[0], seen[0] + count, device=res.y.device)
        seen[0] += count
        return alter(res, index)

    for module in (sharded, program):
        set_attr(module, "_solve_impl", planted)
    return lambda: [setattr(module, "_solve_impl", solve) for module in (sharded, program)]

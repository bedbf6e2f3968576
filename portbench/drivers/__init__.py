"""The ways a traffic mix drives the port, each a file ``drivers/<name>.py``
found by the mix's ``driver`` key, and what every driver hands back.

A driver module defines ``Driver(problem, config, traffic, device, dtype,
chips)``: ``problem`` is the configuration's class (problems/<class>.py),
which makes the programs and says how they go into the port; ``chips`` is
the cell's, and a driver that cannot use that count raises before it makes
anything.  A ``Driver`` has

- ``cycle``: the calls that go once through the mix's fixed pool, and
  ``chunk_size``: the programs of a generator chunk (check.py makes them
  again by chunk);
- ``call(i)``: the i-th call of the window, returning a record once its
  answer is complete (on the card, after a synchronize);
- ``account(recs)`` -> Programs, ``answers(recs)`` -> [Answers],
  ``final(rec)`` -> Final, ``iterations(rec)``: the Newton iterations of
  one call.

The pool is the mix's fixed set, solved in the same order by every run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import spec


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Programs:
    """Every program the window solved, in call order."""

    iterations: np.ndarray
    solver_solved: np.ndarray  # the solver's flag
    gap: np.ndarray  # relative duality gap of its answer

    def solved(self, tolerance: float) -> np.ndarray:
        return self.solver_solved & (self.gap <= tolerance)


@dataclass
class Answers:
    """What one call returned, for the check: the chunk and the index in
    it of the first program it solved (the rest follow it), their y and
    dual variables, the solver's flags."""

    chunk: int
    start: int
    y: torch.Tensor
    dual: torch.Tensor
    solved: torch.Tensor


@dataclass
class Final:
    """The port's state at the end of a call: its blocks, cone iterates
    and the KKT solution, k and c_scaling of the last iteration, and the
    chunk and index of the program in its first scenario row (the rest
    follow it)."""

    blocks: tuple
    ws: tuple
    y: torch.Tensor
    k: torch.Tensor
    c_scaling: torch.Tensor
    chunk: int
    start: int


def one_chip(name: str, chips: int) -> None:
    """A driver that runs on one card refuses any other count."""
    if chips != 1:
        raise ValueError(f"the {name} driver runs on one chip; the cell asks for {chips}")


def make(config, traffic, device, dtype, chips=1, problem=None):
    """The driver the mix names, on ``chips`` cards, over the programs of
    ``problem``, by default the class the configuration names."""
    problem = problem or spec.problem_of(config)
    driver = spec.load_driver(traffic["driver"]).Driver
    return driver(problem, config, traffic, device, dtype, chips)

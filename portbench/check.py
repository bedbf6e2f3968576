"""Whether what the timed path returned is correct.

The configuration's problem class (problems/<class>.py) judges every
answer the window returned by its plain reference (reference/), on data
its generator makes again once the port's state is freed: its ``judge``
gives each number that its ``NUMBERS`` names, and readings besides that
are not compared (for the control).  dense_sdp's numbers are
``unsolved``, ``infeas`` and ``schur``, with the reading ``infeas_all``.

The run is correct when each number is at most its limit in
limits/<cell>.json.
"""

from __future__ import annotations


def judge(problem, config: dict, traffic: dict, chunk_size: int, answers, sample,
          device) -> dict:
    """The numbers (and readings) of one run, by ``problem``'s check."""
    numbers = problem.judge(config, traffic, chunk_size, answers, sample, device)
    missing = [k for k in problem.NUMBERS if k not in numbers]
    if missing:
        raise ValueError(f"the class's judge gave no {', '.join(missing)}")
    return numbers


def verdict(numbers: dict, limits: dict) -> bool:
    """Every limited number at most its limit (a NaN fails)."""
    return bool(limits) and all(numbers[k] <= limit for k, limit in limits.items())

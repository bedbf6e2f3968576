"""Whether what the timed path returned is correct.

Every answer the window returned (y, the dual X and the solver's flag of
each program) is judged by the plain reference (reference/sdp.py) on data
the generator makes again, once the port's state is freed:

- unsolved: the share of the window's programs that are not solved at
  the configuration's accuracy: the solver's flag is false, or the
  reference's relative duality gap of (y, X) is above the bar;
- infeas: the widest infeasibility (DIMACS errors 1, 2 and 4) of the
  programs that are solved at accuracy, whose gap alone does not show that
  X and y are feasible;
- schur: the Schur phase (DenseLMICone.schur, the kernel the window
  drives, on the window's last block and batch) at the window's final
  iterate, against the reference's, for ``schur`` of its programs drawn
  from the seed: the largest relative error of its five outputs.  It is
  called once more after the window rather than caught inside it: the
  kernel is a function of A, C and W alone, and a hook in the timed path
  would hold the last iteration's outputs (0.5 GB of G at 64 programs of
  m = 1000) or copy them every iteration.

The run is correct when each number is at most its limit in
limits/<cell>.json.  ``infeas_all``, the widest infeasibility of every
program, is a reading for the control, not compared.
"""

from __future__ import annotations

import random
from collections import defaultdict

import torch

from .reference import sdp
from .workload import make_chunk

NUMBERS = ("unsolved", "infeas", "schur")


def schur_sample(seed: int, final, plan: dict) -> list:
    """((chunk, index), W, outputs) of ``plan["schur"]`` rows of the
    final state's first LMI block, from one call of its Schur phase."""
    rng = random.Random(f"portbench-schur:{seed}")
    blk, state = final.blocks[0], final.ws[0]
    out = blk.schur(state)
    count = state.w.shape[0]
    rows = rng.sample(range(count), min(plan["schur"], count))
    keep = lambda t: t.detach().to(torch.float64).clone()
    return [((final.chunk, final.start + r), keep(state.w[r, 0]),
             tuple(keep(x[r]) for x in out)) for r in rows]


def _relative(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def judge(config: dict, traffic: dict, chunk_size: int, answers, schurs, device) -> dict:
    """The numbers (and the reading infeas_all) of one run."""
    n, m, tol = config["n"], config["m"], config["accuracy"]["relative_gap"]
    calls, rows = defaultdict(list), defaultdict(list)
    for a in answers:
        calls[a.chunk].append(a)
    for key, W, out in schurs:
        rows[key[0]].append((key[1], W, out))
    total = solved = 0
    infeas = infeas_all = schur = 0.0
    for chunk in sorted(set(calls) | set(rows)):
        A, C, b = make_chunk(traffic["programs_seed"], chunk, chunk_size, n, m,
                             torch.float64, device)
        for a in calls[chunk]:
            ix = slice(a.start, a.start + a.y.shape[0])
            y, X = a.y.to(device), a.X.to(device)
            ok = a.solved.to(device) & (sdp.relative_gap(C[ix], X, b[ix], y) <= tol)
            bad = sdp.infeasibility(A[ix], C[ix], b[ix], y, X)
            total += a.y.shape[0]
            solved += int(ok.sum())
            infeas_all = max(infeas_all, float(bad.max()))
            if ok.any():
                infeas = max(infeas, float(bad[ok].max()))
        for i, W, out in rows[chunk]:
            ref = sdp.schur(A[i], W.to(device), C[i])
            schur = max(schur, max(_relative(x.to(device), r) for x, r in zip(out, ref)))
        del A, C, b
    return dict(unsolved=1.0 - solved / total, infeas=infeas, schur=schur,
                infeas_all=infeas_all)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every limited number at most its limit (a NaN fails)."""
    return bool(limits) and all(numbers[k] <= limit for k, limit in limits.items())

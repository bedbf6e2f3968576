"""The dense SDP class: upstream's solver comparison
(interfaces/matlab/test/run_solver_comparison.m).

Random dense SDPs maximize b'y s.t. C - sum_i y_i A_i PSD, one LMI per
program, with symmetric A_i uniform in (-1, 1), C = I and b = A(X0) for an
X0 = Y Y' + 0.1 I, Y uniform in (-1, 1), so that every program is
feasible and bounded.  A configuration of this class gives ``n`` and ``m``.
A program counts as solved when the solver says so and the relative
duality gap of its y and dual X (reference/sdp.py) is at most the
configuration's ``relative_gap``.

What a problem class gives the harness, by name (``"class"`` in a
configuration, spec.load_problem); a chunk is a tuple of tensors, each
with a leading program axis:

- ``make(config, seed, chunk, count, dtype, device)``: chunk ``chunk`` of
  the fixed set made from ``seed``, ``count`` programs (workload.py);
- for the ``scenarios`` driver: ``scenario_batch(chunk)`` -> (blocks,
  equality blocks, b), ``scenario_start(blocks, b, dtype, device)`` ->
  (initial states, scalars k, b_scaling, c_scaling), ``scenario_dual(res)``;
- for the ``program`` driver: ``program(arrays, dtype, device)`` ->
  (a ``Program`` holding one program, its b), ``program_dual(prog)``;
- ``gap(chunk, dual, y)``: the relative duality gap of each answer;
- the check: ``NUMBERS`` (the names compared with limits/<cell>.json),
  ``sample(seed, final, plan)`` (a kernel's outputs read from the port's
  final state after the window, as ``plan``, the mix's ``check``, asks)
  and ``judge(config, traffic, chunk_size, answers, sample, device)`` ->
  a dict with every number of NUMBERS, and readings besides.
"""

from __future__ import annotations

import random
from collections import defaultdict

import torch

from portbench.reference import sdp
from portbench.workload import chunk_seed

NUMBERS = ("unsolved", "infeas", "schur")


def make_chunk(seed: int, chunk: int, count: int, n: int, m: int, dtype,
               device):
    """Chunk ``chunk`` of the set made from ``seed``: ``count`` programs, A (count, m, n, n), C (count, n, n), b (count, m),
    made in float64 on ``device`` and returned in ``dtype``."""
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, chunk))
    A = torch.rand((count, m, n, n), generator=gen, **f64).mul_(2.0).sub_(1.0)
    A = (A + A.transpose(-2, -1)).mul_(0.5)
    Y = torch.rand((count, n, n), generator=gen, **f64).mul_(2.0).sub_(1.0)
    X0 = Y @ Y.transpose(-2, -1) + 0.1 * torch.eye(n, **f64)
    b = torch.einsum("gvij,gij->gv", A, X0)
    C = torch.eye(n, **f64).expand(count, n, n).contiguous()
    return A.to(dtype), C.to(dtype), b.to(dtype)


def make(config, seed, chunk, count, dtype, device):
    return make_chunk(seed, chunk, count, config["n"], config["m"], dtype, device)


def scenario_batch(data):
    """One DenseLMICone of the batch's programs, no equality block."""
    from conex_tpu_torch import DenseLMICone

    A, C, b = data
    return (DenseLMICone(A=A[:, None], C=C[:, None]),), (), b


def scenario_start(blocks, b, dtype, device):
    """A cold start: identity states, k = 0, scalings of 1."""
    kw = dict(dtype=dtype, device=device)
    count = b.shape[0]
    scalars = dict(k=torch.zeros(count, **kw), b_scaling=torch.ones(count, **kw),
                   c_scaling=torch.ones(count, **kw))
    return tuple(blk.identity_state(dtype) for blk in blocks), scalars


def scenario_dual(res):
    """X = W / (k b_scaling), as Program.get_dual_variable returns it."""
    return res.ws[0].w[:, 0] / (res.k * res.b_scaling)[:, None, None]


def program(data, dtype, device):
    from conex_tpu_torch import Program

    A, C, b = data
    prog = Program(A.shape[0], dtype=dtype, device=device)
    prog.add_lmi_constraint(A, C)
    return prog, b


def program_dual(prog):
    return prog.get_dual_variable(0)


def gap(data, dual, y):
    _, C, b = data
    return sdp.relative_gap(C, dual, b, y)


# The check.  Every answer the window returned (y, the dual X and the
# solver's flag of each program) is judged by the plain reference
# (reference/sdp.py) on data made again, once the port's state is freed:
#
# - unsolved: the share of the window's programs that are not solved at
#   the configuration's accuracy: the solver's flag is false, or the
#   reference's relative duality gap of (y, X) is above the bar;
# - infeas: the widest infeasibility (DIMACS errors 1, 2 and 4) of the
#   programs that are solved at accuracy, whose gap alone does not show that
#   X and y are feasible;
# - schur: the Schur phase (DenseLMICone.schur, the kernel the window
#   drives, on the window's last block and batch) at the window's final
#   iterate, against the reference's, for ``schur`` of its programs drawn
#   from the seed: the largest relative error of its five outputs.  It is
#   called once more after the window rather than caught inside it: the
#   kernel is a function of A, C and W alone, and a hook in the timed path
#   would hold the last iteration's outputs (0.5 GB of G at 64 programs of
#   m = 1000) or copy them every iteration.
#
# ``infeas_all``, the widest infeasibility of every program, is a reading
# for the control, not compared.


def sample(seed: int, final, plan: dict) -> list:
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
            y, X = a.y.to(device), a.dual.to(device)
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

"""Tracking-error-limited portfolios as second-order cone programs
(Jorion, "Portfolio optimization with tracking-error constraints",
Financial Analysts Journal 59(5), 2003), on the data of the OSQP benchmark
suite's portfolio class (problem_classes/portfolio.py of
github.com/osqp/osqp_benchmarks; problems/osqp_portfolio.py's generator,
the same draws).

A configuration gives k factors and n = 100 k assets.  Each program draws
F (n, k), D and mu as osqp_portfolio does, holds an equal-weighted index
x_b = 1/n with its volatility sigma_b = sqrt(x_b' Sigma x_b), Sigma = F F'
+ diag(D), and caps the portfolio's total volatility at sigma_b and its
tracking error at tau = ``tracking`` sigma_b:

    maximize  mu'x
    s.t.      (sigma_b; sqrt(D) x; f)                 in Q^{1+n+k}
              (tau; sqrt(D) (x - x_b); f - F'x_b)     in Q^{1+n+k}
              F'x = f,  1'x = 1,  0 <= x <= 1.

In conex's form over y = (x, f), m = n + k: maximize b'y with b = (mu, 0);
both cones as one SOCCone of B = 2 cones c_b - A y in Q^{1+n+k} with one A
= [0; -diag(sqrt D), 0; 0, -I_k]; the box as 2n rows c - A y >= 0 (a
LinearCone, A = [I 0; -I 0], c = (1, 0)); the k + 1 rows of F'x - f = 0
and 1'x = 1 (one EqualityBlock).  The KKT matrix is indefinite, of order
n + 2k + 1, and every pass factors it by the clamped LDLT.  The check's
sample needs the ``scenarios`` driver (``program`` builds the same program
through the front end).

A program counts as solved when the solver says so and its objective is
within the configuration's ``relative_gap`` of the optimum that the plain
reference (reference/portfolio_te.py) finds and certifies:
|P(y*) - P(y)| / (1 + |P(y*)|).  The port's duals are not used.
"""

from __future__ import annotations

import math
import random
from collections import OrderedDict, defaultdict

import torch

from portbench import spec
from portbench.reference import portfolio_qp
from portbench.reference import portfolio_te as plain

NUMBERS = ("unsolved", "infeas", "soc", "ldlt")

# The portfolio QP's class: its generator, its Blocks (the cone blocks
# holding the equality blocks), its cold start, chunk digest and factor
# error serve this class as they are.
_QP = spec.load_problem("osqp_portfolio")
Blocks, scenario_start, _digest, factor_error = (
    _QP.Blocks, _QP.scenario_start, _QP._digest, _QP.factor_error)


def make(config, seed, chunk, count, dtype, device):
    """Chunk ``chunk`` of the set made from ``seed``: ``count`` programs,
    F (count, n, k), D and mu (count, n), osqp_portfolio's draws (the
    same numbers for the same seed and chunk), and the tracking limit tau
    / sigma_b (count,) of the configuration, returned in ``dtype``."""
    F, D, mu, _ = _QP.make(dict(config, gamma=1.0), seed, chunk, count, torch.float64,
                          device)
    tracking = torch.full((count,), float(config["tracking"]), dtype=torch.float64,
                          device=device)
    return tuple(t.to(dtype) for t in (F, D, mu, tracking))


def port_data(data):
    """A (P, 2, 1+n+k, m) and c (P, 2, 1+n+k) of both cones, the box's A
    (P, 2n, m) and c (P, 2n), Aeq (P, k + 1, m), beq and b of conex's
    form, in the data's type."""
    F, D, mu, tracking = data
    P, n, k = F.shape
    kw = dict(dtype=F.dtype, device=F.device)
    x_b = torch.full((P, n), 1.0 / n, **kw)
    f_b = (F.transpose(1, 2) @ x_b[..., None])[..., 0]
    sigma = torch.sqrt((D * x_b * x_b).sum(1) + (f_b * f_b).sum(1))
    root = D.sqrt()
    A = torch.zeros((P, 1 + n + k, n + k), **kw)
    A[:, 1:1 + n, :n] = torch.diag_embed(-root)
    A[:, 1 + n:, n:] = -torch.eye(k, **kw)
    risk = torch.cat([sigma[:, None], torch.zeros((P, n + k), **kw)], dim=1)
    track = torch.cat([(tracking * sigma)[:, None], -root * x_b, -f_b], dim=1)
    A_soc = torch.stack([A, A], dim=1)
    c_soc = torch.stack([risk, track], dim=1)
    eye_n = torch.eye(n, **kw)
    A_box = torch.zeros((P, 2 * n, n + k), **kw)
    A_box[:, :n, :n] = eye_n
    A_box[:, n:, :n] = -eye_n
    c_box = torch.cat([torch.ones((P, n), **kw), torch.zeros((P, n), **kw)], dim=1)
    Aeq = torch.zeros((P, k + 1, n + k), **kw)
    Aeq[:, :k, :n] = F.transpose(1, 2)
    Aeq[:, :k, n:] = -torch.eye(k, **kw)
    Aeq[:, k, :n] = 1.0
    beq = torch.zeros((P, k + 1), **kw)
    beq[:, k] = 1.0
    b = torch.cat([mu, torch.zeros((P, k), **kw)], dim=1)
    return A_soc, c_soc, A_box, c_box, Aeq, beq, b


def scenario_batch(data):
    """(Blocks, equality blocks, b) of the batch's programs."""
    from conex_tpu_torch.cones.equality import EqualityBlock
    from conex_tpu_torch.cones.lp import LinearCone
    from conex_tpu_torch.cones.soc import SOCCone

    A_soc, c_soc, A_box, c_box, Aeq, beq, b = port_data(data)
    eq = (EqualityBlock(A=Aeq, b=beq),)
    blocks = Blocks((SOCCone(A=A_soc, c=c_soc), LinearCone(A=A_box, c=c_box)))
    blocks.eq = eq
    return blocks, eq, b


def program(data, dtype, device):
    """One program through the front end: arrays without the program
    axis."""
    from conex_tpu_torch import Program

    one = tuple(torch.as_tensor(a)[None] for a in data)
    A_soc, c_soc, A_box, c_box, Aeq, beq, b = (
        t[0].cpu().numpy() for t in port_data(one))
    prog = Program(b.shape[0], dtype=dtype, device=device)
    prog.add_soc_constraint(A_soc, c_soc)
    prog.add_linear_constraint(A_box, c_box)
    prog.add_equality_constraint(Aeq, beq)
    return prog, b


def program_dual(prog):
    """Both cones' dual; the check does not read it."""
    return prog.get_dual_variable(0)


def scenario_dual(res):
    """Both cones' dual, as Program.get_dual_variable returns it; the
    check does not read it."""
    return 2.0 * res.ws[0] / (res.k * res.b_scaling)[:, None, None]


# The reference optimum of each chunk, solved once where a chunk is first
# judged (when the window's programs are accounted, after the window) and
# found again by the chunk's bytes.
_OPTIMA: "OrderedDict[str, plain.Optimum]" = OrderedDict()
_KEEP = 4


def optimum(data) -> plain.Optimum:
    """The certified reference optimum of every program of a chunk; a
    chunk whose optimum the reference cannot certify raises, and is not
    judged."""
    key = _digest(data)
    if key not in _OPTIMA:
        F, D, mu, tracking = data
        opt = plain.solve_plain(F, D, mu, plain.caps(F, D, tracking))
        if not bool(opt.certified.all()):
            bad = (~opt.certified).nonzero().flatten().tolist()
            raise ValueError(
                f"the reference does not certify programs {bad} of the chunk: "
                f"gap {opt.gap.max().item()!r}, residual {opt.residual.max().item()!r}")
        _OPTIMA[key] = opt
        while len(_OPTIMA) > _KEEP:
            _OPTIMA.popitem(last=False)
    return _OPTIMA[key]


def _objective_error(data, opt, y, ix=slice(None)):
    best = opt.objective[ix]
    got = plain.objective(data[2][ix], y.to(best.device))
    return (got - best).abs() / (1.0 + best.abs())


def gap(data, dual, y):
    """The relative objective error of each answer against the reference
    optimum."""
    return _objective_error(data, optimum(data), y)


def infeasibility(F, D, y, tracking):
    """The widest of the rows' relative residual ||Aeq y - beq|| / (1 +
    ||beq||_inf), the box's largest violation and each cone's, |s_1| - s_0
    of its slack s = c_b - A y over 1 + ||c_b||_inf, per program."""
    F, D, y = (t.to(torch.float64) for t in (F, D, y))
    Aeq, beq = portfolio_qp.rows(F)
    n = F.shape[1]
    rows_err = torch.linalg.vector_norm(
        (Aeq @ y[..., None])[..., 0] - beq, dim=-1) / (1.0 + beq.abs().amax(-1))
    x = y[:, :n]
    box = torch.maximum((-x).amax(-1), (x - 1.0).amax(-1)).clamp(min=0.0)
    A, c = plain.cones(F, D, plain.caps(F, D, tracking))
    s = c - torch.einsum("pbrv,pv->pbr", A, y)
    cone = ((s[..., 1:].norm(dim=-1) - s[..., 0]).clamp(min=0.0)
            / (1.0 + c.abs().amax(-1))).amax(-1)
    return torch.maximum(torch.maximum(rows_err, box), cone)


# The check.  Every answer of the window (y and the solver's flag of each
# program) is judged on data made again once the port's state is freed:
#
# - unsolved: the share of the window's programs that are not solved at
#   the configuration's accuracy: the solver's flag is false, or the
#   objective error against the certified reference optimum is above it;
# - infeas: the widest infeasibility (the rows' relative residual, the
#   box's violation, both cones') of the programs solved at accuracy,
#   whose objective alone does not show that y is feasible;
# - soc: the port's Schur block of the SOCCone (cones/soc.py with
#   algebra/spin.py: G, AW and AQc) at the window's final iterate, for
#   ``soc`` programs of the window's last batch drawn from the seed,
#   against the reference's block written from Q(w) = 2 w w' - det(w) R:
#   the largest relative error of the three, each over its largest entry;
# - ldlt: the port's clamped LDLT of the KKT matrix the port assembles at
#   the final iterate, for ``ldlt`` programs drawn from the seed, against
#   portfolio_qp.ldlt_plain on the matrix the reference assembles from the
#   data and the same iterates: the largest relative error of L (below
#   the diagonal) and of d, each over its largest entry.
#
# Both are computed once more after the window.  ``infeas_all``, the
# widest infeasibility of every program, is a reading for the control,
# not compared.


def sample(seed: int, final, plan: dict) -> list:
    """(number, (chunk, index), iterates, port's output) of ``plan["soc"]``
    and ``plan["ldlt"]`` programs of the final state: both cones' iterate
    with the port's (G, AW, AQc) of the SOCCone, and both cones' and the
    box rows' iterates with the port's factor (unit-lower L below the
    diagonal, d on it) of the KKT matrix it assembles there."""
    from conex_tpu_torch.cones.base import tree_map
    from conex_tpu_torch.config import KKT_SOLVER_LDLT
    from conex_tpu_torch.solver import kkt, loop

    blocks, ws = final.blocks, final.ws
    if not isinstance(blocks, Blocks):
        raise ValueError("the soc and ldlt samples need the equality blocks that the "
                         "scenarios driver's Blocks hold")
    keep = lambda t: t.detach().to(torch.float64).clone()
    count = ws[0].shape[0]
    out = []
    for number in ("soc", "ldlt"):
        rng = random.Random(f"portbench-{number}:{seed}")
        rows = rng.sample(range(count), min(plan.get(number, 0), count))
        if not rows:
            continue
        pick = torch.tensor(rows, device=ws[0].device)
        cut = lambda tree: tree_map(lambda x: x[pick], tree)
        if number == "soc":
            got = cut(blocks[0]).schur(ws[0][pick])
            out += [(number, (final.chunk, final.start + r), (keep(ws[0][r]),),
                     tuple(keep(t[i]) for t in (got.G, got.AW, got.AQc)))
                    for i, r in enumerate(rows)]
            continue
        eq = cut(blocks.eq)
        m = blocks[0].num_vars
        n_kkt = m + sum(e.p for e in eq)
        G = loop.assemble(cut(tuple(blocks)), eq, cut(ws), n_kkt, m, ws[0].dtype)[0]
        M = kkt.factor(G, KKT_SOLVER_LDLT).factor
        out += [(number, (final.chunk, final.start + r), (keep(ws[0][r]), keep(ws[1][r])),
                 (keep(M[i]),))
                for i, r in enumerate(rows)]
    return out


def _widest(*values) -> float:
    """The largest of ``values``, or NaN where one is NaN: a NaN fails."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def schur_error(got, want) -> float:
    """The largest of max |port - plain| / max |plain| over G, AW and AQc."""
    return _widest(*((g - w).abs().max() / w.abs().max().clamp(min=1e-300)
                     for g, w in zip(got, want)))


def judge(config: dict, traffic: dict, chunk_size: int, answers, samples, device) -> dict:
    """The numbers (and the reading infeas_all) of one run."""
    tol = config["accuracy"]["relative_gap"]
    calls, rows = defaultdict(list), defaultdict(list)
    for a in answers:
        calls[a.chunk].append(a)
    for number, key, its, got in samples:
        rows[key[0]].append((number, key[1], its, got))
    total = solved = 0
    infeas = infeas_all = soc = ldlt = 0.0
    for chunk in sorted(set(calls) | set(rows)):
        data = make(config, traffic["programs_seed"], chunk, chunk_size, torch.float64,
                    device)
        opt = optimum(data)
        F, D, _, tracking = data
        for a in calls[chunk]:
            ix = slice(a.start, a.start + a.y.shape[0])
            y = a.y.to(device, torch.float64)
            ok = a.solved.to(device) & (_objective_error(data, opt, y, ix) <= tol)
            bad = infeasibility(F[ix], D[ix], y, tracking[ix])
            total += a.y.shape[0]
            solved += int(ok.sum())
            infeas_all = _widest(infeas_all, bad.max())
            if ok.any():
                infeas = _widest(infeas, bad[ok].max())
        for number, i, its, got in rows[chunk]:
            one = slice(i, i + 1)
            cap = plain.caps(F[one], D[one], tracking[one])
            w_soc = its[0].to(device)[None]
            if number == "soc":
                A, c = plain.cones(F[one], D[one], cap)
                want = tuple(t[0] for t in plain.schur_plain(A, c, w_soc))
                soc = _widest(soc, schur_error(tuple(t.to(device) for t in got), want))
            else:
                K = plain.assemble_plain(F[one], D[one], w_soc, its[1].to(device)[None], cap)
                L, d = portfolio_qp.ldlt_plain(K)
                ldlt = _widest(ldlt, factor_error(got[0].to(device), L[0], d[0]))
        del data
    return dict(unsolved=1.0 - solved / total, infeas=infeas, soc=soc, ldlt=ldlt,
                infeas_all=infeas_all)

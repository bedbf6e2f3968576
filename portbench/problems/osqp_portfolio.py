"""The portfolio QP of the OSQP benchmark suite (Stellato et al., "OSQP: an
operator splitting solver for quadratic programs", Math. Prog. Comp. 12,
2020, appendix "Portfolio optimization"; problem_classes/portfolio.py of
github.com/osqp/osqp_benchmarks).

A configuration gives k factors and n = 100 k assets.  Each program draws
F (n, k) with half its entries nonzero, N(0, 1), D diagonal uniform on
[0, sqrt(k)], mu N(0, 1) and gamma, and is

    minimize  x'Dx + f'f - mu'x / gamma   s.t.  F'x = f,  1'x = 1,  0 <= x <= 1.

In conex's form over y = (x, f), m = n + k: maximize b'y - 1/2 y'Qy with
Q = blockdiag(2D, 2I) and b = (mu / gamma, 0) (a QuadraticCost), the box
as 2n rows c - A y >= 0 (a LinearCone, A = [I 0; -I 0], c = (1, 0)), and
the k + 1 rows of F'x - f = 0 and 1'x = 1 (one EqualityBlock).  The KKT
matrix is indefinite, of order n + 2k + 1, and the solve factors it by
the clamped LDLT every pass.  The check's sample needs the ``scenarios``
driver (``program`` builds the same program through the front end).

A program counts as solved when the solver says so and its objective is
within the configuration's ``relative_gap`` of the optimum that the plain
reference (reference/portfolio_qp.py) finds and certifies:
|P(y*) - P(y)| / (1 + |P(y*)|).  The port's QP duals are not used.
"""

from __future__ import annotations

import hashlib
import random
from collections import OrderedDict, defaultdict

import torch

from portbench.reference import portfolio_qp as plain
from portbench.workload import chunk_seed

NUMBERS = ("unsolved", "infeas", "ldlt")


def make(config, seed, chunk, count, dtype, device):
    """Chunk ``chunk`` of the set made from ``seed``: ``count`` programs,
    F (count, n, k), D and mu (count, n) and gamma (count,), made in
    float64 on ``device`` and returned in ``dtype``.  F's nonzeros are a
    uniform draw of round(density n k) of its entries, as scipy's
    sparse.random places them.  The draws are the device generator's: the
    card's programs are not the CPU's."""
    n, k = config["n"], config["k"]
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, chunk))
    nnz = round(config["density"] * n * k)
    order = torch.rand((count, n * k), generator=gen, **f64).argsort(dim=1)
    mask = torch.zeros((count, n * k), **f64).scatter_(1, order[:, :nnz], 1.0)
    F = (mask * torch.randn((count, n * k), generator=gen, **f64)).reshape(count, n, k)
    D = torch.rand((count, n), generator=gen, **f64) * k ** 0.5
    mu = torch.randn((count, n), generator=gen, **f64)
    gamma = torch.full((count,), float(config["gamma"]), **f64)
    return F.to(dtype), D.to(dtype), mu.to(dtype), gamma.to(dtype)


class Blocks(tuple):
    """The cone blocks of a batch, (QuadraticCost, LinearCone), holding its
    equality blocks as ``eq``: drivers.Final keeps the cone blocks alone,
    and the check's sample assembles the KKT matrix with both."""

    eq: tuple = ()


def port_data(data):
    """Q (P, m, m), A (P, 2n, m), c (P, 2n), Aeq (P, k + 1, m), beq and b
    of conex's form, in the data's type."""
    F, D, mu, gamma = data
    P, n, k = F.shape
    kw = dict(dtype=F.dtype, device=F.device)
    eye_n, eye_k = torch.eye(n, **kw), torch.eye(k, **kw)
    Q = torch.zeros((P, n + k, n + k), **kw)
    Q[:, :n, :n] = torch.diag_embed(2.0 * D)
    Q[:, n:, n:] = 2.0 * eye_k
    A = torch.zeros((P, 2 * n, n + k), **kw)
    A[:, :n, :n] = eye_n
    A[:, n:, :n] = -eye_n
    c = torch.cat([torch.ones((P, n), **kw), torch.zeros((P, n), **kw)], dim=1)
    Aeq = torch.zeros((P, k + 1, n + k), **kw)
    Aeq[:, :k, :n] = F.transpose(1, 2)
    Aeq[:, :k, n:] = -eye_k
    Aeq[:, k, :n] = 1.0
    beq = torch.zeros((P, k + 1), **kw)
    beq[:, k] = 1.0
    b = torch.cat([mu / gamma[:, None], torch.zeros((P, k), **kw)], dim=1)
    return Q, A, c, Aeq, beq, b


def scenario_batch(data):
    """(Blocks, equality blocks, b) of the batch's programs."""
    from conex_tpu_torch.cones.equality import EqualityBlock
    from conex_tpu_torch.cones.lp import LinearCone
    from conex_tpu_torch.cones.qcost import QuadraticCost

    Q, A, c, Aeq, beq, b = port_data(data)
    eq = (EqualityBlock(A=Aeq, b=beq),)
    blocks = Blocks((QuadraticCost(Q=Q), LinearCone(A=A, c=c)))
    blocks.eq = eq
    return blocks, eq, b


def scenario_start(blocks, b, dtype, device):
    """A cold start: identity states, k = 0, scalings of 1."""
    kw = dict(dtype=dtype, device=device)
    count = b.shape[0]
    scalars = dict(k=torch.zeros(count, **kw), b_scaling=torch.ones(count, **kw),
                   c_scaling=torch.ones(count, **kw))
    return tuple(blk.identity_state(dtype) for blk in blocks), scalars


def program(data, dtype, device):
    """One program through the front end: arrays without the program
    axis."""
    from conex_tpu_torch import Program

    one = tuple(torch.as_tensor(a)[None] for a in data)
    Q, A, c, Aeq, beq, b = (t[0].cpu().numpy() for t in port_data(one))
    prog = Program(Q.shape[0], dtype=dtype, device=device)
    prog.add_quadratic_cost(Q)
    prog.add_linear_constraint(A, c)
    prog.add_equality_constraint(Aeq, beq)
    return prog, b


def program_dual(prog):
    """The box rows' dual; the check does not read it."""
    return prog.get_dual_variable(1)


def scenario_dual(res):
    """The box rows' dual, as Program.get_dual_variable returns it; the
    check does not read it."""
    return res.ws[1] / (res.k * res.b_scaling)[:, None]


# The reference optimum of each chunk, solved once where a chunk is first
# judged (when the window's programs are accounted, after the window) and
# found again by the chunk's bytes.
_OPTIMA: "OrderedDict[str, plain.Optimum]" = OrderedDict()
_KEEP = 4


def _digest(data) -> str:
    h = hashlib.sha256()
    for t in data:
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def optimum(data) -> plain.Optimum:
    """The certified reference optimum of every program of a chunk; a
    chunk whose optimum the reference cannot certify raises, and is not
    judged."""
    key = _digest(data)
    if key not in _OPTIMA:
        opt = plain.solve_plain(*data)
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
    _, D, mu, gamma = data
    best = opt.objective[ix]
    got = plain.objective(D[ix], mu[ix], gamma[ix], y.to(best.device))
    return (got - best).abs() / (1.0 + best.abs())


def gap(data, dual, y):
    """The relative objective error of each answer against the reference
    optimum."""
    return _objective_error(data, optimum(data), y)


def infeasibility(F, y):
    """The larger of the rows' relative residual ||Aeq y - beq|| / (1 +
    ||beq||_inf) and the box's largest violation, per program."""
    Aeq, beq = plain.rows(F)
    y = y.to(torch.float64)
    n = F.shape[1]
    rows_err = torch.linalg.vector_norm(
        (Aeq @ y[..., None])[..., 0] - beq, dim=-1) / (1.0 + beq.abs().amax(-1))
    x = y[:, :n]
    box = torch.maximum((-x).amax(-1), (x - 1.0).amax(-1)).clamp(min=0.0)
    return torch.maximum(rows_err, box)


# The check.  Every answer of the window (y and the solver's flag of each
# program) is judged on data made again once the port's state is freed:
#
# - unsolved: the share of the window's programs that are not solved at
#   the configuration's accuracy: the solver's flag is false, or the
#   objective error against the certified reference optimum is above it;
# - infeas: the widest infeasibility (the rows' relative residual, the
#   box's violation) of the programs solved at accuracy, whose objective
#   alone does not show that y is feasible;
# - ldlt: the port's clamped LDLT (solver/kkt.py's factor in LDLT mode,
#   the factor the window runs every pass) of the KKT matrix the port
#   assembles at the window's final iterate, for ``ldlt`` programs of the
#   window's last batch drawn from the seed, against the reference's
#   column loop on the matrix the reference assembles from the data and
#   the same box iterate: the largest relative error of L (below the
#   diagonal) and of d, each over its largest entry.  It is factored once
#   more after the window, as dense_sdp's Schur phase is.
#
# ``infeas_all``, the widest infeasibility of every program, is a reading
# for the control, not compared.


def sample(seed: int, final, plan: dict) -> list:
    """((chunk, index), w, M) of ``plan["ldlt"]`` programs of the final
    state: the box rows' iterate and the port's factor (unit-lower L below
    the diagonal, d on it) of the KKT matrix it assembles there."""
    from conex_tpu_torch.cones.base import tree_map
    from conex_tpu_torch.config import KKT_SOLVER_LDLT
    from conex_tpu_torch.solver import kkt, loop

    blocks, ws = final.blocks, final.ws
    if not isinstance(blocks, Blocks):
        raise ValueError("the ldlt sample needs the equality blocks that the scenarios "
                         "driver's Blocks hold")
    rng = random.Random(f"portbench-ldlt:{seed}")
    count = ws[1].shape[0]
    rows = rng.sample(range(count), min(plan["ldlt"], count))
    pick = torch.tensor(rows, device=ws[1].device)
    cut = lambda tree: tree_map(lambda x: x[pick], tree)
    eq = cut(blocks.eq)
    m = blocks[0].num_vars
    n_kkt = m + sum(e.p for e in eq)
    G = loop.assemble(cut(tuple(blocks)), eq, cut(ws), n_kkt, m, ws[1].dtype)[0]
    M = kkt.factor(G, KKT_SOLVER_LDLT).factor
    keep = lambda t: t.detach().to(torch.float64).clone()
    return [((final.chunk, final.start + r), keep(ws[1][r]), keep(M[i]))
            for i, r in enumerate(rows)]


def factor_error(M, L, d) -> float:
    """The larger of max |L_M - L| / max |L| below the diagonal and
    max |d_M - d| / max |d|, for a factor M held as the port holds it."""
    low = torch.tril(M, -1)
    ref_low = torch.tril(L, -1)
    err_l = (low - ref_low).abs().max() / ref_low.abs().max().clamp(min=1e-300)
    dm = torch.diagonal(M, dim1=-2, dim2=-1)
    err_d = (dm - d).abs().max() / d.abs().max().clamp(min=1e-300)
    return float(torch.maximum(err_l, err_d))


def judge(config: dict, traffic: dict, chunk_size: int, answers, factors, device) -> dict:
    """The numbers (and the reading infeas_all) of one run."""
    tol = config["accuracy"]["relative_gap"]
    calls, rows = defaultdict(list), defaultdict(list)
    for a in answers:
        calls[a.chunk].append(a)
    for key, w, M in factors:
        rows[key[0]].append((key[1], w, M))
    total = solved = 0
    infeas = infeas_all = ldlt = 0.0
    for chunk in sorted(set(calls) | set(rows)):
        data = make(config, traffic["programs_seed"], chunk, chunk_size, torch.float64,
                    device)
        opt = optimum(data)
        F, D = data[0], data[1]
        for a in calls[chunk]:
            ix = slice(a.start, a.start + a.y.shape[0])
            y = a.y.to(device, torch.float64)
            ok = a.solved.to(device) & (_objective_error(data, opt, y, ix) <= tol)
            bad = infeasibility(F[ix], y)
            total += a.y.shape[0]
            solved += int(ok.sum())
            infeas_all = max(infeas_all, float(bad.max()))
            if ok.any():
                infeas = max(infeas, float(bad[ok].max()))
        for i, w, M in rows[chunk]:
            K = plain.assemble_plain(F[i:i + 1], D[i:i + 1], w.to(device)[None])
            L, d = plain.ldlt_plain(K)
            ldlt = max(ldlt, factor_error(M.to(device), L[0], d[0]))
        del data
    return dict(unsolved=1.0 - solved / total, infeas=infeas, ldlt=ldlt,
                infeas_all=infeas_all)

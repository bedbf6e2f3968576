"""The OSQP benchmark's portfolio QP (portbench/problems/osqp_portfolio.py)
through the port's batched entry, against conex_tpu, in f64 on the CPU.

A QuadraticCost, a LinearCone of 2n box rows and one EqualityBlock of
k + 1 rows: the KKT matrix is indefinite and every pass factors it by the
clamped LDLT.  Tolerances are tests/test_torch_equality_qp.py's: the
trajectory at rtol 1e-8 while the scaled k stays at or below K_HOLD, the
iteration counts within its five final-centering steps past it (these
programs run to k = 2e5).  Also: the batched entries solve equality
blocks in LDLT mode where LLT is asked for, as Program.solve does; the
LDLT's spans nest inside conex.factor and its counters count; and the QP
duals that conex recovers, the port's equal to the JAX package's, do not
satisfy stationarity in either (a standing fact, ROADMAP)."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

import conex_tpu
from conex_tpu.cones.equality import EqualityBlock as JEq
from conex_tpu.cones.lp import LinearCone as JLinear
from conex_tpu.cones.qcost import QuadraticCost as JCost

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.solver import kkt as tkkt
from conex_tpu_torch.utils import profiling
from conex_tpu_torch.utils.profiling import counters

from portbench import spec
from test_torch_equality_qp import _assert_same_batch, _batch_result

PROBLEM = spec.load_problem("osqp_portfolio")
CONFIG = dict(spec.load_config("osqp_portfolio_k10"), k=1, n=100)
SOLVER = dict(CONFIG["solver"])


def _portfolios(S, chunk=0):
    """S portfolio QPs of k = 1, n = 100 as the cell's generator makes
    them: numpy Q, A, c, Aeq, beq, b, each with the program axis."""
    data = PROBLEM.make(CONFIG, 0, chunk, S, torch.float64, "cpu")
    return [t.numpy() for t in PROBLEM.port_data(data)]


def _torch_batch(Q, A, c, Aeq, beq):
    blocks = (convert.quadratic_cost(Q), convert.linear_cone(A, c))
    ws = (torch.zeros((Q.shape[0], 0), dtype=torch.float64),
          torch.ones(c.shape, dtype=torch.float64))
    return blocks, (convert.equality_block(Aeq, beq),), ws


def _scalars(S):
    return dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))


def test_a_batch_of_four_portfolios_matches_jax():
    S = 4
    Q, A, c, Aeq, beq, b = _portfolios(S)
    blocks, eq, ws = _torch_batch(Q, A, c, Aeq, beq)
    rj, rt = _batch_result(
        [JCost(Q=jnp.asarray(Q)), JLinear(A=jnp.asarray(A), c=jnp.asarray(c))],
        [JEq(A=jnp.asarray(Aeq), b=jnp.asarray(beq))], blocks, eq, b,
        [jnp.zeros((S, 0)), jnp.ones(c.shape)], ws, SOLVER)
    assert rj.solved.all() and rt.solved.all()
    _assert_same_batch(rt, rj)
    np.testing.assert_array_equal(rt.num_iterations, rj.num_iterations)
    np.testing.assert_allclose(rt.y, rj.y, rtol=0, atol=1e-8)
    # Both sit at the optimum the reference certifies.
    data = PROBLEM.make(CONFIG, 0, 0, S, torch.float64, "cpu")
    assert PROBLEM.gap(data, None, torch.as_tensor(rt.y)).max() <= 1e-8


def test_equality_blocks_under_llt_solve_as_under_ldlt():
    """solve_scenarios switches to LDLT where equality blocks come with
    LLT (Program.solve's rule): the same result, field for field; a
    batch without them keeps LLT."""
    S = 2
    Q, A, c, Aeq, beq, b = _portfolios(S, chunk=1)
    blocks, eq, ws = _torch_batch(Q, A, c, Aeq, beq)
    runs = {}
    for mode in (ct.KKT_SOLVER_LLT, ct.KKT_SOLVER_LDLT):
        before = counters["kkt.ldlt.calls"]
        res = ct.solve_scenarios(blocks, eq, convert.tensor(b), ws,
                                 convert.scalars(_scalars(S)),
                                 ct.SolverConfig(**dict(SOLVER, kkt_solver=mode)))
        runs[mode] = (res, counters["kkt.ldlt.calls"] - before)
    (llt, llt_factors), (ldlt, ldlt_factors) = runs[ct.KKT_SOLVER_LLT], runs[ct.KKT_SOLVER_LDLT]
    assert llt.solved.all() and llt_factors == ldlt_factors == int(llt.num_iterations.max()) + 1
    for name, x in llt._asdict().items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, getattr(ldlt, name)), name
    before = counters["kkt.ldlt.calls"]
    box_only = ct.solve_scenarios(
        blocks, (), convert.tensor(b), ws, convert.scalars(_scalars(S)),
        ct.SolverConfig(**dict(SOLVER, kkt_solver=ct.KKT_SOLVER_LLT, max_iterations=3)))
    assert counters["kkt.ldlt.calls"] == before and not box_only.fail.any()


def test_the_ldlt_spans_nest_inside_the_factor_and_its_counters_count(tmp_path):
    """One LDLT factor of a 205 x 205 portfolio KKT matrix (k = 2, two
    panels of 128): one conex.ldlt inside conex.factor, one
    conex.ldlt.update (the panel's solve and trailing update) inside it;
    kkt.ldlt.calls counts the factor and kkt.ldlt.columns its 205
    columns.  _ldlt_scalar entered directly opens its own span."""
    from portbench.reference import portfolio_qp as plain

    F, D, _, _ = PROBLEM.make(dict(CONFIG, k=2, n=200), 0, 0, 1, torch.float64, "cpu")
    w = torch.rand((1, 400), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    K = plain.assemble_plain(F, D, w + 0.5)
    before = counters.copy()
    with profiling.trace(tmp_path):
        tkkt.factor(K, ct.KKT_SOLVER_LDLT)
        tkkt._ldlt_scalar(K[:, :50, :50])
    diff = {k: counters[k] - before.get(k, 0) for k in ("kkt.ldlt.calls", "kkt.ldlt.columns")}
    assert diff == {"kkt.ldlt.calls": 2, "kkt.ldlt.columns": 205 + 50}
    (path,) = tmp_path.glob("*.json")
    spans = sorted((e["ts"], -e["dur"], e["name"])
                   for e in json.loads(path.read_text())["traceEvents"]
                   if str(e.get("name", "")).startswith("conex.") and "dur" in e
                   and not str(e.get("cat", "")).startswith("gpu"))
    parents, stack = [], []
    for ts, neg, name in spans:
        while stack and stack[-1][1] <= ts:
            stack.pop()
        parents.append((name, stack[-1][0] if stack else None))
        stack.append((name, ts - neg))
    assert parents == [("conex.factor", None), ("conex.ldlt", "conex.factor"),
                       ("conex.ldlt.update", "conex.ldlt"), ("conex.ldlt", None)]


def test_the_qp_duals_agree_with_jax_and_miss_stationarity_in_both():
    """On a k = 1 portfolio through Program: the box rows' dual z and the
    equality dual lambda of the port equal the JAX package's, and in both
    b - Q y - A'z - Aeq'lambda stays far from 0 (0.43 on this program):
    conex's dual recovery for a quadratic cost, not a port fault."""
    Q, A, c, Aeq, beq, b = (x[0] for x in _portfolios(1))
    duals = []
    for pkg, kw in ((conex_tpu, {}), (ct, dict(device="cpu"))):
        prog = pkg.Program(Q.shape[0], **kw)
        prog.add_quadratic_cost(Q)
        prog.add_linear_constraint(A, c)
        prog.add_equality_constraint(Aeq, beq)
        res = prog.solve(b, pkg.SolverConfig(**SOLVER))
        assert res.solved
        z, lam = np.asarray(prog.get_dual_variable(1)), np.asarray(prog.get_equality_dual(0))
        y = np.asarray(res.y)
        duals.append((z, lam, np.abs(b - Q @ y - A.T @ z - Aeq.T @ lam).max()))
    (zj, lj, rj), (zt, lt, rt) = duals
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-8 * np.abs(zj).max())
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-8 * np.abs(lj).max())
    assert rt == pytest.approx(rj, rel=1e-6) and rt > 0.1

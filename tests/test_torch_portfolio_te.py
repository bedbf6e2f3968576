"""Tracking-error-limited portfolios as SOCPs (portbench/problems/
portfolio_te.py) through the port's batched entry and its front end, in
f64 on the CPU at n = 40, k = 4, against the plain reference
(portbench/reference/portfolio_te.py).

Each program is two Lorentz cones of dimension 1 + n + k in one SOCCone
(B = 2), 2n box rows in a LinearCone and k + 1 equality rows, so every
pass runs the SOC's Schur block and steps, the divergence mu update and
the clamped LDLT.  Also: the SOC's Schur block against the reference's,
written from Q(w) = 2 w w' - det(w) R; the reference's certificate; and
the reference against portfolio_qp's with the tracking cone left out."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import conex_tpu_torch as ct
from conex_tpu_torch.cones.soc import SOCCone

from portbench import spec
from portbench.reference import portfolio_qp
from portbench.reference import portfolio_te as plain
from portbench.workload import solver_config

PROBLEM = spec.load_problem("portfolio_te")
CONFIG = dict(spec.load_config("portfolio_te_k10"), k=4, n=40)
S = 3


def _batch(chunk=0, count=S):
    data = PROBLEM.make(CONFIG, 0, chunk, count, torch.float64, "cpu")
    blocks, eq, b = PROBLEM.scenario_batch(data)
    ws, scalars = PROBLEM.scenario_start(blocks, b, torch.float64, "cpu")
    res = ct.solve_scenarios(blocks, eq, b, ws, scalars, solver_config(CONFIG))
    return data, res


def test_the_batched_solve_reaches_the_certified_optimum():
    data, res = _batch()
    assert res.solved.all() and not res.fail.any()
    gap = PROBLEM.gap(data, PROBLEM.scenario_dual(res), res.y)
    assert float(gap.max()) <= 1e-7
    F, D, _, tracking = data
    assert float(PROBLEM.infeasibility(F, D, res.y, tracking).max()) <= 1e-9


def test_the_program_route_gives_the_same_answer():
    """Program with add_soc_constraint (both cones at once),
    add_linear_constraint and add_equality_constraint solves program 1
    of the batch to the same y, in as many iterations."""
    data, res = _batch()
    one = tuple(t[1] for t in data)
    prog, b = PROBLEM.program(one, torch.float64, "cpu")
    got = prog.solve(b, solver_config(CONFIG))
    assert got.solved and got.num_iterations == int(res.num_iterations[1])
    np.testing.assert_allclose(got.y, res.y[1].numpy(), rtol=0, atol=1e-10)


def _interior(shape, generator):
    """Random points strictly inside the Lorentz cone."""
    w = torch.randn(shape, dtype=torch.float64, generator=generator)
    w[..., 0] = w[..., 1:].norm(dim=-1) * (1.0 + torch.rand(shape[:-1], dtype=torch.float64,
                                                              generator=generator))
    return w


# The SOC's Schur block at a random interior iterate agrees with the plain
# block to a few ulps of its largest entry in f64 (1e-15 measured); float32
# arithmetic misses it by seven orders.
SCHUR_TOL = 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_soc_schur_block_matches_the_plain_one(dtype):
    data = PROBLEM.make(CONFIG, 0, 1, 2, torch.float64, "cpu")
    A, c = PROBLEM.port_data(data)[:2]
    w = _interior(c.shape, torch.Generator().manual_seed(3))
    got = SOCCone(A=A.to(dtype), c=c.to(dtype)).schur(w.to(dtype))
    want = plain.schur_plain(A, c, w)
    err = PROBLEM.schur_error((got.G, got.AW, got.AQc), want)
    assert (err <= SCHUR_TOL) == (dtype == torch.float64), err
    assert float(got.w_dot_c.double().sub(2.0 * (w * c).sum((1, 2))).abs().max()) <= (
        1e-12 if dtype == torch.float64 else 1e-3)


def test_the_reference_certifies_its_answers_by_its_own_multipliers():
    """The certificate holds where it is given: slack and multipliers
    inside K, the cone rows' slack from v, primal and dual objective
    within the gap; a solve stopped after four iterations is refused."""
    F, D, mu, tracking = PROBLEM.make(CONFIG, 0, 0, S, torch.float64, "cpu")
    cap = plain.caps(F, D, tracking)
    opt = plain.solve_plain(F, D, mu, cap)
    assert bool(opt.certified.all())
    assert float(opt.gap.max()) <= plain.GAP_BAR and float(opt.residual.max()) <= plain.RESIDUAL_BAR
    n, k = CONFIG["n"], CONFIG["k"]
    x = opt.v[:, :n]
    E, e = portfolio_qp.rows(F)
    assert float(((E @ opt.v[..., None])[..., 0] - e).abs().max()) <= 1e-10
    assert float(x.min()) >= -1e-10 and float(x.max()) <= 1 + 1e-10
    A, c = plain.cones(F, D, cap)
    s = c - torch.einsum("pbrv,pv->pbr", A, opt.v)
    assert float((s[..., 1:].norm(dim=-1) - s[..., 0]).max()) <= 1e-10
    z = opt.z[:, 2 * n:].reshape(S, 2, 1 + n + k)
    assert bool((z[..., 0] >= z[..., 1:].norm(dim=-1)).all())
    # The dual objective: the box's multipliers times its bounds, the
    # cones' times their c, less the budget's.
    dual = opt.z[:, :n].sum(-1) + (c * z).sum((1, 2)) - opt.lam[:, k]
    assert float(((opt.objective - dual).abs() / (1 + opt.objective.abs())).max()) <= 1e-8
    stopped = plain.solve_plain(F, D, mu, cap, max_iterations=4)
    assert not bool(stopped.certified.any())


def test_without_the_tracking_cone_the_reference_is_the_qp_at_its_risk_multiplier():
    """With the total-risk cone alone, the SOCP's optimum solves the
    portfolio QP minimize x'Dx + f'f - mu'x / gamma at gamma = z_0 /
    (2 sigma), z_0 the cone's multiplier: stationarity of mu'x - z_0
    (|(sqrt(D) x, f)| - sigma) is that of mu'x - gamma (x'Dx + f'f) where
    the cone is active."""
    F, D, mu, tracking = PROBLEM.make(CONFIG, 0, 2, S, torch.float64, "cpu")
    cap = plain.caps(F, D, tracking)
    opt = plain.solve_plain(F, D, mu, cap, tracking=False)
    assert bool(opt.certified.all())
    n = CONFIG["n"]
    z0 = opt.z[:, 2 * n]
    assert float(z0.min()) > 1e-3  # the risk cap binds
    gamma = z0 / (2.0 * cap.sigma)
    qp = portfolio_qp.solve_plain(F, D, mu, gamma)
    assert bool(qp.certified.all())
    np.testing.assert_allclose(opt.v.numpy(), qp.v.numpy(), rtol=0, atol=1e-6)
    risk = (D * qp.v[:, :n] ** 2).sum(-1) + (qp.v[:, n:] ** 2).sum(-1)
    np.testing.assert_allclose(risk.sqrt().numpy(), cap.sigma.numpy(), rtol=1e-6)

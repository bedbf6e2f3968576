"""The port's indefinite-KKT half (equality constraints, quadratic costs,
Q-weighted quadratic cones; the LDLT and QR KKT modes) against conex_tpu,
end to end, in f64 on the CPU.

The models are the JAX package's own tests (tests/test_equality.py,
test_qp.py, test_quadratic_cone.py and the dense cases of
test_failure_corpus.py), built in both packages from the same numpy
inputs.  Tolerances:

* where no LDLT pivot is clamped, the trajectory: ``fail`` and ``solved``
  equal, ``stats_k`` and ``stats_dinf`` at rtol 1e-8 (the bar of
  tests/test_torch_lp.py: the same f64 arithmetic, sums in other orders)
  while the scaled k stays at or below K_HOLD = 1e3; where the whole run
  does, ``num_iterations`` equal and ``y`` and ``y_kkt`` at rtol 1e-8 too.
  Past K_HOLD the KKT systems are conditioned so that one rounding moves
  the trajectory further than 1e-8 in the JAX package alone
  (``test_the_endgame_moves_as_far_in_jax_alone``): there each model's
  own assertions hold on both packages, and the iteration counts agree
  within the five final-centering steps.  An LMI block carries the f32
  eigenvector sweep, which rounds differently in XLA and PyTorch (see
  tests/test_torch_solve.py): its model is held at that file's 1e-6;
* where a pivot is clamped to +/-1e-9, the clamp amplifies rounding by
  up to 1e9, so the trajectory is not held: the JAX test's own
  assertions hold on both packages, and ``fail`` and ``solved`` are
  equal.  Each test checks which of the two cases it is in;
* QR on a rank-deficient K: R's diagonal is at rounding level, so y
  depends on the LAPACK routine's rounding; the case is held by its
  outcome (solved, feasible to 1e-6, and LLT failing on the program).
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import conex_tpu
from conex_tpu.cones.equality import EqualityBlock as JEq
from conex_tpu.cones.lp import LinearCone as JLinear
from conex_tpu.cones.qcost import QuadraticCost as JCost
from conex_tpu.cones.quadratic import QuadraticCone as JQuad
from conex_tpu.parallel.sharded import solve_scenarios as jsolve

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.solver import kkt as tkkt

from test_equality import build_instance
from test_qp import QP_CONFIG, qp_with_solution

QP = {f.name: getattr(QP_CONFIG, f.name) for f in dataclasses.fields(QP_CONFIG)}


@pytest.fixture
def clamps(monkeypatch):
    """A list that gains, for each LDLT column step of the port, whether
    a pivot of any scenario was clamped."""
    fired = []
    clamp = tkkt._clamp_pivot

    def record(d):
        fired.append(bool((d.abs() < tkkt.LDLT_PIVOT_CLAMP).any()))
        return clamp(d)

    monkeypatch.setattr(tkkt, "_clamp_pivot", record)
    return fired


def _both(m, build):
    jp, tp = conex_tpu.Program(m), ct.Program(m, device="cpu")
    build(jp)
    build(tp)
    return jp, tp


def _solve(jp, tp, b, **cfg):
    jr = jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tr = tp.solve(b, ct.SolverConfig(**cfg))
    return jr, tr


class _Run(NamedTuple):
    """One program's run: of a Program's Result, or a batch's scenario."""

    solved: bool
    fail: bool
    num_iterations: int
    stats_k: np.ndarray
    stats_dinf: np.ndarray
    y: np.ndarray
    y_kkt: np.ndarray


def _run(res, s=None):
    """The _Run of a Program Result, or of scenario s of a batch's numpy
    SolveResult."""
    if s is None:
        raw = res._raw
        return _Run(bool(res.solved), bool(raw.fail), int(res.num_iterations),
                    raw.stats_k, raw.stats_dinf, res.y, raw.y_kkt)
    return _Run(bool(res.solved[s]), bool(res.fail[s]), int(res.num_iterations[s]),
                res.stats_k[s], res.stats_dinf[s], res.y[s], res.y_kkt[s])


def _assert_same_outcome(tr, jr):
    tr, jr = (x if isinstance(x, _Run) else _run(x) for x in (tr, jr))
    assert tr.solved == jr.solved
    assert tr.fail == jr.fail
    assert np.isfinite(tr.y).all() and np.isfinite(jr.y).all()


# The scaled k up to which a trajectory is held to 1e-8 (see the docstring).
K_HOLD = 1e3


def _close(got, want, rtol):
    """|got - want| <= rtol |want| in the 2-norm: an entry of a solution
    vector may cancel to 0, its rounding is the vector's."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want), (got, want)


def _held(jr):
    """The iterations of the JAX run before its scaled k first exceeds
    K_HOLD."""
    k = jr.stats_k[:jr.num_iterations]
    past = np.flatnonzero(k > K_HOLD)
    return int(past[0]) if past.size else jr.num_iterations


def _assert_same_trajectory(tr, jr, rtol=1e-8, hold_y=True):
    tr, jr = (x if isinstance(x, _Run) else _run(x) for x in (tr, jr))
    _assert_same_outcome(tr, jr)
    n = _held(jr)
    np.testing.assert_allclose(tr.stats_k[:n], jr.stats_k[:n], rtol=rtol)
    # d_inf = max |w (A y - k c) + 1| ends as a difference of O(1) terms
    # (0.003 in test_equality_kkt): its rounding is absolute, not relative.
    np.testing.assert_allclose(tr.stats_dinf[:n], jr.stats_dinf[:n], rtol=rtol,
                               atol=rtol)
    if n < jr.num_iterations:
        assert abs(tr.num_iterations - jr.num_iterations) <= 5
        return
    assert tr.num_iterations == jr.num_iterations
    if hold_y:
        _close(tr.y, jr.y, rtol)
        _close(tr.y_kkt, jr.y_kkt, rtol)


# ---------------------------------------------------------------------------
# tests/test_equality.py
# ---------------------------------------------------------------------------


def test_equality_kkt_matches_jax(clamps):
    A, c, Aeq, beq, b = build_instance(np.random.default_rng(0))

    def build(p):
        p.add_linear_constraint(A, c)
        p.add_equality_constraint(Aeq, beq)

    jp, tp = _both(5, build)
    jr, tr = _solve(jp, tp, b, max_iterations=60, prepare_dual_variables=True)
    assert clamps and not any(clamps)  # the LDLT ran and clamped nothing
    _assert_same_trajectory(tr, jr)
    assert tr.solved
    assert np.linalg.norm(Aeq @ tr.y - beq) < 1e-8
    assert (c - A @ tr.y).min() >= -1e-8
    x, lam = tp.get_dual_variable(0), tp.get_equality_dual(0)
    assert np.linalg.norm(A.T @ x + Aeq.T @ lam - b) < 1e-5
    assert x.min() >= -1e-9
    np.testing.assert_allclose(x, jp.get_dual_variable(0), rtol=1e-8)
    np.testing.assert_allclose(lam, jp.get_equality_dual(0), rtol=1e-8)


def test_equality_known_optimum_matches_jax(clamps):
    m = 3
    A = np.vstack([np.eye(m), -np.eye(m)])
    c = np.concatenate([np.ones(m), np.zeros(m)])
    b = np.array([1.0, 1.0, 0.0])

    def build(p):
        p.add_linear_constraint(A, c)
        p.add_equality_constraint(np.ones((1, m)), np.array([1.0]))

    jp, tp = _both(m, build)
    jr, tr = _solve(jp, tp, b, max_iterations=60)
    assert not any(clamps)
    _assert_same_trajectory(tr, jr)
    assert tr.solved
    assert b @ tr.y == pytest.approx(1.0, abs=1e-6)
    assert tr.y.sum() == pytest.approx(1.0, abs=1e-8)


def test_many_equality_blocks_vs_one_match_jax(clamps):
    rng = np.random.default_rng(1)
    A, c, _, _, b = build_instance(rng, p=0)
    Aeq = rng.uniform(-1, 1, (3, 5))
    beq = Aeq @ (0.05 * rng.uniform(-1, 1, 5))

    def one(p):
        p.add_linear_constraint(A, c)
        p.add_equality_constraint(Aeq, beq)

    def many(p):
        p.add_linear_constraint(A, c)
        for i in range(3):
            assert p.add_equality_constraint(Aeq[i:i + 1], beq[i:i + 1]) == i

    results = []
    for build in (one, many):
        jp, tp = _both(5, build)
        jr, tr = _solve(jp, tp, b, max_iterations=60)
        _assert_same_trajectory(tr, jr)
        results.append(tr)
    assert not any(clamps)
    assert results[0].solved and results[1].solved
    np.testing.assert_allclose(results[0].y, results[1].y, atol=1e-7)


def test_equality_with_sdp_matches_jax(clamps):
    """An LMI block and an equality row through K1's plain version and the
    LDLT; held at 1e-6 (the f32 eigenvector sweep, see the docstring)."""
    rng = np.random.default_rng(2)
    m, n = 4, 4
    As = np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, n, n))])
    C = 0.5 * (lambda M: M + M.T)(rng.uniform(-1, 1, (n, n))) + 3 * np.eye(n)
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T + 0.1 * np.eye(n)
    Aeq = rng.uniform(-1, 1, (1, m))
    beq = Aeq @ (0.05 * rng.uniform(-1, 1, m))
    b = np.einsum("vij,ij->v", As, X0) + Aeq.T @ rng.uniform(-1, 1, 1)

    def build(p):
        p.add_lmi_constraint(As, C)
        p.add_equality_constraint(Aeq, beq)

    jp, tp = _both(m, build)
    jr, tr = _solve(jp, tp, b, max_iterations=60)
    assert not any(clamps)
    _assert_same_trajectory(tr, jr, rtol=1e-6)
    assert tr.solved
    assert abs(Aeq @ tr.y - beq)[0] < 1e-7
    S = C - np.einsum("v,vij->ij", tr.y, As)
    assert np.linalg.eigvalsh(S).min() >= -1e-7


def test_equality_program_forces_ldlt_unless_qr_is_asked():
    """With equality rows, LLT (the default) becomes LDLT, as in the JAX
    package (program.py:424-431); QR stays QR."""
    A, c, Aeq, beq, _ = build_instance(np.random.default_rng(0))
    jp, tp = _both(5, lambda p: p.add_equality_constraint(Aeq, beq))
    for mode in (ct.KKT_SOLVER_LLT, ct.KKT_SOLVER_LDLT, ct.KKT_SOLVER_QR):
        got = tp._default_config(ct.SolverConfig(kkt_solver=mode)).kkt_solver
        want = jp._default_config(conex_tpu.SolverConfig(kkt_solver=mode)).kkt_solver
        assert got == want == (mode if mode else ct.KKT_SOLVER_LDLT)
    assert tp._default_config(None).kkt_solver == ct.KKT_SOLVER_LDLT
    lp_only = ct.Program(5, device="cpu")
    lp_only.add_linear_constraint(A, c)
    assert lp_only._default_config(None).kkt_solver == ct.KKT_SOLVER_LLT


def test_equality_program_in_qr_mode_matches_jax():
    A, c, Aeq, beq, b = build_instance(np.random.default_rng(0))

    def build(p):
        p.add_linear_constraint(A, c)
        p.add_equality_constraint(Aeq, beq)

    jp, tp = _both(5, build)
    jr, tr = _solve(jp, tp, b, max_iterations=60, kkt_solver=ct.KKT_SOLVER_QR,
                    iterative_refinement_iterations=1)
    _assert_same_trajectory(tr, jr)
    assert tr.solved and np.linalg.norm(Aeq @ tr.y - beq) < 1e-8


def test_get_feasible_objective_with_equality_rows_matches_jax():
    A, c, Aeq, beq, _ = build_instance(np.random.default_rng(3))

    def build(p):
        p.add_linear_constraint(A, c)
        p.add_equality_constraint(Aeq, beq)

    jp, tp = _both(5, build)
    np.testing.assert_allclose(tp.get_feasible_objective(),
                               np.asarray(jp.get_feasible_objective()), rtol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_qp.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,num_ineqs", [(5, 10), (10, 20)])
def test_random_qp_matches_jax(n, num_ineqs):
    W, A, b, c, x_opt, slack_opt = qp_with_solution(n, num_ineqs,
                                                    np.random.default_rng(0))

    def build(p):
        p.add_quadratic_cost(W)
        p.add_linear_constraint(-A, b)

    jp, tp = _both(n, build)
    jr, tr = _solve(jp, tp, -c, **QP)
    _assert_same_trajectory(tr, jr)
    assert tr.solved
    np.testing.assert_allclose(tr.y, x_opt, atol=1e-9)
    np.testing.assert_allclose(A @ tr.y + b, slack_opt, atol=1e-9)
    # The cost's dual variable is its empty state, in both packages.
    assert tp.get_dual_variable(0).shape == np.shape(jp.get_dual_variable(0)) == (0,)
    for res in (tr, jr):
        assert res.solved
        np.testing.assert_allclose(res.y, x_opt, atol=1e-9)
    # The LP duals: the active rows' lambda, 0 elsewhere (1e-11 here).
    x_t, x_j = tp.get_dual_variable(1), jp.get_dual_variable(1)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-8 * np.abs(x_j).max())


def test_qp_unconstrained_minimum_inside_matches_jax():
    rng = np.random.default_rng(1)
    n = 4
    M = rng.uniform(-1, 1, (n, n))
    Q = M @ M.T + n * np.eye(n)
    b = rng.uniform(-0.1, 0.1, n)
    A = np.vstack([np.eye(n), -np.eye(n)])

    def build(p):
        p.add_quadratic_cost(Q)
        p.add_linear_constraint(A, np.full(2 * n, 10.0))

    jp, tp = _both(n, build)
    jr, tr = _solve(jp, tp, b, **QP)
    _assert_same_trajectory(tr, jr)
    assert tr.solved
    np.testing.assert_allclose(tr.y, np.linalg.solve(Q, b), atol=1e-6)


@pytest.mark.parametrize("change", [dict(), dict(enable_line_search=True),
                                    dict(enable_line_search=True, enable_rescaling=True)])
def test_qp_requires_line_search_in_both(change):
    """tests/test_qp.py::test_qp_requires_line_search, and its other half:
    line search with rescaling is refused too."""
    for pkg, prog in ((conex_tpu, conex_tpu.Program(2)),
                      (ct, ct.Program(2, device="cpu"))):
        prog.add_quadratic_cost(np.eye(2))
        prog.add_linear_constraint(np.eye(2), np.ones(2))
        with pytest.raises(ValueError, match="line_search"):
            prog.solve(np.ones(2), pkg.SolverConfig(**change) if change else None)


def test_qp_guards_raise_the_same_errors():
    for prog in (conex_tpu.Program(3), ct.Program(3, device="cpu")):
        with pytest.raises(ValueError, match="square symmetric"):
            prog.add_quadratic_cost(np.triu(np.ones((3, 3))))
        with pytest.raises(ValueError, match="square symmetric"):
            prog.add_quadratic_cost(np.ones((3, 2)))
        with pytest.raises(ValueError, match="Q must be"):
            prog.add_quadratic_cone_constraint(np.ones((3, 2)), np.ones(3),
                                               Q=np.eye(3))
        with pytest.raises(ValueError, match="batch/cone dimensions"):
            prog.add_quadratic_cone_constraint(np.ones((3, 2)), np.ones(4))
        with pytest.raises(ValueError, match="Qi order"):
            prog.add_quadratic_cost_epigraph(np.eye(2), [0], 2)
        with pytest.raises(ValueError, match="duplicate"):
            prog.add_quadratic_cost(np.eye(2), variables=[1, 1])


# ---------------------------------------------------------------------------
# tests/test_quadratic_cone.py
# ---------------------------------------------------------------------------


def test_quadratic_cone_matches_soc_on_the_port():
    """tests/test_quadratic_cone.py::test_quadratic_cone_matches_soc: the
    three formulations agree on the port, and each Q-cone program follows
    the JAX trajectory."""
    rng = np.random.default_rng(0)
    n = 3
    cfg = dict(inv_sqrt_mu_max=10000.0, max_iterations=50)
    for _ in range(3):
        Wsqrt = rng.uniform(-1, 1, (n, n))
        b = rng.uniform(-1, 1, n)
        As = np.zeros((n + 1, n))
        As[1:, :] = Wsqrt
        Cs = np.eye(n + 1)[0]
        Aq = np.zeros((n + 1, n))
        Aq[1:, :] = np.eye(n)
        Q = Wsqrt.T @ Wsqrt

        p1 = ct.Program(n, device="cpu")
        p1.add_soc_constraint(As, Cs)
        y1 = p1.solve(b, ct.SolverConfig(**cfg)).y
        jp, tp = _both(n, lambda p: p.add_quadratic_cone_constraint(As, Cs))
        jr2, tr2 = _solve(jp, tp, b, **cfg)
        jp, tp = _both(n, lambda p: p.add_quadratic_cone_constraint(Aq, Cs, Q=Q))
        jr3, tr3 = _solve(jp, tp, b, **cfg)
        _assert_same_trajectory(tr2, jr2)
        _assert_same_trajectory(tr3, jr3)
        np.testing.assert_allclose(y1, tr2.y, atol=1e-5)
        np.testing.assert_allclose(y1, tr3.y, atol=8e-5)


def test_quadratic_cone_iterations_match_soc_and_jax():
    rng = np.random.default_rng(1)
    n, m = 4, 3
    A = rng.uniform(-1, 1, (n + 1, m))
    c = rng.uniform(-1, 1, n + 1)
    c[0] = np.linalg.norm(c[1:]) + 1.0
    x0 = rng.uniform(-1, 1, n + 1)
    x0[0] = np.linalg.norm(x0[1:]) + 0.5
    b = A.T @ x0
    cfg = dict(max_iterations=40, prepare_dual_variables=True)

    soc = ct.Program(m, device="cpu")
    soc.add_soc_constraint(A, c)
    r1 = soc.solve(b, ct.SolverConfig(**cfg))
    jp, tp = _both(m, lambda p: p.add_quadratic_cone_constraint(A, c))
    jr, tr = _solve(jp, tp, b, **cfg)
    _assert_same_trajectory(tr, jr)
    assert r1.num_iterations == tr.num_iterations
    np.testing.assert_allclose(r1.y, tr.y, atol=1e-6)
    np.testing.assert_allclose(r1.stats_inv_sqrt_mu, tr.stats_inv_sqrt_mu, rtol=1e-5)
    # The dual carries dual_scale 2 in both packages: A'x = b.
    x = tp.get_dual_variable(0)
    np.testing.assert_allclose(x, jp.get_dual_variable(0), rtol=1e-8)
    assert x.shape == (n + 1,) and np.abs(A.T @ x - b).max() < 1e-6


def _epigraph_instance():
    rng = np.random.default_rng(2)
    nv = 3
    M = rng.uniform(-1, 1, (nv, nv))
    Qi = M @ M.T + nv * np.eye(nv)
    return nv, Qi, rng.uniform(-1, 1, nv)


def test_epigraph_qp_matches_quadratic_cost_and_jax():
    nv, Qi, bvec = _epigraph_instance()
    qp_cfg = dict(enable_line_search=True, enable_rescaling=False,
                  inv_sqrt_mu_max=2e5, max_iterations=40,
                  final_centering_tolerance=1.05, final_centering_steps=0,
                  kkt_error_tolerance=1e45)
    A_box = np.vstack([np.eye(nv), -np.eye(nv)])
    c_box = np.full(2 * nv, 10.0)

    def direct(p):
        p.add_quadratic_cost(Qi)
        p.add_linear_constraint(A_box, c_box)

    def epigraph(p):
        p.add_quadratic_cost_epigraph(Qi, list(range(nv)), nv)
        p.add_linear_constraint(np.hstack([A_box, np.zeros((2 * nv, 1))]), c_box)

    jp, tp = _both(nv, direct)
    jr, tr = _solve(jp, tp, bvec, **qp_cfg)
    _assert_same_trajectory(tr, jr)
    y_direct = tr.y
    jp, tp = _both(nv + 1, epigraph)
    jr, tr = _solve(jp, tp, np.concatenate([bvec, [-1.0]]), max_iterations=60,
                    inv_sqrt_mu_max=1e5)
    _assert_same_trajectory(tr, jr)
    assert tr.solved
    np.testing.assert_allclose(tr.y[:nv], y_direct, atol=1e-4)
    assert tr.y[nv] == pytest.approx(0.5 * y_direct @ Qi @ y_direct, abs=1e-4)


def test_epigraph_over_other_variables_is_a_sparse_subset():
    """x = y[0:nv], t = y[nv] collapses to the dense path; any other
    placement is a sparse subset, which both packages send to the
    supernodal KKT path (solved in tests/test_torch_sparse_program.py)."""
    nv, Qi, _ = _epigraph_instance()
    jp, p = conex_tpu.Program(nv + 1), ct.Program(nv + 1, device="cpu")
    assert p.add_quadratic_cost_epigraph(Qi, range(nv), nv) == 0
    assert p._blocks[0].vars_ is None
    for variables, t in ((range(1, nv + 1), 0), ([1, 0, 2], nv)):
        p.add_quadratic_cost_epigraph(Qi, variables, t)
        jp.add_quadratic_cost_epigraph(Qi, variables, t)
        assert p._blocks[-1].vars_ == jp._blocks[-1].vars_ == tuple(variables) + (t,)
    assert p._kkt_structure() == tuple(jp._kkt_structure())


# ---------------------------------------------------------------------------
# tests/test_failure_corpus.py, the dense cases
# ---------------------------------------------------------------------------


def test_equality_failing_ldlt_regularized_on_both(clamps):
    """The KKT matrix has a zero pivot in fixed order: the clamp fires, so
    the trajectory is not held; the JAX test's assertions are."""
    A = np.array([[1.0, 1.0]])
    C = np.array([1.0])

    def build(p):
        p.add_linear_constraint(A, C)
        p.add_equality_constraint(np.array([[1.0, -1.0]]), np.array([0.0]))

    jp, tp = _both(2, build)
    jr, tr = _solve(jp, tp, A.T @ C, max_iterations=40,
                    iterative_refinement_iterations=2)
    assert any(clamps)
    _assert_same_outcome(tr, jr)
    for res in (tr, jr):
        if res.solved:
            assert abs(res.y[0] - res.y[1]) < 1e-6
            assert res.y[0] == pytest.approx(0.5, abs=1e-4)


def _unbalanced(seed):
    rng = np.random.default_rng(seed)
    num_vars, n = 5, 15
    A = rng.uniform(-1, 1, (n, num_vars))
    slack, dual = np.ones(n), np.ones(n)
    slack[:n // 2] = 1e-3
    dual[n // 2:] = 1e-3
    y_opt = rng.uniform(-1, 1, num_vars)
    return A, slack + A @ y_opt, A.T @ dual, y_opt


def test_bad_initialization_centering_helps_matches_jax():
    A, C, b, _ = _unbalanced(0)
    jp, tp = _both(5, lambda p: p.add_linear_constraint(A, C))
    jr, tr = _solve(jp, tp, b, max_iterations=60, final_centering_steps=10,
                    initial_centering_steps_coldstart=2)
    _assert_same_trajectory(tr, jr)
    assert tr.solved and (C - A @ tr.y).min() >= -1e-6


def test_qr_succeeds_where_llt_fails_on_both():
    """Held by its outcome (see the docstring): LLT fails, QR solves."""
    rng = np.random.default_rng(1)
    m = 4
    row = rng.uniform(-1, 1, m)
    A = np.vstack([row, row, rng.uniform(-1, 1, m)])
    c = np.abs(rng.uniform(0.5, 1.5, 3))
    c[1] = c[0]
    b = A.T @ np.array([1.0, 1.0, 0.5])
    for mode, solved in ((ct.KKT_SOLVER_LLT, False), (ct.KKT_SOLVER_QR, True)):
        jp, tp = _both(m, lambda p: p.add_linear_constraint(A, c))
        jr, tr = _solve(jp, tp, b, max_iterations=30, kkt_solver=mode)
        assert tr.solved is jr.solved is solved
        if solved:
            assert (c - A @ tr.y).min() >= -1e-6
        else:
            assert bool(tr._raw.fail) and bool(jr._raw.fail)
            assert tr.num_iterations == jr.num_iterations


def _assert_slater_outcome(tr, jr, clamps):
    """A Slater-violating LP (rows r and -r force r'y = const) is held by
    its outcome, clamp or not: the weights of the two rows grow without
    bound as mu falls, so the Schur complement is singular to rounding
    along r, and the port's and JAX's trajectories part by 1e-7 at a
    scaled k of 500-900 with no pivot clamped.  So: the same outcome, the
    iteration counts within the final-centering steps, and the JAX test's
    own assertions on both packages (by the caller)."""
    assert clamps  # the LDLT ran
    _assert_same_outcome(tr, jr)
    assert abs(tr.num_iterations - jr.num_iterations) <= 5


def test_slater_violating_lp_on_both(clamps):
    rng = np.random.default_rng(2)
    m = 4
    r = rng.uniform(-1, 1, m)
    yref = rng.uniform(-1, 1, m)
    A = np.vstack([r, -r, rng.uniform(-1, 1, (4, m))])
    c = np.concatenate([[r @ yref], [-(r @ yref)],
                        rng.uniform(1, 2, 4) + A[2:] @ yref])
    b = A.T @ np.abs(rng.uniform(0, 1, 6))
    jp, tp = _both(m, lambda p: p.add_linear_constraint(A, c))
    jr, tr = _solve(jp, tp, b, max_iterations=60, kkt_solver=ct.KKT_SOLVER_LDLT,
                    iterative_refinement_iterations=2)
    _assert_slater_outcome(tr, jr, clamps)
    for res in (tr, jr):
        if res.solved:
            assert abs(r @ res.y - r @ yref) < 1e-4


def test_mu_stall_detector_matches_jax():
    A = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    c = np.array([1.0, 0.0, 1e6, 1e6])
    b = np.array([1.0, 0.0])
    for stall, iters in ((0, 60), (4, None)):
        jp, tp = _both(2, lambda p: p.add_linear_constraint(A, c))
        jr, tr = _solve(jp, tp, b, max_iterations=60, inv_sqrt_mu_max=1e7,
                        mu_stall_iterations=stall)
        _assert_same_trajectory(tr, jr)
        assert not tr.solved and tr.mu_stalled == jr.mu_stalled == bool(stall)
        assert tr.num_iterations == iters if iters else tr.num_iterations <= 8


def test_mu_stall_detector_quiet_on_wellposed_matches_jax():
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    c = np.array([2.0, 3.0, 4.0])
    b = np.array([1.0, 2.0])
    jp, tp = _both(2, lambda p: p.add_linear_constraint(A, c))
    jr, tr = _solve(jp, tp, b, max_iterations=50, inv_sqrt_mu_max=1e4,
                    mu_stall_iterations=4)
    _assert_same_trajectory(tr, jr)
    assert tr.solved and not tr.mu_stalled and abs(b @ tr.y - 7.0) < 1e-6


@pytest.mark.parametrize("seed", range(5))
def test_bad_initialization_fail_variant_on_both(seed, clamps):
    A, C, b, y_opt = _unbalanced(100 + seed)
    eq = np.zeros((1, 5))
    eq[0, [0, 1, 4]] = [1.0, 2.0, 3.0]
    eq_affine = eq @ y_opt

    def build(p):
        p.add_equality_constraint(eq, eq_affine)
        p.add_linear_constraint(A, C)

    jp, tp = _both(5, build)
    jr, tr = _solve(jp, tp, b, max_iterations=40, final_centering_steps=10,
                    initial_centering_steps_coldstart=0, divergence_upper_bound=0.5,
                    iterative_refinement_iterations=2)
    if any(clamps):
        _assert_same_outcome(tr, jr)
    else:
        _assert_same_trajectory(tr, jr)
    for res in (tr, jr):
        if res.solved:
            assert (C - A @ res.y).min() >= -1e-4
            assert np.abs(eq @ res.y - eq_affine).max() < 1e-4


@pytest.mark.parametrize("n_implicit", [1, 2, 3])
def test_lp_fail_slater_reference_config_on_both(n_implicit, clamps):
    rng = np.random.default_rng(200 + n_implicit)
    m, n2 = 10, 8
    yref = rng.uniform(-1, 1, m)
    A1 = rng.uniform(-1, 1, (n_implicit, m))
    C1 = A1 @ yref
    A2 = rng.uniform(-1, 1, (n2, m))
    A = np.vstack([A1, -A1, A2])
    c = np.concatenate([C1, -C1, A2 @ yref + 2.0])
    b = A.T @ np.abs(rng.uniform(-1, 1, 2 * n_implicit + n2))
    jp, tp = _both(m, lambda p: p.add_linear_constraint(A, c))
    jr, tr = _solve(jp, tp, b, prepare_dual_variables=True, inv_sqrt_mu_max=100.0,
                    final_centering_tolerance=1.0, infeasibility_threshold=2e6,
                    final_centering_steps=5, kkt_solver=ct.KKT_SOLVER_LDLT,
                    iterative_refinement_iterations=2, max_iterations=60)
    _assert_slater_outcome(tr, jr, clamps)
    for res in (tr, jr):
        if res.solved:
            assert np.abs(A1 @ res.y - C1).max() < 1e-3


def test_mpc_failing_ldlt_graceful_in_both(clamps):
    """tests/test_failure_corpus.py::test_mpc_failing_ldlt_graceful: a T=3
    MPC chain whose every block lies on a sparse variable subset, so both
    packages solve it on the supernodal KKT path (LDLT).  Its own
    assertion, a finite y, holds in both, with the same ``solved`` and
    ``fail``; the trajectory too where no pivot was clamped."""
    rng = np.random.default_rng(5)
    T, nu, nx = 3, 1, 2
    Ai = rng.uniform(-1, 1, (nx, nx))
    Bi = rng.uniform(-1, 1, (nx, nu))
    f = rng.uniform(-1, 1, nx)
    Hxu = rng.uniform(-1, 1, (2, nu))
    gxu = rng.uniform(-1, 1, 2)

    def input_vars(i):
        return list(range(T * nx + i * nu, T * nx + (i + 1) * nu))

    def state_vars(i):
        return list(range((i - 1) * nx, i * nx))

    def stage_vars(i):
        return (state_vars(i) if i > 0 else []) + input_vars(i) + state_vars(i + 1)

    def build(prog):
        epigraph = T * (nu + nx)
        for i in range(T):
            D = np.hstack([Ai, Bi, -np.eye(nx)] if i > 0 else [Bi, -np.eye(nx)])
            prog.add_equality_constraint(D, f, variables=stage_vars(i))
            if 0 < i < T - 1:
                prog.add_linear_constraint(Hxu, gxu, variables=input_vars(i))
            prog.add_quadratic_cost_epigraph(np.eye(nu), input_vars(i), epigraph)
            prog.add_quadratic_cost_epigraph(np.eye(nx), state_vars(i + 1),
                                             epigraph + 1)
            epigraph += 2

    jp, tp = _both(T * (nu + nx + 2), build)
    assert tp._kkt_structure() == tuple(jp._kkt_structure())
    jr, tr = _solve(jp, tp, -np.ones(T * (nu + nx + 2)), prepare_dual_variables=True,
                    inv_sqrt_mu_max=100.0, final_centering_tolerance=1.0,
                    infeasibility_threshold=2e6, final_centering_steps=5,
                    kkt_solver=ct.KKT_SOLVER_LDLT, iterative_refinement_iterations=2,
                    max_iterations=60)
    assert clamps  # the supernodal LDLT ran
    _assert_same_outcome(tr, jr)
    if not any(clamps):
        _assert_same_trajectory(tr, jr)


# ---------------------------------------------------------------------------
# solve_scenarios batches, state and the update surface
# ---------------------------------------------------------------------------


def _batch_result(blocks_j, eq_j, blocks_t, eq_t, b, ws_j, ws_t, cfg):
    S = b.shape[0]
    scal = dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))
    rj = jsolve(tuple(blocks_j), tuple(eq_j), jnp.asarray(b), tuple(ws_j),
                {k: jnp.asarray(v) for k, v in scal.items()},
                conex_tpu.SolverConfig(**cfg))
    rt = ct.solve_scenarios(tuple(blocks_t), tuple(eq_t), convert.tensor(b), tuple(ws_t),
                            convert.scalars(scal), ct.SolverConfig(**cfg))
    return jax.tree.map(np.asarray, rj), convert.to_numpy(rt)


def _assert_same_batch(rt, rj):
    """Every scenario of the batch under _assert_same_trajectory's rules."""
    assert rt.y.shape == rj.y.shape and rt.y_kkt.shape == rj.y_kkt.shape
    for s in range(rj.y.shape[0]):
        _assert_same_trajectory(_run(rt, s), _run(rj, s))


def test_solve_scenarios_with_equality_blocks_matches_jax(clamps):
    """Three scenarios of LP + two equality blocks, LDLT, duals recovered,
    against the vmapped JAX call; y_kkt carries the equality duals."""
    S, m, n = 3, 5, 8
    rng = np.random.default_rng(11)
    inst = [build_instance(rng, m=m, n=n, p=3) for _ in range(S)]
    A, c, Aeq, beq, b = map(np.stack, zip(*inst))
    cfg = dict(max_iterations=60, prepare_dual_variables=True,
               kkt_solver=ct.KKT_SOLVER_LDLT)
    eq_j = [JEq(A=jnp.asarray(Aeq[:, :2]), b=jnp.asarray(beq[:, :2])),
            JEq(A=jnp.asarray(Aeq[:, 2:]), b=jnp.asarray(beq[:, 2:]), dual_offset=2)]
    eq_t = [convert.equality_block(Aeq[:, :2], beq[:, :2]),
            convert.equality_block(Aeq[:, 2:], beq[:, 2:], dual_offset=2)]
    rj, rt = _batch_result([JLinear(A=jnp.asarray(A), c=jnp.asarray(c))], eq_j,
                           [convert.linear_cone(A, c)], eq_t, b,
                           [jnp.ones((S, n))], [torch.ones((S, n), dtype=torch.float64)],
                           cfg)
    assert not any(clamps)
    assert rj.solved.all() and rt.y_kkt.shape == (S, m + 3)
    _assert_same_batch(rt, rj)
    for s in range(S):
        assert np.abs(Aeq[s] @ rt.y[s] - beq[s]).max() < 1e-8


def test_solve_scenarios_with_dense_vars_blocks_matches_jax():
    """Blocks on variable subsets scatter densely in solve_scenarios (JAX
    loop.py:83-100): two LP blocks over (0, 2) and (1, 2, 3), a quadratic
    cone over (3, 0) and an equality row over (1, 3), three scenarios."""
    S, m = 3, 4
    rng = np.random.default_rng(12)
    A1 = rng.uniform(-1, 1, (S, 6, 2))
    c1 = rng.uniform(1, 2, (S, 6))
    A2 = rng.uniform(-1, 1, (S, 7, 3))
    c2 = rng.uniform(1, 2, (S, 7))
    Aq = rng.uniform(-0.5, 0.5, (S, 1, 4, 2))
    cq = np.zeros((S, 1, 4))
    cq[..., 0] = 3.0
    Ae = rng.uniform(-1, 1, (S, 1, 2))
    be = 0.05 * rng.uniform(-1, 1, (S, 1))
    b = rng.uniform(-1, 1, (S, m))
    v1, v2, vq, ve = (0, 2), (1, 2, 3), (3, 0), (1, 3)
    cfg = dict(max_iterations=60, kkt_solver=ct.KKT_SOLVER_LDLT)
    blocks_j = [JLinear(A=jnp.asarray(A1), c=jnp.asarray(c1), vars_=v1),
                JLinear(A=jnp.asarray(A2), c=jnp.asarray(c2), vars_=v2),
                jax.vmap(lambda a, c: JQuad.build(a, c, vars_=vq))(
                    jnp.asarray(Aq), jnp.asarray(cq))]
    blocks_t = [convert.linear_cone(A1, c1, vars_=v1),
                convert.linear_cone(A2, c2, vars_=v2),
                convert.quadratic_cone(Aq, cq, vars_=vq)]
    eye_q = np.zeros((S, 1, 4))
    eye_q[..., 0] = 1.0
    rj, rt = _batch_result(
        blocks_j, [JEq(A=jnp.asarray(Ae), b=jnp.asarray(be), vars_=ve)],
        blocks_t, [convert.equality_block(Ae, be, vars_=ve)], b,
        [jnp.ones((S, 6)), jnp.ones((S, 7)), jnp.asarray(eye_q)],
        [convert.tensor(np.ones((S, 6))), convert.tensor(np.ones((S, 7))),
         convert.tensor(eye_q)], cfg)
    assert rj.solved.all()
    _assert_same_batch(rt, rj)


def test_solve_scenarios_of_qps_with_an_empty_state_matches_jax():
    """A QuadraticCost's state is (S, 0) in the port; the batch runs, its
    final state keeps that shape, and the solve matches JAX."""
    S, n, num_ineqs = 3, 4, 8
    rng = np.random.default_rng(13)
    inst = [qp_with_solution(n, num_ineqs, rng) for _ in range(S)]
    W, A, bq, cq, x_opt, _ = map(np.stack, zip(*inst))
    rj, rt = _batch_result(
        [JCost(Q=jnp.asarray(W)), JLinear(A=jnp.asarray(-A), c=jnp.asarray(bq))], [],
        [convert.quadratic_cost(W), convert.linear_cone(-A, bq)], [], -cq,
        [jnp.zeros((S, 0)), jnp.ones((S, num_ineqs))],
        [torch.zeros((S, 0), dtype=torch.float64),
         torch.ones((S, num_ineqs), dtype=torch.float64)], QP)
    assert rj.solved.all() and rt.ws[0].shape == (S, 0)
    _assert_same_batch(rt, rj)
    np.testing.assert_allclose(rt.y, x_opt, atol=1e-8)


def test_save_load_with_the_new_states_matches_jax():
    """A QP program's state (an empty cost state and an LP iterate) and a
    Q-cone program's state go out as numpy in the JAX layout and come back;
    a warmstart from them runs as JAX's does, from either package's
    state (where the QP's ends, see the next test)."""
    W, A, b, c, _, _ = qp_with_solution(4, 8, np.random.default_rng(14))
    rng = np.random.default_rng(15)
    Aq = rng.uniform(-1, 1, (5, 4))
    cq = np.eye(5)[0] * 3.0

    def qp(p):
        p.add_quadratic_cost(W)
        p.add_linear_constraint(-A, b)

    def qcone(p):
        p.add_quadratic_cone_constraint(Aq, cq, Q=np.eye(4) * 2.0)

    for build, obj, cfg in ((qp, -c, QP), (qcone, Aq.T @ np.eye(5)[0], dict(max_iterations=40))):
        jp, tp = _both(4, build)
        _solve(jp, tp, obj, **cfg)
        jstate, tstate = jp.save_state(), tp.save_state()
        for tw, jw in zip(tstate["ws"], jstate["ws"]):
            assert isinstance(tw, np.ndarray) and tw.shape == np.shape(jw)
            np.testing.assert_allclose(tw, jw, rtol=1e-8, atol=1e-12)
        warm = dict(cfg, initialization_mode=ct.WARMSTART)
        jq, tq, tx = conex_tpu.Program(4), ct.Program(4, device="cpu"), ct.Program(4, device="cpu")
        for p, state in ((jq, jstate), (tq, tstate), (tx, jstate)):
            build(p)
            p.load_state(state)
        jr = jq.solve(obj, conex_tpu.SolverConfig(**warm))
        assert jr.solved
        for tp_ in (tq, tx):
            _assert_same_trajectory(tp_.solve(obj, ct.SolverConfig(**warm)), jr)


@pytest.mark.parametrize("scale", [1.0, 1.01])
def test_qp_warmstart_ends_infeasible_in_both(scale):
    """A standing fact of the JAX package, which the port shares: under
    tests/test_qp.py's QP_CONFIG, a warmstart from a QP's final state, at
    the same objective or one moved by 1%, reports solved at a point that
    breaks a constraint by more than 0.1; the coldstart is right."""
    W, A, b, c, _, _ = qp_with_solution(4, 8, np.random.default_rng(14))

    def qp(p):
        p.add_quadratic_cost(W)
        p.add_linear_constraint(-A, b)

    jp, tp = _both(4, qp)
    _solve(jp, tp, -c, **QP)
    jr, tr = _solve(jp, tp, -scale * c, **dict(QP, initialization_mode=ct.WARMSTART))
    jc, tc = _both(4, qp)
    jcold, tcold = _solve(jc, tc, -scale * c, **QP)
    for warm_res, cold_res in ((jr, jcold), (tr, tcold)):
        assert warm_res.solved and cold_res.solved
        assert (A @ cold_res.y + b).min() >= -1e-9
        assert (A @ warm_res.y + b).min() < -0.1
        assert np.abs(warm_res.y - cold_res.y).max() > 0.1
    _assert_same_trajectory(tr, jr)
    _assert_same_trajectory(tcold, jcold)


def test_the_endgame_moves_as_far_in_jax_alone():
    """Why trajectories are held to 1e-8 only up to K_HOLD: on the QP of
    test_random_qp_matches_jax[5-10], the JAX package run twice, with b
    moved by one rounding (2^-52), parts past K_HOLD by more than 1e-8,
    as far as the port and JAX part there, and not before."""
    W, A, b, c, _, _ = qp_with_solution(5, 10, np.random.default_rng(0))

    def build(p):
        p.add_quadratic_cost(W)
        p.add_linear_constraint(-A, b)

    runs = []
    for pkg, prog, obj in ((conex_tpu, conex_tpu.Program(5), -c),
                           (conex_tpu, conex_tpu.Program(5), -c * (1 + 2.0**-52)),
                           (ct, ct.Program(5, device="cpu"), -c)):
        build(prog)
        runs.append(prog.solve(obj, pkg.SolverConfig(**QP)))
    jr, jmoved, tr = (_run(r) for r in runs)
    n = _held(jr)
    assert 0 < n < jr.num_iterations
    k = jr.stats_k[:jr.num_iterations - 1]

    def spread(other):
        return np.abs(other.stats_k[:len(k)] - k) / k

    assert spread(jmoved)[:n].max() <= 1e-8 and spread(tr)[:n].max() <= 1e-8
    assert spread(jmoved)[n:].max() > 1e-8 and spread(tr)[n:].max() > 1e-8
    assert spread(tr)[n:].max() <= 100 * spread(jmoved)[n:].max()


def test_updates_of_the_new_blocks_raise_in_both_packages():
    """Neither package updates a quadratic cone's or a quadratic cost's
    data in place: both raise the same ValueError (conex_tpu/program.py's
    update methods end in an ``else`` that raises)."""
    def build(p):
        p.add_quadratic_cone_constraint(np.vstack([np.zeros((1, 2)), -np.eye(2)]),
                                        np.eye(3)[0])
        p.add_quadratic_cost(np.eye(2))
        p.add_equality_constraint(np.ones((1, 2)), np.ones(1))

    for prog in _both(2, build):
        for i in (0, 1):
            with pytest.raises(ValueError, match="does not support operator updates"):
                prog.update_linear_operator(i, 0.5, variable=0, row=1)
            with pytest.raises(ValueError, match="does not support affine updates"):
                prog.update_affine_term(i, 0.5, row=1)


def test_new_blocks_are_exported():
    from conex_tpu_torch.cones.equality import EqualityBlock
    from conex_tpu_torch.cones.qcost import QuadraticCost
    from conex_tpu_torch.cones.quadratic import QuadraticCone

    assert (ct.EqualityBlock, ct.QuadraticCost, ct.QuadraticCone) == (
        EqualityBlock, QuadraticCost, QuadraticCone)
    for name in ("EqualityBlock", "QuadraticCost", "QuadraticCone"):
        assert name in ct.__all__


def test_chip_smoke_copies_the_test_instances():
    """chip_smoke.py keeps its own copies of tests/test_equality.py's
    build_instance, tests/test_qp.py's qp_with_solution and QP_CONFIG (the
    script imports nothing of the tests, which import jax)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    for got, want in zip(chip_smoke.eq_lp_instance(np.random.default_rng(0)),
                         build_instance(np.random.default_rng(0))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(chip_smoke.qp_with_solution(7, 12, np.random.default_rng(3)),
                         qp_with_solution(7, 12, np.random.default_rng(3))):
        np.testing.assert_array_equal(got, want)
    cfg = dataclasses.asdict(chip_smoke.qp_config())
    assert cfg == dict(QP, max_iterations=chip_smoke.QP_ITERATIONS)
    As, C, Aeq, beq, b = chip_smoke.eq_sdp_instance(0, 6, 3, 2)
    np.testing.assert_array_equal(As, np.swapaxes(As, 1, 2))
    assert np.linalg.eigvalsh(C).min() > 2.0 and np.abs(Aeq).max() <= 1.0
    assert (As.shape, C.shape, Aeq.shape, beq.shape, b.shape) == (
        (3, 6, 6), (6, 6), (2, 3), (2,), (3,))

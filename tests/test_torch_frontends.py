"""The port's front ends (interface.py's ``Conex``, sedumi.py's
``solve_sedumi``) and its copy of preprocess.py against conex_tpu, in f64
on the CPU.

Every case of tests/test_interface.py and tests/test_sedumi.py runs
through both packages on the same inputs (``device="cpu"`` in the port),
its own assertions on the port's result, and the two results side by side.
Tolerances, per case (the ``tol`` argument of each comparison):

* LP, SOC, QP, equality and octonion models: y and x at 1e-8 relative
  (the same f64 arithmetic, sums in other orders), to the end of each
  run: ``Conex``'s and ``solve_sedumi``'s default configurations stop at
  inv_sqrt_mu_max = 1e3, short of the endgame that parts the packages
  further on (tests/test_torch_equality_qp.py);
* a model with an LMI or a Hermitian block of d <= 4: 1e-6, the bar of
  tests/test_torch_solve.py.  The warm eigenvalue estimator's f32 sweep
  rounds differently in XLA and PyTorch, and the trajectory carries that;
* iteration counts and ``solved`` equal everywhere.

``test_sparse_instance``'s second LMI covers variables 1 and 2, which
both packages solve on the supernodal KKT path.
The copied preprocess.py must give the JAX one's arrays to the bit.
"""

import inspect
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import chip_smoke
import conex_tpu
from conex_tpu import interface as jif
from conex_tpu import preprocess as jpre
from conex_tpu import sedumi as jsed

import conex_tpu_torch as ct
from conex_tpu_torch import interface as tif
from conex_tpu_torch import preprocess as tpre
from conex_tpu_torch import sedumi as tsed

from test_interface import check_errors, randsym
from test_sedumi import _sdp_instance

LMI, EXACT = 1e-6, 1e-8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _close(got, want, tol):
    assert _rel(got, want) <= tol, (_rel(got, want), tol)


def _conex(pkg, m):
    return jif.Conex(m) if pkg is jif else tif.Conex(m, device="cpu")


def _both(case, tol):
    """case(interface module) -> (Conex, solution) in each package; the
    solutions, iteration counts and duals side by side."""
    (jc, js), (tc, ts) = case(jif), case(tif)
    assert ts.status == js.status
    assert tc._result.num_iterations == jc._result.num_iterations
    _close(ts.y, js.y, tol)
    jx, tx = jc.GetDualVariables(), tc.GetDualVariables()
    assert len(tx) == len(jx)
    for t, j in zip(tx, jx):
        _close(t, j, tol)
    return tc, ts


# ---------------------------------------------------------------------------
# tests/test_interface.py
# ---------------------------------------------------------------------------


def test_random_instance_mixed_lp_lmi():
    m = 2
    A1 = np.ones((3, m))
    A1[0, 1], A1[1, 0] = 3, 4
    c1 = np.ones(3)
    b = A1.T @ c1
    Amat = np.stack([randsym(4, np.random.default_rng(0)) for _ in range(m)])
    Amat[m - 1] = 0.0
    Amat[m - 1][0, 0] = 1.0

    def case(mod):
        prog = _conex(mod, m)
        prog.AddLinearInequality(A1, c1)
        prog.AddLinearInequality(A1.copy(), c1)
        prog.AddDenseLinearMatrixInequality(Amat, np.eye(4))
        return prog, prog.Maximize(b)

    prog, sol = _both(case, LMI)
    assert sol.status
    _, err = prog.ComputeErrors(sol.y, prog.GetDualVariables(), b)
    assert check_errors(err)


def test_sparse_instance():
    """The second LMI covers variables 1 and 2: both packages solve on the
    supernodal KKT path (the unrolled structure), to the LMI bar."""
    rng = np.random.default_rng(1)
    n = 4
    A1 = np.stack([randsym(n, rng) for _ in range(2)])
    A2 = np.stack([randsym(n, rng) for _ in range(2)])

    def case(mod):
        prog = _conex(mod, 3)
        prog.AddSparseLinearMatrixInequality(A1, np.eye(n), np.arange(0, 2))
        prog.AddSparseLinearMatrixInequality(A2, np.eye(n), np.arange(1, 3))
        return prog, prog.Maximize(np.ones(3))

    prog, sol = _both(case, LMI)
    assert sol.status
    assert [blk.vars_ for blk in prog._prog._blocks] == [None, (1, 2)]


def _tridiagonal_lmi(mod, d):
    """test_interface.py::test_solve_hermitian_lmi_known_solution: y = -1."""
    order = 3
    prog = _conex(mod, order - 1)
    con = prog.NewLinearMatrixInequality(order, d)
    for i in range(order - 1):
        prog.UpdateLinearOperator(con, -1.0, i, i + 1, i, d - 1)
    for i in range(order):
        prog.UpdateAffineTerm(con, 2.0 if i == 1 else 1.0, i, i, 0)
    return prog, prog.Maximize(-np.ones(order - 1))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_solve_hermitian_lmi_known_solution(d):
    prog, sol = _both(lambda mod: _tridiagonal_lmi(mod, d), EXACT if d == 8 else LMI)
    assert sol.status
    assert np.linalg.norm(sol.y + 1.0) < 1e-5
    kind = ct.DenseLMICone if d == 1 else ct.HermitianCone
    assert isinstance(prog._prog._blocks[0], kind)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_random_hermitian_lmi(d):
    def case(mod):
        rng = np.random.default_rng(d)
        order, num_vars = (3 if d == 8 else 6), 4
        prog = _conex(mod, num_vars)
        con = prog.NewLinearMatrixInequality(order, d)
        b = np.zeros(num_vars)
        for k in range(d):
            for i in range(order):
                prog.UpdateAffineTerm(con, 1.0, i, i, 0)
                for j in range(i if k == 0 else i + 1, order):
                    for v in range(num_vars):
                        val = rng.normal()
                        prog.UpdateLinearOperator(con, val, v, i, j, k)
                        if i == j and k == 0:
                            b[v] += val
        return prog, prog.Maximize(b)

    _, sol = _both(case, EXACT if d == 8 else LMI)
    assert sol.status


def test_random_socp_incremental():
    def case(mod):
        rng = np.random.default_rng(5)
        order, num_vars = 8, 4
        prog = _conex(mod, num_vars)
        con = prog.NewLorentzConeConstraint(order)
        b = np.zeros(num_vars)
        prog.UpdateAffineTerm(con, 1.0, 0)
        for i in range(order + 1):
            for v in range(num_vars):
                val = rng.normal()
                prog.UpdateLinearOperator(con, val, v, i)
                if i == 0:
                    b[v] += val
        return prog, prog.Maximize(b)

    _, sol = _both(case, EXACT)
    assert sol.status


def test_iteration_stats():
    rng = np.random.default_rng(6)
    m = 3
    A = rng.uniform(-1, 1, (8, m))
    c = np.abs(rng.uniform(-1, 1, 8)) + 0.5
    b = A.T @ np.abs(rng.uniform(0, 1, 8))

    def case(mod):
        prog = _conex(mod, m)
        prog.AddLinearInequality(A, c)
        return prog, prog.Maximize(b)

    prog, sol = _both(case, EXACT)
    assert sol.status
    stats = prog.GetIterationStats()
    assert len(stats) >= 2
    mus = [s.mu for s in stats]
    assert all(mus[i + 1] <= mus[i] + 1e-9 for i in range(len(mus) - 1))
    assert prog.GetIterationNumberStats(-1).mu == pytest.approx(mus[-1])
    jprog, _ = case(jif)
    _close(mus, [s.mu for s in jprog.GetIterationStats()], EXACT)
    with pytest.raises(IndexError):
        prog.GetIterationNumberStats(len(stats))


def test_box_inequalities():
    m = 3
    lb = np.array([-1.0, 0.5, -1e10])
    ub = np.array([2.0, 0.5, 3.0])

    def case(mod):
        prog = _conex(mod, m)
        prog.AddLinearInequalities(np.eye(m), lb, ub)
        return prog, prog.Maximize(np.ones(m))

    _, sol = _both(case, EXACT)
    assert sol.status
    assert sol.y[0] == pytest.approx(2.0, abs=1e-4)
    assert sol.y[1] == pytest.approx(0.5, abs=1e-6)
    assert sol.y[2] == pytest.approx(3.0, abs=1e-4)


def test_preprocess_linear_inequality_gives_the_same_arrays():
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    lb = np.array([0.0, -np.inf, 1.0])
    ub = np.array([1.0, 2.0, 1.0])
    got = tif.preprocess_linear_inequality(A, lb, ub)
    for g, w in zip(got, jif.preprocess_linear_inequality(A, lb, ub)):
        np.testing.assert_array_equal(g, w)
    Aineq, bineq, Aeq, _ = got
    assert Aeq.shape == (1, 2) and Aineq.shape == (3, 2)
    np.testing.assert_allclose(np.linalg.norm(Aineq[0]) ** 2 + bineq[0] ** 2, 1.0)


def test_mixed_hermitian_program():
    def case(mod):
        rng = np.random.default_rng(7)
        num_vars = 3
        prog = _conex(mod, num_vars)
        b = np.zeros(num_vars)
        for d in [1, 2, 4]:
            con = prog.NewLinearMatrixInequality(4, d)
            for k in range(d):
                for i in range(4):
                    prog.UpdateAffineTerm(con, 1.0, i, i, 0)
                    for j in range(i if k == 0 else i + 1, 4):
                        for v in range(num_vars):
                            val = 0.3 * rng.normal()
                            prog.UpdateLinearOperator(con, val, v, i, j, k)
                            if i == j and k == 0:
                                b[v] += val
        return prog, prog.Maximize(b)

    prog, sol = _both(case, LMI)
    assert sol.status
    assert [type(b).__name__ for b in prog._prog._blocks] == [
        "DenseLMICone", "HermitianCone", "HermitianCone"]


def test_program_incremental_update():
    rng = np.random.default_rng(10)
    A = rng.uniform(-1, 1, (6, 3))
    c = np.abs(rng.uniform(0.5, 1.5, 6))
    b = A.T @ np.abs(rng.uniform(0, 1, 6))
    c2 = c.copy()
    c2[0] += 0.5
    A2 = A.copy()
    A2[0, 0] = 0.0
    runs = {}
    for pkg in (conex_tpu, ct):
        cfg = lambda **kw: pkg.SolverConfig(max_iterations=50, **kw)  # noqa: E731
        new = lambda: (conex_tpu.Program(3) if pkg is conex_tpu  # noqa: E731
                       else ct.Program(3, device="cpu"))
        prog = new()
        i = prog.add_linear_constraint(A, c)
        r1 = prog.solve(b, cfg())
        prog.update_affine_term(i, c[0] + 0.5, 0)
        r2 = prog.solve(b, cfg(initialization_mode=pkg.WARMSTART))
        fresh = new()
        fresh.add_linear_constraint(A, c2)
        r3 = fresh.solve(b, cfg())
        prog.update_linear_operator(i, 0.0, 0, 0)
        r4 = prog.solve(b, cfg())
        fresh2 = new()
        fresh2.add_linear_constraint(A2, c2)
        r5 = fresh2.solve(b, cfg())
        assert r1.solved and r2.solved
        np.testing.assert_allclose(r2.y, r3.y, atol=1e-5)
        np.testing.assert_allclose(r4.y, r5.y, atol=1e-6)
        runs[pkg] = (r1, r2, r3, r4, r5)
    for t, j in zip(runs[ct], runs[conex_tpu]):
        assert t.num_iterations == j.num_iterations
        _close(t.y, j.y, EXACT)


def test_argument_validation_raises_the_same_errors():
    for mod in (jif, tif):
        prog = _conex(mod, 3)
        c1 = prog.NewLinearMatrixInequality(2, 2)
        assert prog.NewLinearMatrixInequality(2, 4) == c1 + 1
        with pytest.raises(ValueError, match="Hypercomplex dimension"):
            prog.NewLinearMatrixInequality(2, 3)
        with pytest.raises(ValueError, match="Invalid LMI"):
            prog.NewLinearMatrixInequality(0, 2)
        with pytest.raises(ValueError, match="imaginary diagonal"):
            prog.UpdateLinearOperator(c1, 1.0, 0, 1, 1, 1)
        with pytest.raises(ValueError, match="out of bounds"):
            prog.UpdateLinearOperator(c1, 1.0, 0, 0, 1, 2)
        c3 = prog.NewLorentzConeConstraint(3)
        with pytest.raises(ValueError, match="out of bounds"):
            prog.UpdateLinearOperator(c3, 1.0, 0, 5)
        with pytest.raises(ValueError, match="does not match"):
            prog.AddQuadraticCost(np.eye(2))
        with pytest.raises(ValueError, match="order <= 3"):
            prog.NewLinearMatrixInequality(4, 8)


def test_conex_solve_qp_path():
    rng = np.random.default_rng(11)
    nv = 3
    M = rng.uniform(-1, 1, (nv, nv))
    Q = M @ M.T + nv * np.eye(nv)
    b = rng.uniform(-0.1, 0.1, nv)

    def case(mod):
        prog = _conex(mod, nv)
        prog.AddQuadraticCost(Q)
        prog.AddLinearInequality(np.vstack([np.eye(nv), -np.eye(nv)]),
                                 np.full(2 * nv, 10.0))
        prog.AddLinearCost(-b)
        return prog, prog.Solve()

    _, sol = _both(case, EXACT)
    assert sol.status
    np.testing.assert_allclose(sol.y, np.linalg.solve(Q, b), atol=1e-5)


def test_incremental_update_reuses_the_program():
    """Value-only updates after a solve go to the built Program, which the
    next Maximize solves again; a new variable index rebuilds it (the JAX
    test also counts compiled solvers, which the port has none of)."""
    rng = np.random.default_rng(3)
    m, n = 4, 6
    A = rng.uniform(-1, 1, (n, m))
    b = A.T @ rng.uniform(0.5, 1.5, n)
    c = rng.uniform(0.5, 1.5, n)
    sols = {}
    for mod in (jif, tif):
        prog = _conex(mod, m)
        con = prog.NewLinearInequality(n)
        for i in range(n):
            for v in range(m):
                prog.UpdateLinearOperator(con, A[i, v], v, i)
            prog.UpdateAffineTerm(con, c[i], i)
        sol = prog.Maximize(b)
        built = prog._prog
        prog.UpdateLinearOperator(con, A[0, 0] + 0.01, 0, 0)
        prog.UpdateAffineTerm(con, c[0] + 0.01, 0)
        assert prog._prog is built
        sol2 = prog.Maximize(b)
        assert prog._prog is built and sol.status and sol2.status
        assert not np.allclose(sol.y, sol2.y)
        sols[mod] = (sol, sol2)
        prog2 = _conex(mod, m)
        con2 = prog2.NewLinearInequality(n)
        prog2.UpdateLinearOperator(con2, 1.0, 0, 0)
        prog2.UpdateAffineTerm(con2, 1.0, 0)
        prog2.Maximize(np.ones(m) * 0.1)
        prog2.UpdateLinearOperator(con2, 1.0, 2, 1)  # grows num_vars
        assert prog2._prog is None
    for t, j in zip(sols[tif], sols[jif]):
        _close(t.y, j.y, EXACT)


def test_front_ends_run_on_the_card_unless_asked_for_the_cpu():
    assert tif.Conex(2).device == "cuda"
    assert inspect.signature(tsed.solve_sedumi).parameters["device"].default == "cuda"

    class Built(Exception):
        pass

    def record(m, device):
        devices.append(device)
        raise Built

    for device, call in ((
            "cuda", lambda: tsed.solve_sedumi(np.ones((1, 2)), np.ones(1), np.ones(2),
                                              dict(l=2))),
            ("cuda", lambda: _tridiagonal_lmi_default()),
            ("cpu", lambda: tsed.solve_sedumi(np.ones((1, 2)), np.ones(1), np.ones(2),
                                              dict(l=2), device="cpu"))):
        devices = []
        with mock.patch.object(tsed, "Program", side_effect=record), \
                mock.patch.object(tif, "Program", side_effect=record):
            with pytest.raises(Built):
                call()
        assert devices == [device]


def _tridiagonal_lmi_default():
    prog = tif.Conex(2)
    con = prog.NewLinearMatrixInequality(3, 2)
    prog.UpdateLinearOperator(con, -1.0, 0, 1, 0, 1)
    prog.UpdateAffineTerm(con, 1.0, 0, 0, 0)
    return prog.Maximize(-np.ones(2))


# ---------------------------------------------------------------------------
# tests/test_sedumi.py
# ---------------------------------------------------------------------------


def _sedumi_both(tol, *args, **kw):
    jx, jy, jinfo = jsed.solve_sedumi(*args, **kw)
    tx, ty, tinfo = tsed.solve_sedumi(*args, device="cpu", **kw)
    assert tinfo == jinfo
    _close(ty, jy, tol)
    _close(tx, jx, tol)
    return tx, ty, tinfo


def test_sedumi_lp_matches_scipy():
    from scipy.optimize import linprog

    rng = np.random.default_rng(0)
    m, n = 3, 8
    A = rng.uniform(-1, 1, (m, n))
    b = A @ np.abs(rng.uniform(0.5, 1, n))
    c = rng.uniform(0, 1, n) + A.T @ rng.uniform(-1, 1, m)
    x, y, info = _sedumi_both(EXACT, A, b, c, dict(l=n))
    assert info["solved"]
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert c @ x == pytest.approx(ref.fun, abs=1e-5)
    assert np.linalg.norm(A @ x - b) < 1e-6 and x.min() >= -1e-8
    assert abs(c @ x - b @ y) < 1e-5


def test_sedumi_mixed_free_lp_soc():
    rng = np.random.default_rng(1)
    m, nf, nl, q = 3, 1, 4, 4
    A = rng.uniform(-1, 1, (m, nf + nl + q))
    xf = rng.uniform(-1, 1, nf)
    xl = np.abs(rng.uniform(0.2, 1, nl))
    xq = rng.uniform(-0.3, 0.3, q)
    xq[0] = np.linalg.norm(xq[1:]) + 0.5
    b = A @ np.concatenate([xf, xl, xq])
    yref = rng.uniform(-1, 1, m)
    sl = np.concatenate([np.zeros(nf), np.abs(rng.uniform(0.1, 1, nl)),
                         np.concatenate([[1.5], rng.uniform(-0.3, 0.3, q - 1)])])
    c = A.T @ yref + sl
    x, y, info = _sedumi_both(EXACT, A, b, c, dict(f=nf, l=nl, q=[q]))
    assert info["solved"]
    assert np.linalg.norm(A @ x - b) < 1e-5
    assert x[nf:nf + nl].min() >= -1e-7
    xs = x[nf + nl:]
    assert xs[0] >= np.linalg.norm(xs[1:]) - 1e-6
    assert abs(c @ x - b @ y) < 1e-4


def test_sedumi_sdp():
    rng = np.random.default_rng(2)
    m, n = 2, 3
    Amats = np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, n, n))])
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T + 0.1 * np.eye(n)
    b = np.einsum("vij,ij->v", Amats, X0)
    Cmat = np.einsum("v,vij->ij", rng.uniform(-0.5, 0.5, m), Amats) + 2.0 * np.eye(n)
    x, y, info = _sedumi_both(LMI, Amats.reshape(m, n * n), b, Cmat.reshape(-1),
                              dict(s=[n]))
    assert info["solved"]
    X = x.reshape(n, n)
    assert np.linalg.eigvalsh(0.5 * (X + X.T)).min() >= -1e-6
    assert np.linalg.norm(np.einsum("vij,ij->v", Amats, X) - b) < 1e-5
    assert abs(Cmat.reshape(-1) @ x - b @ y) < 1e-4


def test_sedumi_dimension_check_in_both():
    for mod, kw in ((jsed, {}), (tsed, dict(device="cpu"))):
        with pytest.raises(ValueError, match="cone dimensions"):
            mod.solve_sedumi(np.ones((2, 5)), np.ones(2), np.ones(5), dict(l=3), **kw)


def test_sedumi_all_cone_types_combined():
    """The problem of tests/test_sedumi.py's test, as chip_smoke.py's
    phase 5e builds it."""
    A, b, c, K = chip_smoke.sedumi_all_cone_types()
    x, y, info = _sedumi_both(LMI, A, b, c, K)
    assert info["solved"]
    assert np.linalg.norm(A @ x - b) < 1e-4
    assert abs(c @ x - b @ y) < 1e-3
    X = x[-9:].reshape(3, 3)
    assert np.linalg.eigvalsh(0.5 * (X + X.T)).min() >= -1e-6


def test_eliminate_free_vars_matches_direct():
    rng = np.random.default_rng(7)
    m, nfree, n = 4, 2, 4
    A_s = rng.uniform(-1, 1, (m, n * n))
    A_s = np.stack([(0.5 * (r.reshape(n, n) + r.reshape(n, n).T)).reshape(-1) for r in A_s])
    X0 = rng.uniform(-1, 1, (n, n))
    X0 = X0 @ X0.T + 0.5 * np.eye(n)
    yref = rng.uniform(-1, 1, m)
    S = rng.uniform(-1, 1, (n, n))
    S = S @ S.T + 0.5 * np.eye(n)
    Af = rng.uniform(-1, 1, (m, nfree))
    A = np.concatenate([Af, A_s], axis=1)
    b = A_s @ X0.reshape(-1) + Af @ rng.uniform(-1, 1, nfree)
    c = np.concatenate([Af.T @ yref, A_s.T @ yref + S.reshape(-1)])
    K = dict(f=nfree, s=[n])
    _, y1, info1 = _sedumi_both(LMI, A, b, c, K, blkdiag=False)
    A_r, b_r, c_r, K_r, B, y0 = tpre.eliminate_free_vars(A, b, c, K)
    _, y2r, info2 = _sedumi_both(LMI, A_r, b_r, c_r, K_r, blkdiag=False)
    assert info1["solved"] and info2["solved"]
    y2 = y0 + B @ y2r
    assert abs(b @ y1 - b @ y2) < 1e-5
    assert np.linalg.norm(c[:nfree] - Af.T @ y2) < 1e-6


def _two_block_instance():
    """test_sedumi.py::test_blkdiag_decomposition_splits_and_matches."""
    rng = np.random.default_rng(8)
    n1, n2, m = 3, 3, 4
    A1, b1, c1 = _sdp_instance(rng, m, n1)
    A2, _, c2 = _sdp_instance(rng, m, n2)

    def embed(v1, v2):
        M = np.zeros((n1 + n2, n1 + n2))
        M[:n1, :n1] = v1.reshape(n1, n1)
        M[n1:, n1:] = v2.reshape(n2, n2)
        return M.reshape(-1)

    A = np.stack([embed(A1[i], A2[i]) for i in range(m)])
    return A, b1 + A2 @ np.eye(n2).reshape(-1), embed(c1, c2), dict(s=[n1 + n2])


def test_blkdiag_decomposition_splits_and_matches():
    A, b, c, K = _two_block_instance()
    red = tpre.blkdiag_decompose(A, b, c, K)
    assert sorted(red.K["s"]) == [3, 3]
    x_ref, y_ref, _ = _sedumi_both(LMI, A, b, c, K, blkdiag=False)
    x_red, y_red, info = _sedumi_both(LMI, red.A, red.b, red.c, red.K, blkdiag=False)
    assert info["solved"]
    x_rec, y_rec = red.recover_primal(x_red), red.recover_dual(y_red)
    assert abs(b @ y_ref - b @ y_rec) < 1e-5
    assert abs(c @ x_ref - c @ x_rec) < 1e-5
    assert np.linalg.norm(A @ x_rec - b) < 1e-5


def test_sedumi_auto_blkdiag_multiblock():
    rng = np.random.default_rng(9)
    A1, b1, c1 = _sdp_instance(rng, 4, 3)
    A2, b2, c2 = _sdp_instance(rng, 4, 2)
    A, b, c = np.concatenate([A1, A2], axis=1), b1 + b2, np.concatenate([c1, c2])
    x_on, y_on, info_on = _sedumi_both(LMI, A, b, c, dict(s=[3, 2]))
    x_off, y_off, info_off = _sedumi_both(LMI, A, b, c, dict(s=[3, 2]), blkdiag=False)
    assert info_on["solved"] and info_off["solved"]
    assert abs(b @ y_on - b @ y_off) < 1e-5
    assert abs(c @ x_on - c @ x_off) < 1e-5


# ---------------------------------------------------------------------------
# The copy of preprocess.py: the same arrays, to the bit
# ---------------------------------------------------------------------------


def _same_arrays(got, want):
    if isinstance(want, dict):
        assert got == want
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_arrays(g, w)
    elif want is None or isinstance(want, (int, float)):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_preprocess_copy_gives_the_same_arrays():
    rng = np.random.default_rng(5)
    A = rng.uniform(-1, 1, (4, 6))
    b = rng.uniform(-1, 1, 4)
    A0, b0 = np.insert(A, 2, 0.0, axis=0), np.insert(b, 2, 0.0)
    Adep, bdep = np.vstack([A, 2.0 * A[1]]), np.concatenate([b, [2.0 * b[1]]])
    for args, kw in (((A0, b0), {}), ((Adep, bdep), dict(use_qr=True)),
                     ((Adep, bdep), {})):
        _same_arrays(tpre.clean_linear(*args, **kw), jpre.clean_linear(*args, **kw))
    free = chip_smoke.sedumi_all_cone_types()
    free = free[:3] + (dict(f=1, l=3, s=[3]),)
    A_f = np.concatenate([free[0][:, :4], free[0][:, -9:]], axis=1)
    c_f = np.concatenate([free[2][:4], free[2][-9:]])
    args = (A_f, free[1], c_f, free[3])
    _same_arrays(tpre.eliminate_free_vars(*args), jpre.eliminate_free_vars(*args))
    for inst in (_two_block_instance(), args):
        t, j = tpre.blkdiag_decompose(*inst), jpre.blkdiag_decompose(*inst)
        for f in ("A", "b", "c", "K", "indx", "T", "n_orig"):
            _same_arrays(getattr(t, f), getattr(j, f))
        x, y = rng.uniform(-1, 1, t.A.shape[1]), rng.uniform(-1, 1, t.A.shape[0])
        _same_arrays(t.recover_primal(x), j.recover_primal(x))
        _same_arrays(t.recover_dual(y), j.recover_dual(y))
        tp, jp = tpre.SedumiPresolve.build(*inst), jpre.SedumiPresolve.build(*inst)
        for f in ("A", "b", "c", "K", "_B", "_y0"):
            _same_arrays(getattr(tp, f), getattr(jp, f))
        x, y = rng.uniform(-1, 1, tp.A.shape[1]), rng.uniform(-1, 1, tp.A.shape[0])
        _same_arrays(tp.recover(x, y), jp.recover(x, y))
    with pytest.raises(ValueError, match="Lorentz"):
        tpre.blkdiag_decompose(*chip_smoke.sedumi_all_cone_types())

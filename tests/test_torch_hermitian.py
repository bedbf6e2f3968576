"""The port's Hermitian PSD cones (algebra/hypercomplex.py,
cones/hermitian.py, Program.add_hermitian_constraint) against conex_tpu,
in f64 on the CPU.

The same numpy inputs go through both packages.  Tolerances:

* the algebra and the cone methods that compute no spectrum (products,
  exponentials, the Schur phase, the steps, the octonion heuristics):
  1e-12 relative, the same f64 arithmetic summed in other orders;
* the exact eigenvalue oracle (least squares, then polynomial roots):
  1e-12 of the spectrum's scale;
* a spectrum estimate of d <= 4: the cold estimator converges, so the f64
  Rayleigh quotient hides its f32 sweep's rounding (1e-10, as in
  tests/test_torch_sym_mu.py); the warm estimator takes few steps from a
  seed and rounds its f32 sweep differently in XLA and PyTorch (1e-6, the
  same file's bar);
* a solve: ``num_iterations``, ``solved`` and ``fail`` equal.  For
  d <= 4 the warm estimator's f32 rounding rides along the trajectory as
  in tests/test_torch_solve.py: ``stats_k`` and ``y`` at 1e-6 (3.2e-7
  and 2.5e-8 measured).  For d = 8 (no spectrum, no f32 stage) ``y`` at
  1e-8 and ``stats_k`` at 1e-7 while the scaled k stays at or below 1e3
  (the endgame rule of tests/test_torch_equality_qp.py): the JAX package
  alone moves ``stats_k`` by up to 5.4e-8 there with b moved by 2^-52
  (``test_octonion_trajectory_moves_as_far_in_jax_alone``).  Scenario 0
  of the d = 8 batch passes k = 1e3 at its iteration 7, after which the
  two packages part by up to 9e-6;
* a saved state (the final iterate, past k = 1e3): 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import conex_tpu
from conex_tpu.algebra import hypercomplex as jhc
from conex_tpu.algebra import sym as jsym
from conex_tpu.cones import hermitian as jherm
from conex_tpu.parallel.sharded import solve_scenarios as jsolve

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.algebra import hypercomplex as thc
from conex_tpu_torch.algebra import sym as tsym
from conex_tpu_torch.cones import hermitian as therm

K_HOLD = 1e3


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _close(got, want, tol=1e-12):
    assert _rel(got, want) <= tol, (_rel(got, want), tol)


def rand_hermitian(d, n, rng, lead=()):
    x = rng.uniform(-1, 1, lead + (d, n, n))
    x[..., 0, :, :] = 0.5 * (x[..., 0, :, :] + np.swapaxes(x[..., 0, :, :], -1, -2))
    x[..., 1:, :, :] = 0.5 * (x[..., 1:, :, :] - np.swapaxes(x[..., 1:, :, :], -1, -2))
    return x


def _order(d):
    return 3 if d == 8 else 5


# ---------------------------------------------------------------------------
# algebra/hypercomplex.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_hypercomplex_functions_match_jax(d):
    rng = np.random.default_rng(d)
    n = _order(d)
    # x broadcasts against y's leading axes, as w against A in the Schur phase.
    x = rng.uniform(-1, 1, (2, d, n, n))
    y = rng.uniform(-1, 1, (3, 1, d, n, n))
    for name in ("multiply", "jordan_multiply", "quadratic_representation",
                 "trace_inner_product"):
        _close(getattr(thc, name)(_t(x), _t(y)),
               getattr(jhc, name)(jnp.asarray(x), jnp.asarray(y)))
    for name in ("conj_transpose", "make_hermitian", "exponential_map"):
        _close(getattr(thc, name)(_t(y)), getattr(jhc, name)(jnp.asarray(y)))
    np.testing.assert_array_equal(thc.structure_tensor(d), jhc.structure_tensor(d))
    np.testing.assert_array_equal(thc.identity(d, n).numpy(),
                                  np.asarray(jhc.identity(d, n)))
    w = rand_hermitian(d, n, rng)
    w[0] += 2 * np.eye(n)
    s = 0.2 * rand_hermitian(d, n, rng)
    for name in ("geodesic_update", "geodesic_update_scaled"):
        _close(getattr(thc, name)(_t(w), _t(s)),
               getattr(jhc, name)(jnp.asarray(w), jnp.asarray(s)))
    if d == 8:
        for mod in (thc, jhc):
            with pytest.raises(ValueError, match="faithful"):
                mod.real_representation(x if mod is jhc else _t(x))
    else:
        _close(thc.real_representation(_t(y)), jhc.real_representation(jnp.asarray(y)))
    ev_t, ev_j = thc.eigenvalues(_t(w)), np.asarray(jhc.eigenvalues(jnp.asarray(w)))
    assert ev_t.dtype == torch.float64 and ev_t.shape == (n,)
    np.testing.assert_allclose(ev_t.numpy(), ev_j, rtol=0,
                               atol=1e-12 * np.abs(ev_j).max())


def test_structure_tensor_is_made_once_per_type_and_device():
    with pytest.raises(ValueError, match="1, 2, 4, or 8"):
        thc.structure_tensor(3)
    a = thc._constant("T", 4, torch.float64, "cpu")
    assert thc._constant("T", 4, torch.float64, torch.device("cpu")) is a
    assert thc._constant("T", 4, torch.float32, "cpu") is not a
    x = torch.ones((4, 2, 2), dtype=torch.float64)
    thc.multiply(x, x)
    assert thc._TENSORS[("T", 4, torch.float64, torch.device("cpu"))] is a


# ---------------------------------------------------------------------------
# cones/hermitian.py
# ---------------------------------------------------------------------------


def _cone_data(d, S=2, B=2, v=3, seed=0):
    rng = np.random.default_rng(seed + d)
    n = _order(d)
    A = rand_hermitian(d, n, rng, (S, B, v))
    C = np.zeros((S, B, d, n, n))
    C[:, :, 0] = (n + 1.0) * np.eye(n)
    w = rand_hermitian(d, n, rng, (S, B))
    w[:, :, 0] += 2.0 * np.eye(n)
    y = rng.uniform(-0.5, 0.5, (S, v))
    return A, C, w, y


def _jax(A, C, fn, *args):
    """fn(JAX cone, *args) for each scenario, vmapped over the leading axis
    of A, C and args as the JAX package's solve_scenarios vmaps its solve
    (the warm/cold ``lax.cond`` becomes a choice per scenario)."""
    run = jax.jit(jax.vmap(lambda A_, C_, *a: fn(jherm.HermitianCone(A=A_, C=C_), *a)))
    args = jax.tree.map(jnp.asarray, args)
    return jax.tree.map(np.asarray, run(jnp.asarray(A), jnp.asarray(C), *args))


def _states(d, w=None, fields=None):
    """(port state, JAX state as numpy) of the iterate w, or of the six
    HermState fields (carried into the port by convert.herm_state)."""
    if d == 8:
        return convert.herm_state(w), w
    if fields is None:
        fields = [x.numpy() for x in therm.make_herm_state(_t(w))]
    ts = convert.herm_state(fields)
    assert isinstance(ts, therm.HermState)
    return ts, jherm.HermState(*fields)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_hermitian_cone_methods_match_jax(d):
    A, C, w, y = _cone_data(d)
    S, B = A.shape[:2]
    cone = convert.hermitian_cone(A, C)
    assert (cone.scenarios, cone.batch, cone.d, cone.num_vars) == (S, B, d, 3)
    assert cone.octonion == (d == 8) and cone.rank() == B * _order(d)
    assert cone.supports_line_search is False and cone.dual_scale == 1.0
    ident = cone.identity_state(torch.float64)
    want = _jax(A, C, lambda j: j.identity_state(jnp.float64))
    for g, r in zip(jax.tree.leaves(ident), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_np(g), r)
    ts, js = _states(d, w)
    for g, r in zip(cone.schur(ts), _jax(A, C, lambda j, s: j.schur(s), js)):
        _close(g, r)
    cw = np.array([0.7, 1.3])

    # prepare_step from the cold sentinel, then take_step.
    tc, tinf, tsq = cone.prepare_step(ts, _t(y), _t(cw), 1.0)
    jc, jinf, jsq = _jax(A, C, lambda j, *a: j.prepare_step(*a, 1.0), js, y, cw)
    _close(tc.WS, jc.WS)
    _close(tsq, jsq)
    spectral = 1e-10 if d < 8 else 1e-12
    _close(tinf, jinf, spectral)
    if d < 8:
        _close(tc.lam, jc.lam, 1e-10)
    if d == 1:
        # f32-quality eigenvectors.  For d > 1 every eigenvalue of R(WS)
        # has multiplicity d, so its eigenvectors are not unique.
        for g, r in zip(tc.seeds, jc.seeds):
            np.testing.assert_allclose(_np(g), r, atol=1e-5)
    # The solve loop's step size, 2 / norminf^2 up to 1.
    step = np.minimum(1.0, 2.0 / jinf ** 2)
    tw = cone.take_step(ts, tc, _t(step))
    jw = _jax(A, C, lambda j, *a: j.take_step(*a), js, jc, step)
    _close(cone.dual_variable(tw), jw if d == 8 else jw.w)
    if d < 8:
        _close(tw.lam, jw.lam, 1e-10)

    # affine_step and slack_stats.
    _close(cone.dual_variable(cone.affine_step(ts, _t(y), 0.0)),
           _jax(A, C, lambda j, *a: j.dual_variable(j.affine_step(*a, 0.0)), js, y))
    for g, r in zip(cone.slack_stats(ts, _t(y), _t(cw)),
                    _jax(A, C, lambda j, *a: j.slack_stats(*a), js, y, cw)):
        _close(g, r, spectral)
    if d == 8:
        return

    # The warm estimator: from the state the first step left, scenario 0
    # warm and scenario 1 back at the cold sentinel (a per-scenario select).
    fields = [np.array(_np(x)) for x in tw]
    fields[5][1] = 0.0
    ts2, js2 = _states(d, fields=fields)
    tc2, tinf2, tsq2 = cone.prepare_step(ts2, _t(y), _t(cw), 1.0)
    jc2, jinf2, jsq2 = _jax(A, C, lambda j, *a: j.prepare_step(*a, 1.0), js2, y, cw)
    _close(tsq2, jsq2)
    # Each scenario took its own branch: the port's estimators to the bit.
    R = thc.real_representation(tc2.WS)
    cold = tsym.extreme_eigenvalues_seeded(R)[3]
    warm = tsym.extreme_eigenvalues_warm(R, *ts2[1:], num_steps=16)[3]
    torch.testing.assert_close(tc2.lam, torch.stack([warm[0], cold[1]]), rtol=0, atol=0)
    _close(tinf2[0], jinf2[0], 1e-6)
    _close(tinf2[1], jinf2[1], 1e-10)
    _close(tc2.lam[0], jc2.lam[0], 1e-6)
    _close(tc2.lam[1], jc2.lam[1], 1e-10)
    for g, r in zip(cone.slack_stats(ts2, _t(y), _t(cw)),
                    _jax(A, C, lambda j, *a: j.slack_stats(*a), js2, y, cw)):
        _close(g, r, 1e-6)


def test_force_cold_runs_the_cold_estimator_in_both(monkeypatch):
    d = 2
    A, C, w, y = _cone_data(d)
    cone = convert.hermitian_cone(A, C)
    fields = [x.numpy() for x in therm.make_herm_state(_t(w))]
    fields[5] = np.ones_like(fields[5])  # warm everywhere
    ts, js = _states(d, fields=fields)
    monkeypatch.setattr(therm, "FORCE_COLD", True)
    monkeypatch.setattr(jherm, "FORCE_COLD", True)
    cw = np.array([0.7, 1.3])
    tc, tinf, _ = cone.prepare_step(ts, _t(y), _t(cw), 1.0)
    jc, jinf, _ = _jax(A, C, lambda j, *a: j.prepare_step(*a, 1.0), js, y, cw)
    _close(tinf, jinf, 1e-10)
    _close(tc.lam, jc.lam, 1e-10)
    # ... which is what the cold estimator gives on R(WS).
    want = tsym.extreme_eigenvalues_seeded(thc.real_representation(tc.WS))[3]
    _close(tc.lam, want, 1e-15)


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------


def _herm_instance(d, n, m, rng, B=2):
    A = rand_hermitian(d, n, rng, (B, m))
    C = np.zeros((B, d, n, n))
    C[:, 0] = (n + 1.0) * np.eye(n)
    X0 = rand_hermitian(d, n, rng, (B,))
    X0 = thc.multiply(_t(X0), thc.conj_transpose(_t(X0))).numpy()
    X0[:, 0] += 0.1 * np.eye(n)
    return A, C, np.einsum("bvdij,bdij->v", A, X0)


def _batch_both(d, b_scale=1.0):
    """solve_scenarios of 3 scenarios in both packages, as numpy."""
    n, m, S = _order(d) + (1 if d < 8 else 0), 3, 3
    rng = np.random.default_rng(d)
    A, C, b = map(np.stack, zip(*[_herm_instance(d, n, m, rng) for _ in range(S)]))
    b = b * b_scale
    e = np.zeros(A.shape[:2] + A.shape[3:])
    e[:, :, 0] = np.eye(n)
    sc = dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))
    cfg = dict(max_iterations=50, prepare_dual_variables=True)
    jws = jax.vmap(jherm.make_herm_state)(jnp.asarray(e)) if d < 8 else jnp.asarray(e)
    rj = jsolve((jherm.HermitianCone(A=jnp.asarray(A), C=jnp.asarray(C)),), (),
                jnp.asarray(b), (jws,), {k: jnp.asarray(v) for k, v in sc.items()},
                conex_tpu.SolverConfig(**cfg))
    tws = _states(d, e)[0]
    rt = ct.solve_scenarios((convert.hermitian_cone(A, C),), (), convert.tensor(b),
                            (tws,), convert.scalars(sc), ct.SolverConfig(**cfg))
    return jax.tree.map(np.asarray, rj), convert.to_numpy(rt)


def _held(k, n):
    past = np.flatnonzero(k[:n] > K_HOLD)
    return int(past[0]) if past.size else n


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_solve_scenarios_matches_jax(d):
    rj, rt = _batch_both(d)
    np.testing.assert_array_equal(rt.num_iterations, rj.num_iterations)
    np.testing.assert_array_equal(rt.solved, rj.solved)
    np.testing.assert_array_equal(rt.fail, rj.fail)
    assert rj.solved.all()
    k_tol, y_tol = (1e-6, 1e-6) if d < 8 else (1e-7, 1e-8)
    for s in range(3):
        n = int(rj.num_iterations[s])
        h = n if d < 8 else _held(rj.stats_k[s], n)
        np.testing.assert_allclose(rt.stats_k[s, :h], rj.stats_k[s, :h], rtol=k_tol)
        _close(rt.y[s], rj.y[s], y_tol)
    w_t = rt.ws[0] if d == 8 else rt.ws[0].w
    w_j = rj.ws[0] if d == 8 else rj.ws[0].w
    _close(w_t, w_j, 1e-5)
    if d == 8:  # the endgame case the docstring names
        assert _held(rj.stats_k[0], int(rj.num_iterations[0])) == 7


def test_octonion_trajectory_moves_as_far_in_jax_alone():
    """The d = 8 batch's stats_k in the JAX package, with b moved by one
    rounding: past the 1e-8 that an f64 port could otherwise be held to,
    and as far as the port lies from it."""
    rj, _ = _batch_both(8)
    moved, _ = _batch_both(8, 1.0 - 2.0 ** -52)
    dev = 0.0
    for s in range(3):
        h = _held(rj.stats_k[s], int(rj.num_iterations[s]))
        dev = max(dev, float(np.max(np.abs(moved.stats_k[s, :h] / rj.stats_k[s, :h] - 1))))
    assert 1e-8 < dev < 1e-7


# ---------------------------------------------------------------------------
# Program: tests/test_hermitian.py's solves, checkpoints, guards
# ---------------------------------------------------------------------------


def _both(m, build):
    jp, tp = conex_tpu.Program(m), ct.Program(m, device="cpu")
    build(jp)
    build(tp)
    return jp, tp


def _solve_both(jp, tp, b, tol, **cfg):
    jr = jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tr = tp.solve(b, ct.SolverConfig(**cfg))
    assert jr.solved and tr.solved
    assert tr.num_iterations == jr.num_iterations
    _close(tr.y, jr.y, tol)
    return jr, tr


def herm_feasible_instance(d, n, m, rng):
    A, C, b = _herm_instance(d, n, m, rng, B=1)
    return A[0], C[0], b


def test_real_hermitian_matches_lmi_on_both():
    """tests/test_hermitian.py::test_real_hermitian_matches_lmi."""
    A, C, b = herm_feasible_instance(1, 5, 3, np.random.default_rng(0))
    cfg = dict(max_iterations=50)
    _, tr1 = _solve_both(*_both(3, lambda p: p.add_hermitian_constraint(A, C)),
                         b, 1e-6, **cfg)
    _, tr2 = _solve_both(*_both(3, lambda p: p.add_lmi_constraint(A[:, 0], C[0])),
                         b, 1e-6, **cfg)
    np.testing.assert_allclose(tr1.y, tr2.y, atol=1e-6)


def test_complex_sdp_matches_real_embedding_on_both():
    """tests/test_hermitian.py::test_complex_sdp_matches_real_embedding."""
    A, C, b = herm_feasible_instance(2, 4, 3, np.random.default_rng(1))
    emb = lambda X: np.block([[X[0], -X[1]], [X[1], X[0]]])  # noqa: E731
    cfg = dict(max_iterations=60)
    _, tr1 = _solve_both(*_both(3, lambda p: p.add_hermitian_constraint(A, C)),
                         b, 1e-6, **cfg)
    A_emb = np.stack([emb(A[i]) for i in range(3)])
    _, tr2 = _solve_both(*_both(3, lambda p: p.add_lmi_constraint(A_emb, emb(C))),
                         2.0 * b, 1e-6, **cfg)
    np.testing.assert_allclose(tr1.y, tr2.y, atol=1e-5)


def test_complex_input_api_on_both():
    """tests/test_hermitian.py::test_complex_input_api: a complex dtype A."""
    rng = np.random.default_rng(2)
    n, m = 3, 2
    A = rng.normal(size=(m, n, n)) + 1j * rng.normal(size=(m, n, n))
    A = 0.5 * (A + np.conj(np.swapaxes(A, 1, 2)))
    C = np.eye(n) * (n + 1.0) + 0j
    X0 = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    X0 = X0 @ np.conj(X0.T) + 0.1 * np.eye(n)
    b = np.real(np.einsum("vij,ji->v", A, X0))
    jp, tp = _both(m, lambda p: p.add_hermitian_constraint(A, C))
    assert tp._blocks[0].A.shape == (1, 1, m, 2, n, n)
    _, tr = _solve_both(jp, tp, b, 1e-6, max_iterations=60, prepare_dual_variables=True)
    S = C - np.einsum("v,vij->ij", tr.y, A)
    assert np.linalg.eigvalsh(S).min() >= -1e-6
    _close(tp.get_dual_variable(0), jp.get_dual_variable(0), 1e-6)


def test_quaternion_sdp_kkt_on_both():
    """tests/test_hermitian.py::test_quaternion_sdp_kkt."""
    A, C, b = herm_feasible_instance(4, 3, 2, np.random.default_rng(3))
    _, tr = _solve_both(*_both(2, lambda p: p.add_hermitian_constraint(A, C)),
                        b, 1e-6, max_iterations=60)
    S = C - np.einsum("v,vdij->dij", tr.y, A)
    R = thc.real_representation(_t(S)).numpy()
    assert np.linalg.eigvalsh(0.5 * (R + R.T)).min() >= -1e-6
    assert np.all(np.diff(1.0 / tr.stats_inv_sqrt_mu ** 2) <= 1e-9)


def _octonion_program():
    """tests/test_hermitian.py::test_octonion_sdp_solves' instance."""
    rng = np.random.default_rng(4)
    n, m = 3, 2
    A = rand_hermitian(8, n, rng, (m,))
    C = np.zeros((8, n, n))
    C[0] = np.eye(n) * 10.0
    X0 = np.zeros((8, n, n))
    X0[0] = np.eye(n)
    return A, C, np.einsum("vdij,dij->v", A, X0)


def test_octonion_sdp_solves_on_both():
    A, C, b = _octonion_program()
    jp, tp = _both(2, lambda p: p.add_hermitian_constraint(A, C))
    _, tr = _solve_both(jp, tp, b, 1e-8, max_iterations=60,
                        prepare_dual_variables=True)
    assert np.all(np.diff(1.0 / tr.stats_inv_sqrt_mu ** 2) <= 1e-9)
    # The bare octonion iterate through get_dual_variable: <A_i, X> = b_i.
    X = tp.get_dual_variable(0)
    assert X.shape == (8, 3, 3)
    _close(X, jp.get_dual_variable(0), 1e-8)
    np.testing.assert_allclose(np.einsum("vdij,dij->v", A, X), b, atol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_checkpoints_cross_between_the_packages(d):
    """A JAX save_state loads into the port and a port save_state into
    JAX; each warmstart resumes in as many iterations as JAX's own."""
    n = 3 if d == 8 else 4
    A, C, b = herm_feasible_instance(d, n, 2, np.random.default_rng(20 + d))
    cfg = dict(max_iterations=60, prepare_dual_variables=True)
    jp, tp = _both(2, lambda p: p.add_hermitian_constraint(A, C))
    cold = jp.solve(1.05 * b, conex_tpu.SolverConfig(**cfg)).num_iterations
    jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tp.solve(b, ct.SolverConfig(**cfg))
    jstate, tstate = jp.save_state(), tp.save_state()
    (jw,), (tw,) = jstate["ws"], tstate["ws"]
    if d == 8:
        assert isinstance(tw, np.ndarray) and tw.shape == (1, 8, n, n)
        _close(tw, jw, 1e-6)
    else:
        assert type(tw).__name__ == "HermState" and tw._fields == jw._fields
        assert all(isinstance(x, np.ndarray) for x in tw)
        assert [x.shape for x in tw] == [x.shape for x in jw]
        _close(tw.w, jw.w, 1e-6)
    warm = dict(cfg, initialization_mode=conex_tpu.WARMSTART)
    # Not 1.01 b: from a centered point at the capped k, b moved by a
    # factor 1 + t gives a first d_inf of t in exact arithmetic, and 0.01
    # is the final-centering tolerance, so rounding would pick the count.
    b2 = 1.05 * b
    # JAX's load_state keeps the container it is given: a HermState is
    # rebuilt from the port's six fields, as from a stored checkpoint.
    to_jax = dict(tstate, ws=(tw if d == 8 else jherm.HermState(*tw),))
    runs = []
    for pkg, state in ((conex_tpu, jstate), (ct, jstate), (ct, tstate), (conex_tpu, to_jax)):
        p = pkg.Program(2) if pkg is conex_tpu else pkg.Program(2, device="cpu")
        p.add_hermitian_constraint(A, C)
        p.load_state(state)
        runs.append(p.solve(b2, pkg.SolverConfig(**warm)))
    ref = runs[0]
    assert ref.solved and ref.num_iterations < cold
    for r in runs[1:]:
        assert r.solved and r.num_iterations == ref.num_iterations
        _close(r.y, ref.y, 1e-6)


def test_hermitian_guards_raise_the_same_errors():
    rng = np.random.default_rng(5)
    A, C, _ = herm_feasible_instance(2, 3, 2, rng)
    A8 = rand_hermitian(8, 4, rng, (2,))
    C8 = np.zeros((8, 4, 4))
    bad_sym = A.copy()
    bad_sym[0, 0, 0, 1] += 1.0
    bad_skew = A.copy()
    bad_skew[0, 1, 0, 0] = 1.0
    cases = [
        ((np.zeros((2, 3, 3, 3)), np.zeros((3, 3, 3))), "1, 2, 4, or 8"),
        ((A8, C8), "order <= 3"),
        ((bad_sym, C), "symmetric"),
        ((bad_skew, C), "skew"),
        ((A[None], C), "shapes"),
    ]
    for pkg in (conex_tpu, ct):
        p = pkg.Program(2) if pkg is conex_tpu else pkg.Program(2, device="cpu")
        for args, msg in cases:
            with pytest.raises(ValueError, match=msg):
                p.add_hermitian_constraint(*args)
    # A variable subset is accepted (the supernodal KKT path), as in JAX.
    jp, tp = conex_tpu.Program(3), ct.Program(3, device="cpu")
    for p in (jp, tp):
        p.add_hermitian_constraint(A, C, variables=[1, 2])
    assert tp._blocks[0].vars_ == jp._blocks[0].vars_ == (1, 2)


def test_hermitian_updates_match_jax():
    A, C, b = herm_feasible_instance(4, 3, 2, np.random.default_rng(6))
    jp, tp = _both(2, lambda p: p.add_hermitian_constraint(A, C))
    held = tp._blocks[0].A
    for p in (jp, tp):
        p.update_linear_operator(0, 0.3, variable=1, row=0, col=2, hyper_complex_dim=2)
        p.update_linear_operator(0, -0.2, variable=0, row=1, col=1, hyper_complex_dim=0)
        p.update_affine_term(0, 0.1, row=2, col=0, hyper_complex_dim=3)
        p.update_affine_term(0, 4.5, row=1, col=1)
        with pytest.raises(ValueError, match="imaginary diagonal"):
            p.update_linear_operator(0, 1.0, variable=0, row=1, col=1, hyper_complex_dim=1)
    for f in dataclasses.fields(tp._blocks[0]):
        x = getattr(tp._blocks[0], f.name)
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x[0].numpy(), np.asarray(getattr(jp._blocks[0], f.name)))
    assert not torch.equal(held, tp._blocks[0].A)  # the caller's tensor is kept
    _solve_both(jp, tp, b, 1e-6, max_iterations=60)


def test_hermitian_program_runs_on_the_card_unless_asked_for_the_cpu():
    assert ct.Program(2).device.type == "cuda"
    assert "HermitianCone" in ct.__all__ and ct.HermitianCone is therm.HermitianCone


# ---------------------------------------------------------------------------
# tests/test_hermitian.py's oracle cases through the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4])
def test_exact_eigenvalue_oracle_matches_real_representation(d):
    rng = np.random.default_rng(7 + d)
    x = _t(rand_hermitian(d, 5, rng))
    ev = thc.eigenvalues(x).numpy()
    ev_R = np.linalg.eigvalsh(thc.real_representation(x).numpy())
    np.testing.assert_allclose(ev, ev_R[::d], atol=1e-8)
    np.testing.assert_allclose(ev.sum(), float(torch.trace(x[0])), atol=1e-8)


def test_exact_eigenvalue_oracle_octonion():
    rng = np.random.default_rng(88)
    x = _t(rand_hermitian(8, 3, rng))
    ev = thc.eigenvalues(x).numpy()
    assert ev.shape == (3,)
    np.testing.assert_allclose(ev.sum(), float(torch.trace(x[0])), atol=1e-8)
    np.testing.assert_allclose((ev ** 2).sum(), float(thc.trace_inner_product(x, x)),
                               atol=1e-8)
    ev2 = thc.eigenvalues(thc.jordan_multiply(x, x)).numpy()
    np.testing.assert_allclose(np.sort(ev ** 2), ev2, atol=1e-8)


@pytest.mark.parametrize("d", [2, 4])
def test_hermitian_estimator_vs_exact_oracle_clustered(d):
    rng = np.random.default_rng(17 + d)
    x = rand_hermitian(d, 8, rng)
    ev_exact = thc.eigenvalues(_t(x)).numpy()
    lo, hi = tsym.extreme_eigenvalues(thc.real_representation(_t(x)))
    assert abs(float(hi) - ev_exact.max()) <= 1e-6 * max(1.0, abs(ev_exact.max()))
    assert abs(float(lo) - ev_exact.min()) <= 1e-6 * max(1.0, abs(ev_exact.min()))
    jlo, jhi = jsym.extreme_eigenvalues(jhc.real_representation(jnp.asarray(x)))
    _close(torch.stack([lo, hi]), np.array([jlo, jhi]), 1e-10)


def test_one_f32_rounding_of_the_warm_seeds_moves_stats_k(monkeypatch):
    """Why chip_smoke.py's phase 4f holds its small f64 batch to the CPU
    by stats_k at 1e-5 and by y at 1e-9: on the CPU alone, the warm seeds
    moved by one f32 rounding (a relative 2^-24, as a card's f32 sweep
    rounds otherwise) move stats_k by 1e-6 to 1e-5 and y by less than
    1e-11."""
    import chip_smoke

    orig = tsym.extreme_eigenvalues_warm
    config = chip_smoke.herm_config()
    A, C, b = chip_smoke.herm_workload(4, 2, 8, 4, seed=1, dtype="float64")
    base = convert.to_numpy(ct.solve_scenarios(*chip_smoke.herm_args(A, C, b, "cpu"),
                                               config))
    g = torch.Generator().manual_seed(0)

    def rounded(M, *seeds_and_lam, num_steps=16):
        *seeds, lam = seeds_and_lam
        seeds = [v * (1 + 2.0 ** -24 * (2 * torch.rand(v.shape, generator=g,
                                                        dtype=v.dtype) - 1))
                 for v in seeds]
        return orig(M, *seeds, lam, num_steps=num_steps)

    monkeypatch.setattr(tsym, "extreme_eigenvalues_warm", rounded)
    moved = convert.to_numpy(ct.solve_scenarios(
        *chip_smoke.herm_args(A, C, b, "cpu"), config))
    dk = np.max(np.abs(moved.stats_k - base.stats_k) / base.stats_k)
    dy = np.max(np.abs(moved.y - base.y) / (np.abs(base.y) + 1e-9))
    assert 1e-6 < dk < chip_smoke.HERM_K_LIMIT, dk
    assert dy < 1e-11 < chip_smoke.HERM_Y_LIMIT, dy


def test_chip_smoke_copies_the_hermitian_instances():
    """chip_smoke.py's phases 4f and 5e build bench_hermitian.py's batch,
    bench_accuracy.py's instances and the tests' models from their own
    copies (the script imports nothing of the JAX package)."""
    import sys
    from pathlib import Path

    import chip_smoke

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    import bench_hermitian

    want = bench_hermitian._herm_workload(3, 2, 5, 4, np.random.default_rng(0), np.float32)
    for g, w in zip(chip_smoke.herm_workload(3, 2, 5, 4), want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(chip_smoke.rand_hermitian(8, 3, rng),
                                  rand_hermitian(8, 3, np.random.default_rng(4)))
    prog, b = chip_smoke.octonion_program("cpu")
    A, C, want_b = _octonion_program()
    np.testing.assert_array_equal(b, want_b)
    np.testing.assert_array_equal(prog._blocks[0].A[0, 0].numpy(), A)

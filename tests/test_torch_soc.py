"""The port's SOC slice against conex_tpu, in f64: the spin-factor algebra
(algebra/spin.py), the SOC cone (cones/soc.py), the general solve path
with SOC blocks, ``Program.add_soc_constraint`` and ``loop.solve``.

The same numpy inputs go through both packages.  Tolerances:

* the algebra and one cone call: the same closed forms, sums taken in
  other orders, rtol 1e-12 (atol 1e-12 where an entry can cancel to 0);
* trajectories: iteration counts and every status flag exactly equal; k
  and stats_k within rtol 1e-6, y within 1e-6 and the final iterate w
  within 1e-5 of their 2-norm in every scenario.  The packages sum in
  other orders; the
  difference starts at 1e-16 and grows with the conditioning of G as k
  climbs.  Measured: ~1e-9 on most scenarios, and 1.1e-7 at the last
  iterations of one whose scaled k climbs to 5.7e3 in 20 iterations
  (where it doubles every iteration), 1.8e-6 on that scenario's final w.  d_inf near convergence is a
  cancellation of terms of size k |slack|, so its absolute difference is
  about k times that relative one: an absolute floor of 1e-4 (measured
  4.5e-5 in that scenario, 1e-9 elsewhere).
"""


import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import conex_tpu
from conex_tpu.algebra import spin as jspin
from conex_tpu.config import SolverConfig as JConfig
from conex_tpu.cones.soc import SOCCone as JSOC
from conex_tpu.parallel.sharded import solve_scenarios as jsolve
from conex_tpu.solver.loop import solve_compiled as jsolve_one

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.algebra import spin as tspin
from conex_tpu_torch.solver import loop as tloop


def random_socp(rng, S, nc, n, m, feasible=True):
    """The recipe of tests/test_fused_socp.py::random_socp: S programs of
    nc Lorentz cones of dim n+1 over m variables; feasible ones have
    b = A(x) for an interior dual point x."""
    A = rng.standard_normal((S, nc, n + 1, m))
    if feasible:
        x = rng.standard_normal((S, nc, n + 1))
        x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + rng.uniform(0.5, 1.5, (S, nc))
        b = 2.0 * np.einsum("scnv,scn->sv", A, x)
    else:
        b = rng.standard_normal((S, m))
    c = rng.standard_normal((S, nc, n + 1))
    c[..., 0] = np.linalg.norm(c[..., 1:], axis=-1) + rng.uniform(0.5, 2.0, (S, nc))
    return A, c, b


def _interior(rng, shape):
    """Points strictly inside the Lorentz cone."""
    x = rng.standard_normal(shape)
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + rng.uniform(0.2, 1.0, shape[:-1])
    return x


def _identity(S, nc, n1):
    w = np.zeros((S, nc, n1))
    w[..., 0] = 1.0
    return w


def _cold_scalars(S):
    return dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))


def _close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_per_scenario(got, want, rtol):
    """|got_s - want_s| <= rtol |want_s| in the 2-norm, for every scenario s
    (the rows of an unbounded scenario grow to ~1e10; an entrywise atol
    would hide the others)."""
    got = np.asarray(got).reshape(len(want), -1)
    want = np.asarray(want).reshape(len(want), -1)
    err = np.linalg.norm(got - want, axis=1)
    assert (err <= rtol * np.linalg.norm(want, axis=1)).all(), err / np.linalg.norm(want, axis=1)


# ---------------------------------------------------------------------------
# algebra/spin.py
# ---------------------------------------------------------------------------


def test_spin_operations_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 6))
    x[0, 1, 1:] = 0.0  # |x1| = 0: qhat is 0 there, no NaN
    y = rng.standard_normal((3, 4, 6))
    pos = _interior(rng, (3, 4, 6))
    pos[1, 2, 1:] = 0.0
    t = convert.tensor
    _close(tspin.eigenvalues(t(x)), jspin.eigenvalues(x))
    _close(tspin.det(t(x)), jspin.det(x))
    _close(tspin.norm_inf(t(x)), jspin.norm_inf(x))
    _close(tspin.quadratic_representation(t(x), t(y)), jspin.quadratic_representation(x, y))
    _close(tspin.exp(t(x)), jspin.exp(x))
    got = tspin.sqrt(t(pos))
    assert torch.isfinite(got).all()
    _close(got, jspin.sqrt(pos))
    # The square root squares back: Q(sqrt x) e = x.
    e = np.zeros(6)
    e[0] = 1.0
    _close(tspin.quadratic_representation(got, t(e)), pos, atol=1e-12)
    # Broadcasting over leading axes, as SOCCone.schur uses it.
    _close(
        tspin.quadratic_representation(t(pos)[:, :, None], t(y)[:, None]),
        jspin.quadratic_representation(pos[:, :, None], y[:, None]),
    )


# ---------------------------------------------------------------------------
# cones/soc.py
# ---------------------------------------------------------------------------


def _cone_inputs(seed=1, S=3, B=2, n=4, v=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((S, B, n + 1, v))
    c = _interior(rng, (S, B, n + 1))
    w = _interior(rng, (S, B, n + 1))
    y = 0.1 * rng.standard_normal((S, v))
    k = rng.uniform(0.5, 2.0, S)
    return A, c, w, y, k


def _vmapped(fn, *args):
    """A JAX SOCCone method vmapped over the scenario axis, as numpy."""
    return jax.tree.map(np.asarray, jax.vmap(fn)(*map(jnp.asarray, args)))


def test_soc_cone_properties_and_identity():
    A, c, _, _, _ = _cone_inputs()
    cone = convert.soc_cone(A, c)
    jcone = JSOC(A=jnp.asarray(A[0]), c=jnp.asarray(c[0]))
    assert (cone.scenarios, cone.batch, cone.num_vars, cone.rank()) == (3, 2, 3, 4)
    assert (cone.batch, cone.num_vars, cone.rank()) == (jcone.batch, jcone.num_vars, jcone.rank())
    assert cone.dual_scale == JSOC.dual_scale == 2.0
    assert cone.supports_line_search is JSOC.supports_line_search is False
    ident = cone.identity_state(torch.float64)
    assert ident.shape == (3, 2, 5)
    for s in range(3):
        np.testing.assert_array_equal(ident[s].numpy(), np.asarray(jcone.identity_state(jnp.float64)))
    w = torch.ones(3, 2, 5, dtype=torch.float64)
    assert cone.dual_variable(w) is w


def test_soc_cone_schur_and_minus_s_match_jax():
    A, c, w, y, k = _cone_inputs()
    cone = convert.soc_cone(A, c)
    got = cone.schur(convert.tensor(w))
    want = _vmapped(lambda A, c, w: JSOC(A=A, c=c).schur(w), A, c, w)
    for g, j in zip(got, want):
        _close(g, j)
    _close(
        cone._minus_s(convert.tensor(y), convert.tensor(k)),
        _vmapped(lambda A, c, y, k: JSOC(A=A, c=c)._minus_s(y, k), A, c, y, k),
    )


def test_soc_cone_steps_match_jax():
    A, c, w, y, k = _cone_inputs(seed=2)
    step = np.array([1.0, 0.5, 0.25])
    cone = convert.soc_cone(A, c)
    t = convert.tensor
    cache, norminf, normsq = cone.prepare_step(t(w), t(y), t(k), 1.0)
    jcache, jni, jns = _vmapped(
        lambda A, c, w, y, k: JSOC(A=A, c=c).prepare_step(w, y, k, 1.0), A, c, w, y, k
    )
    _close(cache.d, jcache.d)
    _close(cache.wsqrt, jcache.wsqrt)
    _close(norminf, jni)
    _close(normsq, jns)
    _close(
        cone.take_step(t(w), cache, t(step)),
        _vmapped(
            lambda A, c, w, d, ws, st: JSOC(A=A, c=c).take_step(w, type(jcache)(d, ws), st),
            A, c, w, jcache.d, jcache.wsqrt, step,
        ),
    )
    _close(
        cone.affine_step(t(w), t(y), 0.0),
        _vmapped(lambda A, c, w, y: JSOC(A=A, c=c).affine_step(w, y, 0.0), A, c, w, y),
    )
    got = cone.slack_stats(t(w), t(y), t(k))
    want = _vmapped(lambda A, c, w, y, k: JSOC(A=A, c=c).slack_stats(w, y, k), A, c, w, y, k)
    for g, j in zip(got, want):
        _close(g, j)


# ---------------------------------------------------------------------------
# The general solve path with SOC blocks
# ---------------------------------------------------------------------------


def _run_both(A, c, b, w0, scalars, **cfg):
    """(JAX result, port result) of solve_scenarios, both as numpy."""
    rj = jsolve(
        (JSOC(A=jnp.asarray(A), c=jnp.asarray(c)),), (), jnp.asarray(b),
        (jnp.asarray(w0),), {k: jnp.asarray(v) for k, v in scalars.items()},
        JConfig(**cfg),
    )
    rt = ct.solve_scenarios(
        (convert.soc_cone(A, c),), (), convert.tensor(b), (convert.tensor(w0),),
        convert.scalars(scalars), ct.SolverConfig(**cfg),
    )
    return jax.tree.map(np.asarray, rj), convert.to_numpy(rt)


def _assert_same_trajectory(rj, rt):
    np.testing.assert_array_equal(rt.num_iterations, rj.num_iterations)
    np.testing.assert_array_equal(rt.fail, rj.fail)
    np.testing.assert_array_equal(rt.solved, rj.solved)
    np.testing.assert_array_equal(rt.primal_infeasible, rj.primal_infeasible)
    np.testing.assert_array_equal(rt.dual_infeasible, rj.dual_infeasible)
    np.testing.assert_array_equal(rt.mu_stalled, rj.mu_stalled)
    np.testing.assert_allclose(rt.stats_k, rj.stats_k, rtol=1e-6)
    np.testing.assert_allclose(rt.stats_dinf, rj.stats_dinf, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(rt.k, rj.k, rtol=1e-6)
    _close_per_scenario(rt.y, rj.y, 1e-6)
    np.testing.assert_allclose(rt.b_scaling, rj.b_scaling, rtol=1e-12)
    np.testing.assert_allclose(rt.c_scaling, rj.c_scaling, rtol=1e-12)
    _close_per_scenario(rt.ws[0], rj.ws[0], 1e-5)


@pytest.mark.parametrize("nc", [1, 3])
def test_general_path_feasible_with_dual_recovery(nc):
    S, n, m = 5, 4, 3
    A, c, b = random_socp(np.random.default_rng(10 + nc), S, nc, n, m)
    rj, rt = _run_both(A, c, b, _identity(S, nc, n + 1), _cold_scalars(S),
                       max_iterations=30, prepare_dual_variables=True)
    assert rj.solved.all()
    _assert_same_trajectory(rj, rt)


def test_general_path_infeasible_matches_jax():
    """Random objectives: c is interior, so y = 0 is feasible, and a
    scenario whose objective is unbounded runs all 60 iterations unsolved
    with y growing to ~1e10."""
    S, nc, n, m = 6, 1, 4, 3
    A, c, b = random_socp(np.random.default_rng(3), S, nc, n, m, feasible=False)
    rj, rt = _run_both(A, c, b, _identity(S, nc, n + 1), _cold_scalars(S),
                       max_iterations=60)
    assert not rj.solved.all() and rj.solved.any()
    assert (rj.num_iterations[~rj.solved] == 60).all()
    _assert_same_trajectory(rj, rt)


def test_general_path_factor_failure_matches_jax():
    """Scenario 1 has an all-zero column of A: G is singular at iteration 0,
    the factorization fails and it stops there, while the others solve."""
    S, nc, n, m = 4, 2, 4, 3
    A, c, b = random_socp(np.random.default_rng(4), S, nc, n, m)
    A[1, :, :, 2] = 0.0
    rj, rt = _run_both(A, c, b, _identity(S, nc, n + 1), _cold_scalars(S),
                       max_iterations=30, prepare_dual_variables=True)
    assert rj.fail.tolist() == [False, True, False, False]
    assert int(rj.num_iterations[1]) == 0
    _assert_same_trajectory(rj, rt)
    np.testing.assert_array_equal(rt.ws[0][1], _identity(1, nc, n + 1)[0])


def test_general_path_warmstart_resume_and_abort():
    """Warmstart both packages from the JAX package's final state: scenario
    0 gets a 10% larger b and resumes; scenario 1 starts from a poisoned
    iterate (w0 = 1e6), its first step is too long (d_inf >= 2), the
    warmstart aborts and it restarts from the identity."""
    S, nc, n, m = 3, 2, 4, 3
    A, c, b = random_socp(np.random.default_rng(41), S, nc, n, m)
    cfg = dict(max_iterations=30)
    cold = jax.tree.map(np.asarray, jsolve(
        (JSOC(A=jnp.asarray(A), c=jnp.asarray(c)),), (), jnp.asarray(b),
        (jnp.asarray(_identity(S, nc, n + 1)),),
        {k: jnp.asarray(v) for k, v in _cold_scalars(S).items()}, JConfig(**cfg),
    ))
    w0 = cold.ws[0].copy()
    w0[1] = 0.0
    w0[1, :, 0] = 1e6
    scalars = dict(k=np.zeros(S), b_scaling=cold.b_scaling, c_scaling=cold.c_scaling)
    b2 = b.copy()
    b2[0] *= 1.1
    rj, rt = _run_both(A, c, b2, w0, scalars, initialization_mode=conex_tpu.WARMSTART,
                       **cfg)
    assert rj.stats_dinf[1, 0] >= 2.0  # the abort
    assert rj.num_iterations[0] < rj.num_iterations[1]
    assert rj.solved.all()
    _assert_same_trajectory(rj, rt)


def test_general_path_bench_socp_config_matches_jax():
    """benchmarks/bench_socp.py's configuration at a small size: every
    scenario runs exactly 14 iterations without failure."""
    S, n, m = 4, 20, 10
    A, c, b = random_socp(np.random.default_rng(19), S, 1, n, m)
    rj, rt = _run_both(
        A, c, b, _identity(S, 1, n + 1), _cold_scalars(S), max_iterations=14,
        final_centering_steps=0, inv_sqrt_mu_max=1e15, kkt_error_tolerance=1e45,
        fixed_iterations=True,
    )
    assert (rt.num_iterations == 14).all() and not rt.fail.any()
    _assert_same_trajectory(rj, rt)


# ---------------------------------------------------------------------------
# Program and loop.solve
# ---------------------------------------------------------------------------


def _unit_ball(m=4, seed=6):
    """maximize b'y s.t. (1, y) in Q^{m+1}, i.e. c = e0, A = [0; -I]: the
    answer is y = b/|b| and the dual x = (|b|, -b)."""
    b = np.random.default_rng(seed).standard_normal(m)
    A = np.vstack([np.zeros((1, m)), -np.eye(m)])
    c = np.zeros(m + 1)
    c[0] = 1.0
    return A, c, b


def test_program_soc_known_answer_matches_jax():
    A, c, b = _unit_ball()
    # The default mu target 1e-6: y sits on the central path along b/|b|
    # with 1 - |y| ~ mu.  (At 1e-8 the unscaled y moves by 4e-8 when b moves
    # by one rounding, in either package: the f64 floor of this problem.)
    cfg = dict(prepare_dual_variables=True, max_iterations=60)
    jp = conex_tpu.Program(4)
    jp.add_soc_constraint(A, c)
    jr = jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tp = ct.Program(4, device="cpu")
    assert tp.add_soc_constraint(A, c) == 0
    tr = tp.solve(b, ct.SolverConfig(**cfg))
    assert tr.solved and jr.solved
    assert tr.num_iterations == jr.num_iterations
    np.testing.assert_allclose(tr.y, b / np.linalg.norm(b), atol=1e-6)
    np.testing.assert_allclose(tr.y, jr.y, rtol=1e-8)
    np.testing.assert_allclose(tr.stats_inv_sqrt_mu, jr.stats_inv_sqrt_mu, rtol=1e-6)
    # The dual carries SOCCone.dual_scale = 2: A'x = b holds for it.
    x = tp.get_dual_variable(0)
    np.testing.assert_allclose(x, jp.get_dual_variable(0), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(A.T @ x, b, atol=1e-6)
    np.testing.assert_allclose(x, np.concatenate([[np.linalg.norm(b)], -b]), atol=1e-4)

    # Warmstart at the same objective resumes near the solution.
    wcfg = dict(cfg, initialization_mode=conex_tpu.WARMSTART)
    jr2 = jp.solve(b, conex_tpu.SolverConfig(**wcfg))
    tr2 = tp.solve(b, ct.SolverConfig(**wcfg))
    assert tr2.solved and tr2.num_iterations == jr2.num_iterations
    np.testing.assert_allclose(tr2.y, jr2.y, rtol=1e-8)


def test_program_soc_shape_errors():
    A, c, b = _unit_ball(m=3)
    p = ct.Program(3, device="cpu")
    with pytest.raises(ValueError, match="batch/cone dimensions must match"):
        p.add_soc_constraint(A, c[:-1])
    with pytest.raises(ValueError, match="batch/cone dimensions must match"):
        p.add_soc_constraint(np.stack([A, A]), c[None])
    with pytest.raises(ValueError, match="more variables"):
        ct.Program(2, device="cpu").add_soc_constraint(A, c)
    with pytest.raises(ValueError, match="duplicate"):
        p.add_soc_constraint(A, c, variables=[0, 0, 1])
    # A permuted subset is a sparse block (the supernodal KKT path).
    q = ct.Program(3, device="cpu")
    assert q.add_soc_constraint(A, c, variables=[2, 1, 0]) == 0
    assert q._blocks[0].vars_ == (2, 1, 0)
    # The dense subset named explicitly, and a batch of two cones, are taken.
    assert p.add_soc_constraint(A, c, variables=[0, 1, 2]) == 0
    assert p.add_soc_constraint(np.stack([A, A]), np.stack([c, 2 * c])) == 1
    assert p.solve(b, ct.SolverConfig(max_iterations=40)).solved


def test_loop_solve_one_soc_program_matches_solve_compiled():
    """loop.solve adds the scenario axis to every tensor field of the block
    (SOCCone has c, not C) and to a bare-tensor iterate."""
    S, nc, n, m = 1, 2, 4, 3
    A, c, b = random_socp(np.random.default_rng(9), S, nc, n, m)
    w0 = _identity(S, nc, n + 1)[0]
    sc = dict(k=0.0, b_scaling=1.0, c_scaling=1.0)
    cfg = dict(max_iterations=30, iterative_refinement_iterations=1)
    rj = jsolve_one(
        (JSOC(A=jnp.asarray(A[0]), c=jnp.asarray(c[0])),), (), jnp.asarray(b[0]),
        (jnp.asarray(w0),), {k: jnp.asarray(v) for k, v in sc.items()}, JConfig(**cfg),
    )
    blk = convert.soc_cone(A[0], c[0])
    rt = convert.to_numpy(tloop.solve(
        (blk,), (), convert.tensor(b[0]), (convert.tensor(w0),),
        {k: torch.tensor(v, dtype=torch.float64) for k, v in sc.items()},
        ct.SolverConfig(**cfg),
    ))
    assert int(rt.num_iterations) == int(rj.num_iterations)
    assert bool(rt.solved) and bool(rj.solved)
    np.testing.assert_allclose(rt.y, np.asarray(rj.y), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(rt.stats_k, np.asarray(rj.stats_k), rtol=1e-6)
    np.testing.assert_allclose(rt.ws[0], np.asarray(rj.ws[0]), rtol=1e-6, atol=1e-9)
    assert blk.A.shape == (nc, n + 1, m)  # the caller's block is untouched

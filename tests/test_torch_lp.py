"""The port's LP cone, line-search mu update and Program surface against
conex_tpu, in f64.

The same numpy inputs go through ``conex_tpu`` and ``conex_tpu_torch``
(``device="cpu"``).  Tolerances:

* a cone method: 1e-12 relative (the same elementwise formulas and two
  products, summed in other orders);
* a solve: iteration counts, ``solved`` and ``fail`` equal; ``stats_k`` and
  ``y`` at rtol 1e-8, the bar ``tests/test_lockstep.py`` holds the JAX
  package to against the reference (for LPs both evaluate the same
  closed-form arithmetic in f64, so only the order of sums differs).

The LP trajectory test is the port-side equivalent of
``test_lockstep.py::test_lp_trajectory_lockstep`` (same instance and
configuration), held to ``conex_tpu.Program`` since the reference binary
is absent here.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import conex_tpu
from conex_tpu.cones.lp import LinearCone as JLinear
from conex_tpu.parallel.sharded import solve_scenarios as jsolve

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.cones.lp import LinearCone

from test_lp import BASE, check_lp_kkt, random_feasible_lp


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _cone_batch(S=3, n=9, v=4, seed=0):
    """S scenarios of an LP block, a positive iterate and two KKT points."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (S, n, v))
    c = rng.uniform(0.5, 1.5, (S, n))
    w = rng.uniform(0.2, 2.0, (S, n))
    y0, y1 = rng.uniform(-0.3, 0.3, (2, S, v))
    return A, c, w, y0, y1


def _per_scenario(A, c, fn):
    """fn(JAX cone of scenario s, s) for each s, stacked along a new axis 0."""
    outs = [fn(JLinear(A=jnp.asarray(A[s]), c=jnp.asarray(c[s])), s)
            for s in range(A.shape[0])]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


def _assert_close(got, want, tol=1e-12):
    for g, r in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(r)
        assert _rel(g, r) <= tol, (g, r)


def test_linear_cone_methods_match_jax():
    A, c, w, y0, _ = _cone_batch()
    cone = convert.linear_cone(A, c)
    tw, ty = convert.tensor(w), convert.tensor(y0)
    cw = np.array([0.7, 1.3, 2.0])
    assert cone.rank() == JLinear(A=jnp.asarray(A[0]), c=jnp.asarray(c[0])).rank() == 9
    assert cone.supports_line_search is JLinear.supports_line_search is True
    _assert_close([cone.identity_state(torch.float64)],
                  [_per_scenario(A, c, lambda j, s: j.identity_state(jnp.float64))])
    _assert_close(cone.schur(tw), _per_scenario(A, c, lambda j, s: j.schur(jnp.asarray(w[s]))))
    cache, ninf, nsq = cone.prepare_step(tw, ty, convert.tensor(cw), 1.0)
    jcache, jninf, jnsq = _per_scenario(
        A, c, lambda j, s: j.prepare_step(jnp.asarray(w[s]), jnp.asarray(y0[s]), cw[s], 1.0))
    _assert_close([cache.d, ninf, nsq], [jcache.d, jninf, jnsq])
    step = np.array([0.25, 0.5, 1.0])
    _assert_close([cone.take_step(tw, cache, convert.tensor(step))], [_per_scenario(
        A, c, lambda j, s: j.take_step(jnp.asarray(w[s]), jax.tree.map(
            lambda x: x[s], jcache), step[s]))])
    _assert_close([cone.affine_step(tw, ty, 0.0)], [_per_scenario(
        A, c, lambda j, s: j.affine_step(jnp.asarray(w[s]), jnp.asarray(y0[s]), 0.0))])
    _assert_close(cone.slack_stats(tw, ty, convert.tensor(cw)), _per_scenario(
        A, c, lambda j, s: j.slack_stats(jnp.asarray(w[s]), jnp.asarray(y0[s]), cw[s])))
    _assert_close([cone.dual_variable(tw)], [w])


@pytest.mark.parametrize("dinf_max", [1.0, 1.35, 0.8, 0.2])
def test_linear_cone_line_search_matches_jax(dinf_max):
    """The admissible interval of every scenario, and its failure flag; a
    smaller dinf_max leaves some scenarios (0.8) or all (0.2) an empty
    interval."""
    A, c, w, y0, y1 = _cone_batch(S=6, seed=2)
    cone = convert.linear_cone(A, c)
    c1 = np.linspace(0.5, 2.0, 6)
    lo, up, fail = cone.line_search(convert.tensor(w), convert.tensor(y0),
                                    convert.tensor(y1), 0.0, convert.tensor(c1),
                                    dinf_max)
    jlo, jup, jfail = _per_scenario(A, c, lambda j, s: j.line_search(
        jnp.asarray(w[s]), jnp.asarray(y0[s]), jnp.asarray(y1[s]), 0.0, c1[s], dinf_max))
    np.testing.assert_array_equal(fail.numpy(), jfail)
    _assert_close([lo, up], [jlo, jup])
    assert jfail.sum() == {1.0: 0, 1.35: 0, 0.8: 1, 0.2: 6}[dinf_max]


def _lockstep_instance():
    """tests/test_lockstep.py:86-104."""
    rng = np.random.default_rng(3)
    n, m = 12, 5
    A = rng.uniform(-1, 1, (n, m))
    c = np.abs(rng.uniform(-1, 1, n)) + 0.2
    x0 = np.abs(rng.uniform(-1, 1, n))
    x0 *= 0.05 / np.linalg.norm(x0)
    return A, c, A.T @ x0


def _lockstep_config(line_search):
    return dict(max_iterations=20, enable_line_search=line_search,
                divergence_upper_bound=1.0, inv_sqrt_mu_max=1000.0,
                dinf_upper_bound=1.0 if not line_search else 1.35,
                final_centering_tolerance=0.01)


def _assert_same_solve(tr, jr):
    assert tr.num_iterations == jr.num_iterations
    assert tr.solved == jr.solved
    assert bool(tr._raw.fail) == bool(jr._raw.fail)
    np.testing.assert_allclose(tr.stats_inv_sqrt_mu, jr.stats_inv_sqrt_mu, rtol=1e-8)
    np.testing.assert_allclose(tr.y, jr.y, rtol=1e-8, atol=1e-12)


def _both_programs(m, build):
    jp, tp = conex_tpu.Program(m), ct.Program(m, device="cpu")
    build(jp)
    build(tp)
    return jp, tp


@pytest.mark.parametrize("line_search", [False, True])
def test_lp_trajectory_matches_jax(line_search):
    A, c, b = _lockstep_instance()
    cfg = _lockstep_config(line_search)
    jp, tp = _both_programs(5, lambda p: p.add_linear_constraint(A, c))
    jr = jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tr = tp.solve(b, ct.SolverConfig(**cfg))
    assert jr.solved
    _assert_same_solve(tr, jr)


@pytest.mark.parametrize("line_search", [False, True])
@pytest.mark.parametrize("rescaling", [False, True])
def test_lp_dense_grid_on_the_port(line_search, rescaling):
    """tests/test_lp.py::test_lp_dense_grid through the port, with the same
    KKT conditions."""
    config = ct.SolverConfig(**BASE, enable_line_search=line_search,
                             enable_rescaling=rescaling)
    rng = np.random.default_rng(1)
    for i in range(6):
        num_vars = 5
        A, c, b = random_feasible_lp(6 + 2 * i, num_vars, rng)
        prog = ct.Program(num_vars, device="cpu")
        prog.add_linear_constraint(A, c)
        res = prog.solve(b, config)
        assert res.solved, f"not solved: iters={res.num_iterations}"
        check_lp_kkt(A, c, b, res.y, prog.get_dual_variable(0), config.inv_sqrt_mu_max)


def _soc_block(m):
    """(1, y) in the Lorentz cone of dim m + 1."""
    return np.vstack([np.zeros((1, m)), -np.eye(m)]), np.eye(m + 1)[0]


def _lmi_block(m):
    """diag(y) <= I, as an LMI over m variables."""
    A = np.stack([np.diag(np.eye(m)[i]) for i in range(m)])
    return A, np.eye(m)


@pytest.mark.parametrize("other", ["soc", "lmi"])
def test_mixed_program_with_line_search_matches_jax(other):
    """A block without line search fails the mu update of every iteration
    (reference constraint.h:24-28), so k holds; the port follows JAX."""
    A, c, b = _lockstep_instance()
    m = A.shape[1]

    def build(p):
        p.add_linear_constraint(A, c)
        if other == "soc":
            p.add_soc_constraint(*_soc_block(m))
        else:
            p.add_lmi_constraint(*_lmi_block(m))

    cfg = dict(_lockstep_config(True), max_iterations=12)
    jp, tp = _both_programs(m, build)
    jr = jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tr = tp.solve(b, ct.SolverConfig(**cfg))
    _assert_same_solve(tr, jr)
    # The mu update failed every time: k stays at its first clamped value.
    k = tr.stats_inv_sqrt_mu
    assert len(set(k.tolist())) == 1


@pytest.mark.parametrize("line_search", [False, True])
def test_solve_scenarios_of_lps_matches_jax(line_search):
    rng = np.random.default_rng(4)
    S, n, m = 3, 10, 4
    A, c, b = map(np.stack, zip(*[random_feasible_lp(n, m, rng) for _ in range(S)]))
    scalars = dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))
    # The lockstep test's target (inv_sqrt_mu_max 1e3): at test_lp.py's
    # 5e5 the endgame's Schur complements are conditioned so that the two
    # packages' f64 rounding moves stats_k by up to 2.2e-7 relative.
    cfg = dict(_lockstep_config(line_search), prepare_dual_variables=True,
               max_iterations=40)
    rj = jsolve((JLinear(A=jnp.asarray(A), c=jnp.asarray(c)),), (), jnp.asarray(b),
                (jnp.ones((S, n)),), {k: jnp.asarray(v) for k, v in scalars.items()},
                conex_tpu.SolverConfig(**cfg))
    rt = ct.solve_scenarios((convert.linear_cone(A, c),), (), convert.tensor(b),
                            (torch.ones((S, n), dtype=torch.float64),),
                            convert.scalars(scalars), ct.SolverConfig(**cfg))
    rj, rt = jax.tree.map(np.asarray, rj), convert.to_numpy(rt)
    assert rj.solved.all()
    for name in ("num_iterations", "solved", "fail"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name))
    np.testing.assert_allclose(rt.stats_k, rj.stats_k, rtol=1e-8)
    np.testing.assert_allclose(rt.y, rj.y, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.ws[0], rj.ws[0], rtol=1e-8)


def _three_cone_program(p, m=3):
    """An LP, a SOC and an LMI block over the same m variables."""
    rng = np.random.default_rng(8)
    p.add_linear_constraint(rng.uniform(-1, 1, (6, m)), rng.uniform(1.0, 2.0, 6))
    p.add_soc_constraint(*_soc_block(m))
    A = rng.uniform(-1, 1, (m, 4, 4))
    p.add_lmi_constraint(0.5 * (A + np.swapaxes(A, 1, 2)), 2.0 * np.eye(4))


def test_updates_of_each_cone_then_a_solve_match_jax():
    m = 3
    jp, tp = _both_programs(m, _three_cone_program)
    held = [tuple(getattr(blk, f.name).clone() for f in dataclasses.fields(blk)
                  if isinstance(getattr(blk, f.name), torch.Tensor))
            for blk in tp._blocks]
    for p in (jp, tp):
        p.update_linear_operator(0, 0.3, variable=1, row=2)
        p.update_affine_term(0, 1.7, row=4)
        p.update_linear_operator(1, -0.8, variable=2, row=3)
        p.update_affine_term(1, 1.5, row=0)
        p.update_linear_operator(2, 0.25, variable=0, row=1, col=3)
        p.update_affine_term(2, 0.5, row=0, col=2)
    for jb, tb in zip(jp._blocks, tp._blocks):
        for f in dataclasses.fields(tb):
            x = getattr(tb, f.name)
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(x[0].numpy(), np.asarray(getattr(jb, f.name)))
    # The tensors a caller held before the updates are unchanged.
    for blk, before in zip(tp._blocks, held):
        after = tuple(getattr(blk, f.name) for f in dataclasses.fields(blk)
                      if isinstance(getattr(blk, f.name), torch.Tensor))
        assert any(not torch.equal(a, b) for a, b in zip(after, before))
    assert not torch.equal(tp._blocks[2].A[0, 0, 0, 1, 3], held[2][0][0, 0, 0, 1, 3])
    with pytest.raises(ValueError, match="real vector valued"):
        tp.update_linear_operator(0, 1.0, variable=0, row=0, col=1)
    b = np.array([0.3, -0.2, 0.4])
    cfg = dict(prepare_dual_variables=True, max_iterations=40)
    jr = jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tr = tp.solve(b, ct.SolverConfig(**cfg))
    assert jr.solved
    _assert_same_solve(tr, jr)


@pytest.mark.parametrize("line_search", [False, True])
def test_save_load_warmstart_matches_jax(line_search):
    A, c, b = _lockstep_instance()
    cfg = _lockstep_config(line_search)
    jp, tp = _both_programs(5, lambda p: p.add_linear_constraint(A, c))
    jp.solve(b, conex_tpu.SolverConfig(**cfg))
    tp.solve(b, ct.SolverConfig(**cfg))
    jstate, tstate = jp.save_state(), tp.save_state()
    assert isinstance(tstate["ws"][0], np.ndarray)
    np.testing.assert_allclose(tstate["ws"][0], jstate["ws"][0], rtol=1e-8)
    np.testing.assert_allclose(tstate["b_scaling"], jstate["b_scaling"], rtol=1e-12)
    np.testing.assert_allclose(tstate["c_scaling"], jstate["c_scaling"], rtol=1e-12)
    b2 = b * 1.01
    warm = dict(cfg, initialization_mode=conex_tpu.WARMSTART)
    # Each package resumes from its own state, and the port from JAX's too.
    jq, tq, tx = (conex_tpu.Program(5), ct.Program(5, device="cpu"),
                  ct.Program(5, device="cpu"))
    for p, state in ((jq, jstate), (tq, tstate), (tx, jstate)):
        p.add_linear_constraint(A, c)
        p.load_state(state)
    jr = jq.solve(b2, conex_tpu.SolverConfig(**warm))
    tr = tq.solve(b2, ct.SolverConfig(**warm))
    assert jr.solved and jr.num_iterations < 10
    _assert_same_solve(tr, jr)
    _assert_same_solve(tx.solve(b2, ct.SolverConfig(**warm)), jr)


def test_save_load_of_an_lmi_state_round_trips():
    """A DenseLMICone state (six PSDState fields) goes out as numpy and
    back to the same tensors."""
    tp = ct.Program(3, device="cpu")
    _three_cone_program(tp)
    with pytest.raises(RuntimeError, match="solve first"):
        tp.save_state()
    tp.solve(np.array([0.3, -0.2, 0.4]), ct.SolverConfig(max_iterations=5))
    ws = tp._ws
    state = tp.save_state()
    tp.load_state(state)
    for before, after in zip(ws, tp._ws):
        assert type(before) is type(after)
        for x, y in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_get_feasible_objective_matches_jax():
    jp, tp = _both_programs(3, _three_cone_program)
    got, want = tp.get_feasible_objective(), np.asarray(jp.get_feasible_objective())
    assert got.shape == want.shape == (3,)
    assert _rel(got, want) <= 1e-12


def test_report_gives_the_same_numbers_as_jax():
    A, c, b = _lockstep_instance()
    cfg = _lockstep_config(False)
    jp, tp = _both_programs(5, lambda p: p.add_linear_constraint(A, c))
    jrep = jp.solve(b, conex_tpu.SolverConfig(**cfg)).report().splitlines()
    trep = tp.solve(b, ct.SolverConfig(**cfg)).report().splitlines()
    assert trep[0] == jrep[0] and len(trep) == len(jrep) > 2
    for tl, jl in zip(trep[1:], jrep[1:]):
        t, j = np.array(tl.split(), float), np.array(jl.split(), float)
        # Three digits printed.  kkt_err, the last column, is a rounding
        # residual over s'x ~ mu rank: up to 3.1e-9 here in either package,
        # and not the same rounding in both.
        np.testing.assert_allclose(t[:-1], j[:-1], rtol=2e-2)
        assert max(t[-1], j[-1]) <= 1e-7


def test_add_linear_constraint_checks_like_jax():
    p = ct.Program(2, device="cpu")
    with pytest.raises(ValueError, match="A rows must match c length"):
        p.add_linear_constraint(np.ones((3, 2)), np.ones(2))
    with pytest.raises(ValueError, match="duplicate"):
        p.add_linear_constraint(np.ones((3, 2)), np.ones(3), variables=[0, 0])
    assert p.add_linear_constraint(np.ones((3, 2)), np.ones(3), variables=[0, 1]) == 0
    assert isinstance(p._blocks[0], LinearCone)
    assert p._blocks[0].A.shape == (1, 3, 2) and p._blocks[0].vars_ is None
    # A variable subset is a sparse block (the supernodal KKT path), as in JAX.
    jp = conex_tpu.Program(2)
    assert p.add_linear_constraint(np.ones((3, 1)), np.ones(3), variables=[1]) == 1
    jp.add_linear_constraint(np.ones((3, 1)), np.ones(3), variables=[1])
    assert p._blocks[1].vars_ == jp._blocks[0].vars_ == (1,)


def test_verify_known_answer_on_the_port():
    """The verify skill's canonical LP: maximize y1 + 2 y2 s.t. y1 <= 2,
    y2 <= 3, y1 + y2 <= 4, unique optimum (1, 3); then a warmstart resume
    after save_state / load_state."""
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    c = np.array([2.0, 3.0, 4.0])
    b = np.array([1.0, 2.0])
    cfg = dict(prepare_dual_variables=True, inv_sqrt_mu_max=1e4, max_iterations=50)
    prog = ct.Program(2, device="cpu")
    prog.add_linear_constraint(A, c)
    res = prog.solve(b, ct.SolverConfig(**cfg))
    assert res.solved and abs(b @ res.y - 7.0) < 1e-6
    np.testing.assert_allclose(res.y, [1.0, 3.0], atol=1e-6)
    x = prog.get_dual_variable(0)
    assert np.abs(A.T @ x - b).max() < 1e-6 and x.min() >= 0
    state = prog.save_state()
    again = ct.Program(2, device="cpu")
    again.add_linear_constraint(A, c)
    again.load_state(state)
    res2 = again.solve(b, ct.SolverConfig(**cfg, initialization_mode=ct.WARMSTART))
    assert res2.solved and res2.num_iterations <= 3


def test_chip_smoke_lp_measures_are_bench_accuracys():
    """chip_smoke.py keeps its own copy of bench_accuracy.py's gap_stats
    and its LP's drawing (the script imports nothing of benchmarks/)."""
    import importlib.util
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "jax_bench_accuracy", repo / "benchmarks" / "bench_accuracy.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    sys.path.insert(0, str(repo))
    import chip_smoke

    rng = np.random.default_rng(9)
    b, Ax = rng.standard_normal((2, 7))
    for by, cx in ((1.5, 1.5 + 3e-8), (-2.0, 4.0)):
        assert chip_smoke.gap_stats(by, cx, b, Ax) == bench.gap_stats(by, cx, b, Ax)
    A, b, c = chip_smoke.lp_instance(0)
    rng = np.random.default_rng(0)  # bench_accuracy.py:57-63
    A0 = rng.uniform(-1, 1, (400, 200))
    x0 = rng.uniform(0.5, 1.5, 400)
    np.testing.assert_array_equal(A, A0)
    np.testing.assert_array_equal(b, A0.T @ x0)
    np.testing.assert_array_equal(c, rng.uniform(0.5, 1.5, 400))
    cfg = chip_smoke.lp_config(True)
    assert (cfg.max_iterations, cfg.inv_sqrt_mu_max, cfg.prepare_dual_variables,
            cfg.enable_line_search) == (100, 1e4, True, True)

"""The port's batched dense-SDP solve against conex_tpu, end to end, in f64.

The same numpy problems go through ``conex_tpu.parallel.sharded.
solve_scenarios`` (vmap over scenarios) and ``conex_tpu_torch.
solve_scenarios`` (explicit scenario axis), and the per-iteration
trajectories are compared.  Tolerances: discrete outcomes (iteration
counts, fail, solved) must be equal.  The continuous ones carry the one
place where the two packages round differently on purpose-identical code:
the f32 eigenvector stages of the warm eigenvalue estimator (see
tests/test_torch_sym_mu.py), ~1e-9 relative per estimate, which the mu
update and the geodesic step carry along the trajectory.  Over up to 30
iterations that stays below 1e-6 relative on k and y and below 1e-5 on
the final iterate W; d_inf is a small difference of two estimates near
convergence, so it gets an absolute floor of 1e-7.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import conex_tpu
from conex_tpu.config import SolverConfig as JConfig
from conex_tpu.cones.psd import DenseLMICone as JCone, PSDState as JState
from conex_tpu.cones.psd import make_psd_state as jstate
from conex_tpu.parallel.sharded import solve_scenarios as jsolve
from conex_tpu.solver.loop import solve_compiled as jsolve_one

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.cones.psd import make_psd_state as tstate
from conex_tpu_torch.solver import loop as tloop

REPO = Path(__file__).resolve().parents[1]


def _sdp(rng, B, n, m):
    A = rng.uniform(-1, 1, (B, m, n, n))
    A = 0.5 * (A + np.swapaxes(A, 2, 3))
    C = np.broadcast_to(np.eye(n), (B, n, n)).copy()
    X0 = rng.uniform(-1, 1, (B, n, n))
    X0 = np.einsum("bij,bkj->bik", X0, X0) + 0.1 * np.eye(n)
    b = np.einsum("bvij,bij->v", A, X0)
    return A, C, b


def _batch(seed, S, B, n, m):
    rng = np.random.default_rng(seed)
    A, C, b = map(np.stack, zip(*[_sdp(rng, B, n, m) for _ in range(S)]))
    return A, C, b


def _identity_ws(S, B, n):
    return np.broadcast_to(np.eye(n), (S, B, n, n)).copy()


def _cold_scalars(S):
    return dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))


def _run_both(A, C, b, ws, scalars, **cfg):
    """(JAX result, port result), both as numpy.  ``ws``: the identity
    iterate (S, B, n, n), or the six PSDState fields as arrays."""
    if isinstance(ws, np.ndarray):
        jws, tws = jstate(jnp.asarray(ws)), tstate(convert.tensor(ws))
    else:
        jws, tws = JState(*map(jnp.asarray, ws)), convert.psd_state(ws)
    rj = jsolve(
        (JCone(A=jnp.asarray(A), C=jnp.asarray(C)),), (), jnp.asarray(b),
        (jws,), {k: jnp.asarray(v) for k, v in scalars.items()}, JConfig(**cfg),
    )
    rt = ct.solve_scenarios(
        (convert.lmi_cone(A, C),), (), convert.tensor(b), (tws,),
        convert.scalars(scalars), ct.SolverConfig(**cfg),
    )
    return jax.tree.map(np.asarray, rj), convert.to_numpy(rt)


def _assert_same_trajectory(rj, rt):
    np.testing.assert_array_equal(rt.num_iterations, rj.num_iterations)
    np.testing.assert_array_equal(rt.fail, rj.fail)
    np.testing.assert_array_equal(rt.solved, rj.solved)
    np.testing.assert_array_equal(rt.primal_infeasible, rj.primal_infeasible)
    np.testing.assert_array_equal(rt.dual_infeasible, rj.dual_infeasible)
    np.testing.assert_allclose(rt.stats_k, rj.stats_k, rtol=1e-6)
    np.testing.assert_allclose(rt.stats_dinf, rj.stats_dinf, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(rt.y, rj.y, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(rt.k, rj.k, rtol=1e-6)
    np.testing.assert_allclose(rt.b_scaling, rj.b_scaling, rtol=1e-12)
    np.testing.assert_allclose(rt.c_scaling, rj.c_scaling, rtol=1e-12)
    np.testing.assert_allclose(rt.ws[0].w, rj.ws[0].w, rtol=1e-5, atol=1e-6)


def test_default_config_batch_matches_jax():
    """Scenarios that finish at different iterations stay frozen once done."""
    S, B, n, m = 4, 2, 6, 3
    A, C, b = _batch(1, S, B, n, m)
    rj, rt = _run_both(A, C, b, _identity_ws(S, B, n), _cold_scalars(S),
                       max_iterations=30, prepare_dual_variables=True)
    assert len(set(rj.num_iterations.tolist())) > 1, rj.num_iterations
    assert rj.solved.all()
    _assert_same_trajectory(rj, rt)


def test_factor_failure_scenario_matches_jax():
    """Scenario 2 has an all-zero A_v: G is singular at iteration 0, its
    factorization fails and it stops there (no completed iteration is
    counted), while the others solve."""
    S, B, n, m = 4, 2, 6, 3
    A, C, b = _batch(1, S, B, n, m)
    A[2, :, 1] = 0.0
    rj, rt = _run_both(A, C, b, _identity_ws(S, B, n), _cold_scalars(S),
                       max_iterations=30, prepare_dual_variables=True)
    assert rj.fail.tolist() == [False, False, True, False]
    assert int(rj.num_iterations[2]) == 0
    _assert_same_trajectory(rj, rt)
    # The failed scenario keeps its loop iterate (no dual recovery).
    np.testing.assert_array_equal(rt.ws[0].w[2], _identity_ws(1, B, n)[0])


def test_warmstart_resolve_matches_jax():
    """Warmstart both packages from the JAX package's final state, carried
    across with convert.psd_state.  Scenario 0 gets a 10% larger b and
    resumes; scenario 1 gets 5 b, so its first step is too long
    (d_inf >= 2), the warmstart aborts and it restarts from the identity.

    (A warmstart that neither resumes nor aborts, far from the new optimum,
    is not held to trajectory parity: there the warm eigenvalue estimate
    at iteration 0 comes from seeds of another problem, moves by ~1e-4
    relative with the rounding of its f32 sweep alone, and decides which
    branch of the mu update a later iteration takes.)"""
    S, B, n, m = 4, 2, 6, 3
    A, C, b = _batch(1, S, B, n, m)
    cold = jsolve(
        (JCone(A=jnp.asarray(A), C=jnp.asarray(C)),), (), jnp.asarray(b),
        (jstate(jnp.asarray(_identity_ws(S, B, n))),),
        {k: jnp.asarray(v) for k, v in _cold_scalars(S).items()},
        JConfig(max_iterations=30, prepare_dual_variables=True),
    )
    ws = [np.asarray(x) for x in cold.ws[0]]
    scalars = dict(k=np.zeros(S), b_scaling=np.asarray(cold.b_scaling),
                   c_scaling=np.asarray(cold.c_scaling))
    b2 = b.copy()
    b2[0] *= 1.1
    b2[1] *= 5.0
    rj, rt = _run_both(A, C, b2, ws, scalars, max_iterations=30,
                       initialization_mode=conex_tpu.WARMSTART)
    assert rj.stats_dinf[1, 0] >= 2.0  # the abort
    assert rj.num_iterations[0] < rj.num_iterations[1]
    _assert_same_trajectory(rj, rt)


def test_bench_config_small_matches_jax():
    """bench.py's configuration at a small size: exactly 30 iterations in
    every scenario, scaled k capped at 100, no failures."""
    S, B, n, m = 4, 1, 8, 4
    A, C, b = _batch(2, S, B, n, m)
    rj, rt = _run_both(
        A, C, b, _identity_ws(S, B, n), _cold_scalars(S),
        max_iterations=30, final_centering_steps=0, inv_sqrt_mu_max=1e15,
        fixed_iterations=True, inv_sqrt_mu_cap_scaled=100.0,
    )
    assert (rt.num_iterations == 30).all() and not rt.fail.any()
    np.testing.assert_allclose(rt.k, 100.0)
    _assert_same_trajectory(rj, rt)


def test_one_program_solve_matches_solve_compiled():
    A, C, b = _batch(3, 1, 2, 7, 4)
    ws = _identity_ws(1, 2, 7)[0]
    sc = dict(k=0.0, b_scaling=1.0, c_scaling=1.0)
    cfg = dict(max_iterations=30, kkt_island_dtype="float64",
               iterative_refinement_iterations=1)
    rj = jsolve_one(
        (JCone(A=jnp.asarray(A[0]), C=jnp.asarray(C[0])),), (), jnp.asarray(b[0]),
        (jstate(jnp.asarray(ws)),), {k: jnp.asarray(v) for k, v in sc.items()},
        JConfig(**cfg),
    )
    rt = tloop.solve(
        (convert.lmi_cone(A[0], C[0]),), (), convert.tensor(b[0]),
        (tstate(convert.tensor(ws)),), {k: torch.tensor(v, dtype=torch.float64)
                                        for k, v in sc.items()},
        ct.SolverConfig(**cfg),
    )
    rt = convert.to_numpy(rt)
    assert int(rt.num_iterations) == int(rj.num_iterations)
    assert bool(rt.solved) and bool(rj.solved)
    np.testing.assert_allclose(rt.y, np.asarray(rj.y), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(rt.stats_k, np.asarray(rj.stats_k), rtol=1e-6)


def _lambda_min_sdp(n=5, seed=4):
    """maximize y s.t. C - y I PSD: the answer is lambda_min(C), and the
    dual variable is the projector onto its eigenvector (trace 1)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 3.0, n)
    C = Q @ np.diag(ev) @ Q.T
    C = 0.5 * (C + C.T)
    return np.eye(n)[None], C, ev[0]


def test_program_known_answer_matches_jax():
    A, C, answer = _lambda_min_sdp()
    cfg = dict(prepare_dual_variables=True, inv_sqrt_mu_max=1e4, max_iterations=60)
    jp = conex_tpu.Program(1)
    jp.add_lmi_constraint(A, C)
    jr = jp.solve(np.ones(1), conex_tpu.SolverConfig(**cfg))
    tp = ct.Program(1, device="cpu")
    tp.add_lmi_constraint(A, C)
    tr = tp.solve(np.ones(1), ct.SolverConfig(**cfg))
    assert tr.solved and jr.solved
    assert tr.num_iterations == jr.num_iterations
    np.testing.assert_allclose(tr.y, answer, atol=1e-6)
    np.testing.assert_allclose(tr.y, jr.y, rtol=1e-8)
    np.testing.assert_allclose(tr.stats_inv_sqrt_mu, jr.stats_inv_sqrt_mu, rtol=1e-6)
    X = tp.get_dual_variable(0)
    np.testing.assert_allclose(X, jp.get_dual_variable(0), atol=1e-6)
    np.testing.assert_allclose(np.trace(X), 1.0, atol=1e-6)

    # Warmstart at the same objective resumes near the solution.
    wcfg = dict(cfg, initialization_mode=conex_tpu.WARMSTART)
    jr2 = jp.solve(np.ones(1), conex_tpu.SolverConfig(**wcfg))
    tr2 = tp.solve(np.ones(1), ct.SolverConfig(**wcfg))
    assert tr2.solved and tr2.num_iterations == jr2.num_iterations
    np.testing.assert_allclose(tr2.y, jr2.y, rtol=1e-8)


def test_program_rejects_what_is_not_ported():
    A, C, _ = _lambda_min_sdp(n=3)
    p = ct.Program(2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        p.add_lmi_constraint(A, C, variables=[1])
    with pytest.raises(ValueError, match="symmetric"):
        p.add_lmi_constraint(A + np.triu(np.ones((3, 3)), 1)[None], C)
    with pytest.raises(ValueError, match="empty program"):
        p.solve(np.ones(2))
    p.add_lmi_constraint(A, C)
    with pytest.raises(ValueError, match="dimension"):
        p.solve(np.ones(3))


def test_program_runs_on_the_card_unless_asked_for_the_cpu():
    assert ct.Program(1).device.type == "cuda"
    assert ct.Program(1, device="cpu").device.type == "cpu"


def test_unsupported_options_raise_naming_roadmap_items():
    A, C, b = _batch(5, 1, 1, 3, 2)
    args = ((convert.lmi_cone(A, C),), (), convert.tensor(b),
            (tstate(convert.tensor(_identity_ws(1, 1, 3))),),
            convert.scalars(_cold_scalars(1)))
    with pytest.raises(NotImplementedError, match="item 14"):
        ct.solve_scenarios(*args, ct.SolverConfig(), mesh=object())
    # The line-search mu update is ported: on an LMI block, which has no
    # line search, it fails every mu update, as in the JAX package.
    rj, rt = _run_both(A, C, b, _identity_ws(1, 1, 3), _cold_scalars(1),
                       enable_line_search=True, max_iterations=6)
    _assert_same_trajectory(rj, rt)
    with pytest.raises(NotImplementedError, match="item 10"):
        ct.solve_scenarios(*args, ct.SolverConfig(kkt_solver=ct.KKT_SOLVER_LDLT))
    with pytest.raises(ValueError, match="schur_precision"):
        ct.solve_scenarios(*args, ct.SolverConfig(schur_precision="bf16"))
    # Every precision mode name of the JAX package is accepted.
    res = ct.solve_scenarios(*args, ct.SolverConfig(schur_precision="ozaki",
                                                    max_iterations=2))
    assert res.y.shape == (1, 2)


def test_solve_scenarios_takes_the_jax_axis_keyword():
    A, C, b = _batch(5, 2, 1, 3, 2)
    args = ((convert.lmi_cone(A, C),), (), convert.tensor(b),
            (tstate(convert.tensor(_identity_ws(2, 1, 3))),),
            convert.scalars(_cold_scalars(2)))
    cfg = ct.SolverConfig(max_iterations=5)
    plain = convert.to_numpy(ct.solve_scenarios(*args, cfg))
    named = convert.to_numpy(ct.solve_scenarios(*args, cfg, axis="dp"))
    np.testing.assert_array_equal(named.y, plain.y)
    np.testing.assert_array_equal(named.stats_k, plain.stats_k)
    with pytest.raises(NotImplementedError, match="item 14"):
        ct.solve_scenarios(*args, cfg, mesh=object(), axis="dp")


@pytest.mark.parametrize("exit_by", ["return", "exception"])
def test_no_tf32_restores_the_callers_flags(monkeypatch, exit_by):
    """A CUDA solve turns TF32 off inside and gives both flags back."""
    backends = torch.backends
    for flag in (backends.cuda.matmul, backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", True)
    try:
        with tloop._no_tf32():
            assert not backends.cuda.matmul.allow_tf32
            assert not backends.cudnn.allow_tf32
            if exit_by == "exception":
                raise KeyError("inside the solve")
    except KeyError:
        assert exit_by == "exception"
    assert backends.cuda.matmul.allow_tf32 and backends.cudnn.allow_tf32


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "conex_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "conex_tpu"), (path, name)
    code = (
        "import sys, conex_tpu_torch, conex_tpu_torch.convert, "
        "conex_tpu_torch._build; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'conex_tpu')]; assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA card: chip_smoke.py exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok": true' not in proc.stdout

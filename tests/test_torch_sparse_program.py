"""The port's Program on sparse variable subsets (the supernodal KKT path)
against conex_tpu.Program, end to end, in f64 on the CPU.

The models are tests/test_compressed.py's two chain LPs (above the clique
threshold: the compressed structure; the second with equality rows: the
LDLT), a short chain of benchmarks/bench_sparse.py's LMI cliques (the
unrolled structure), the same chain on both structures, and a quadratic
cost epigraph placed elsewhere than x = y[0:nv], t = y[nv].  Tolerances
are those of tests/test_torch_equality_qp.py, whose assertions these
tests use:

* the trajectory: ``fail`` and ``solved`` equal, ``stats_k`` and
  ``stats_dinf`` at rtol 1e-8 while the scaled k stays at or below 1e3,
  and where the run does, ``num_iterations`` equal and ``y`` and
  ``y_kkt`` at rtol 1e-8: the same f64 arithmetic, the sums in other
  orders (per-clique factors included, tests/test_torch_supernodal.py);
* an LMI block carries the f32 eigenvector sweep, which rounds otherwise
  in XLA and PyTorch (tests/test_torch_solve.py): 1e-6;
* a clamped LDLT pivot (recorded by the ``clamps`` fixture) holds only
  the outcome;
* the JAX tests' own bounds: the sparse solve against the dense one to
  1e-6 (tests/test_compressed.py), the epigraph's y to 1e-4 of the
  direct solution (tests/test_quadratic_cone.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import conex_tpu
from conex_tpu import program as jprogram

import conex_tpu_torch as ct
from conex_tpu_torch import program as tprogram
from conex_tpu_torch.supernodal import compressed as tc
from conex_tpu_torch.supernodal import solver as tsolver

from test_torch_equality_qp import (  # noqa: F401  (clamps is a fixture)
    _assert_same_outcome, _assert_same_trajectory, _both, _epigraph_instance,
    _solve, clamps)


def _chain_lp(seed, n_blocks, with_equality):
    """tests/test_compressed.py's chain LP: 3 rows per block over
    variables (i, i + 1), as a sparse program in both packages and a
    dense one in the port; and its b."""
    rng = np.random.default_rng(seed)
    num_vars, rows = n_blocks + 1, 3
    Af = np.zeros((rows * n_blocks, num_vars))
    cf = np.zeros(rows * n_blocks)
    parts = []
    for i in range(n_blocks):
        Ai = rng.uniform(-1, 1, (rows, 2))
        ci = np.abs(rng.uniform(-1, 1, rows)) + 0.1
        parts.append((Ai, ci, [i, i + 1]))
        Af[rows * i:rows * (i + 1), i:i + 2] = Ai
        cf[rows * i:rows * (i + 1)] = ci
    Aeq = rng.uniform(-1, 1, (2, 3)) if with_equality else None
    x0 = np.abs(rng.uniform(-1, 1, rows * n_blocks))
    x0 *= 0.1 / np.linalg.norm(x0)
    b = Af.T @ x0

    def sparse(p):
        for Ai, ci, v in parts:
            p.add_linear_constraint(Ai, ci, variables=v)
        if with_equality:
            p.add_equality_constraint(Aeq, Aeq @ b[:3], variables=[0, 1, 2])

    jp, tp = _both(num_vars, sparse)
    dense = ct.Program(num_vars, device="cpu")
    dense.add_linear_constraint(Af, cf)
    if with_equality:
        dense.add_equality_constraint(Aeq, Aeq @ b[:3], variables=[0, 1, 2])
    return jp, tp, dense, b


@pytest.mark.parametrize("seed,extra,with_equality", [(6, 8, False), (7, 4, True)])
def test_chain_lp_on_the_compressed_structure_matches_jax(seed, extra, with_equality,
                                                          clamps):
    """test_program_end_to_end_compressed_vs_dense and
    test_program_compressed_with_equality: above the threshold both
    packages pick the same compressed structure; the port's trajectory
    holds JAX's, and its y the dense program's."""
    n_blocks = tprogram.SCAN_CLIQUE_THRESHOLD + extra
    assert tprogram.SCAN_CLIQUE_THRESHOLD == jprogram.SCAN_CLIQUE_THRESHOLD == 24
    jp, tp, dense, b = _chain_lp(seed, n_blocks, with_equality)
    ts, js = tp._kkt_structure(), jp._kkt_structure()
    assert isinstance(ts, tc.CompressedSupernodalStructure)
    assert type(js).__name__ == "CompressedSupernodalStructure" and ts == tuple(js)
    jr, tr = _solve(jp, tp, b)
    assert bool(clamps) == with_equality  # the LDLT ran only with equality rows
    if any(clamps):
        _assert_same_outcome(tr, jr)
    else:
        _assert_same_trajectory(tr, jr)
    rd = dense.solve(b)
    assert jr.solved and tr.solved and rd.solved
    np.testing.assert_allclose(rd.y, tr.y, atol=1e-6)


def chain_program(N, nc, rng):
    """benchmarks/bench_sparse.py's chain_program at one instance, f64: N
    LMI cliques of order nc, clique i over the 6-variable window from 3i;
    (A (N, 1, 6, nc, nc), b, number of variables)."""
    w = 6
    n_vars = 3 * N + w - 3
    A = rng.uniform(-1, 1, (N, 1, w, nc, nc))
    A = 0.5 * (A + np.swapaxes(A, 3, 4))
    X0 = rng.uniform(-1, 1, (N, 1, nc, nc))
    X0 = np.einsum("sbij,sbkj->sbik", X0, X0) / nc + 0.1 * np.eye(nc)
    b = np.zeros(n_vars)
    for i in range(N):
        b[3 * i:3 * i + w] += np.einsum("bvij,bij->v", A[i], X0[i])
    return A, b, n_vars


CHAIN_CONFIG = dict(max_iterations=30, final_centering_steps=0,
                    inv_sqrt_mu_max=1e15, fixed_iterations=True,
                    inv_sqrt_mu_cap_scaled=100.0)


def _lmi_chain(N=4, nc=4, seed=0):
    A, b, n_vars = chain_program(N, nc, np.random.default_rng(seed))
    eye = np.eye(nc)[None]

    def build(p):
        for i in range(N):
            p.add_lmi_constraint(A[i], eye, variables=list(range(3 * i, 3 * i + 6)))

    return build, b, n_vars


def test_lmi_chain_on_the_unrolled_structure_matches_jax():
    """bench_sparse's chain (4 cliques of order 4) under its fixed 30
    iterations: both packages pick the unrolled structure, and the port
    holds JAX's trajectory to the LMI bar."""
    build, b, n_vars = _lmi_chain()
    jp, tp = _both(n_vars, build)
    ts = tp._kkt_structure()
    assert type(ts) is tsolver.SupernodalStructure
    assert type(jp._kkt_structure()).__name__ == "SupernodalStructure"
    assert ts == tuple(jp._kkt_structure())
    jr, tr = _solve(jp, tp, b, **CHAIN_CONFIG)
    assert tr.num_iterations == jr.num_iterations == 30
    _assert_same_trajectory(tr, jr, rtol=1e-6)


def test_threshold_switch_gives_the_same_y(monkeypatch):
    """The same chain on both structures: SCAN_CLIQUE_THRESHOLD is read at
    each solve (benchmarks/bench_sparse.py sets it on the module), picks
    the structure as in JAX, and the compressed solve gives the unrolled
    one's trajectory and y to rounding (1e-10)."""
    build, b, n_vars = _lmi_chain()
    tp = ct.Program(n_vars, device="cpu")
    build(tp)
    cfg = ct.SolverConfig(**CHAIN_CONFIG)
    unrolled = tp.solve(b, cfg)
    monkeypatch.setattr(tprogram, "SCAN_CLIQUE_THRESHOLD", 0)
    monkeypatch.setattr(jprogram, "SCAN_CLIQUE_THRESHOLD", 0)
    jp = conex_tpu.Program(n_vars)
    build(jp)
    ts = tp._kkt_structure()
    assert isinstance(ts, tc.CompressedSupernodalStructure)
    assert type(jp._kkt_structure()).__name__ == "CompressedSupernodalStructure"
    compressed = tp.solve(b, cfg)
    assert compressed.num_iterations == unrolled.num_iterations == 30
    np.testing.assert_allclose(compressed.stats_inv_sqrt_mu, unrolled.stats_inv_sqrt_mu,
                               rtol=1e-10)
    np.testing.assert_allclose(compressed.y, unrolled.y, rtol=1e-10)


@pytest.mark.parametrize("xs,t", [([1, 2, 3], 0), ([1, 0, 2], 3)],
                         ids=["t_first", "x_permuted"])
def test_epigraph_placed_elsewhere_matches_jax(xs, t):
    """tests/test_torch_equality_qp.py's epigraph QP with x and t placed
    elsewhere than x = y[0:nv], t = y[nv]: a sparse subset in both
    packages (the unrolled structure), solved to the direct optimum."""
    nv, Qi, bvec = _epigraph_instance()
    A_box = np.zeros((2 * nv, nv + 1))
    A_box[:, xs] = np.vstack([np.eye(nv), -np.eye(nv)])
    b = np.zeros(nv + 1)
    b[xs], b[t] = bvec, -1.0

    def build(p):
        p.add_quadratic_cost_epigraph(Qi, xs, t)
        p.add_linear_constraint(A_box, np.full(2 * nv, 10.0))

    jp, tp = _both(nv + 1, build)
    assert tp._blocks[0].vars_ == jp._blocks[0].vars_ == tuple(xs) + (t,)
    assert type(tp._kkt_structure()) is tsolver.SupernodalStructure
    jr, tr = _solve(jp, tp, b, max_iterations=60, inv_sqrt_mu_max=1e5)
    _assert_same_trajectory(tr, jr)
    assert tr.solved
    x = np.linalg.solve(Qi, bvec)
    np.testing.assert_allclose(tr.y[xs], x, atol=1e-4)
    assert tr.y[t] == pytest.approx(0.5 * x @ Qi @ x, abs=1e-4)

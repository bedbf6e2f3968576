"""A LinearCone's bound rows (rows with at most one nonzero in every
scenario) held as a diagonal, cones/lp.py's ``split_bound_rows``, against
the dense products of the same cone, in f64 on the CPU.

Every method of the split cone agrees with the dense cone at relative
1e-14 (the largest difference over the largest entry); where every row is
bound the Schur block comes as its diagonal and the dense G holds exact
zeros off it.  A cone without bound rows is not split and gives the dense
formulas' tensors to the bit.  Also: the scenario axis of a split cone
slices like any block's, the assembly takes a diagonal onto ``vars_`` and
onto the compressed supernodal buffer, the split is counted once per
solve, a NaN iterate still fails its scenario, and a k = 2, n = 200
portfolio batch solves as on the dense path and as in the JAX package."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from conex_tpu.cones.equality import EqualityBlock as JEq
from conex_tpu.cones.lp import LinearCone as JLinear
from conex_tpu.cones.qcost import QuadraticCost as JCost

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.cones.base import tree_map
from conex_tpu_torch.cones.lp import LinearCone
from conex_tpu_torch.solver import loop
from conex_tpu_torch.supernodal.compressed import CompressedSupernodalStructure
from conex_tpu_torch.utils.profiling import counters

from portbench import spec
from test_torch_equality_qp import _assert_same_batch, _batch_result

F64 = torch.float64
RTOL = 1e-14


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _box(S, n, k, seed, unit=False):
    """The portfolio's box rows [I 0; -I 0] over n + k variables, with
    random nonzero coefficients unless ``unit``."""
    g = _gen(seed)
    A = torch.zeros((S, 2 * n, n + k), dtype=F64)
    idx = torch.arange(n)
    top = torch.ones((S, n), dtype=F64) if unit else 0.5 + torch.rand((S, n), generator=g, dtype=F64)
    low = -torch.ones((S, n), dtype=F64) if unit else -0.5 - torch.rand((S, n), generator=g, dtype=F64)
    A[:, idx, idx] = top
    A[:, n + idx, idx] = low
    c = torch.cat([torch.ones((S, n), dtype=F64), torch.zeros((S, n), dtype=F64)], dim=1)
    return A, c


def _stacked(S, v, seed):
    """Three bound rows on column 0, one on column 2, none on columns 1 and
    3 (empty columns), a row of zeros, and a row whose column differs
    between scenarios."""
    g = _gen(seed)
    A = torch.zeros((S, 6, v), dtype=F64)
    coef = 0.5 + torch.rand((S, 6), generator=g, dtype=F64)
    A[:, 0, 0], A[:, 1, 0], A[:, 2, 0] = coef[:, 0], -coef[:, 1], coef[:, 2]
    A[:, 3, 2] = coef[:, 3]
    for s in range(S):
        A[s, 5, (s * 3) % v] = -coef[s, 5]
    c = 1.0 + torch.rand((S, 6), generator=g, dtype=F64)
    return A, c


def _permuted(S, n, v, seed):
    """n bound rows whose columns are a different draw in every scenario."""
    g = _gen(seed)
    A = torch.zeros((S, n, v), dtype=F64)
    for s in range(S):
        cols = torch.randint(0, v, (n,), generator=g)
        A[s, torch.arange(n), cols] = torch.randn((n,), generator=g, dtype=F64)
    return A, 1.0 + torch.rand((S, n), generator=g, dtype=F64)


def _mixed(S, v, seed):
    """Dense rows interleaved with bound rows, one of them bound in one
    scenario only (so general)."""
    g = _gen(seed)
    dense = torch.randn((S, 4, v), generator=g, dtype=F64)
    Ab, _ = _permuted(S, 5, v, seed + 1)
    A = torch.cat([Ab[:, :2], dense[:, :2], Ab[:, 2:], dense[:, 2:]], dim=1)
    A[1:, 0] = 0.0
    A[1:, 0, :2] = 1.0  # row 0: one nonzero in scenario 0, two in the others
    return A, 1.0 + torch.rand((S, A.shape[1]), generator=g, dtype=F64)


CASES = {
    "box": lambda: _box(3, 7, 2, 0),
    "box_unit": lambda: _box(3, 7, 2, 1, unit=True),
    "stacked": lambda: _stacked(3, 5, 2),
    "permuted": lambda: _permuted(3, 12, 5, 3),
    "mixed": lambda: _mixed(3, 6, 4),
}


def _inputs(cone, seed):
    S, n, v = cone.scenarios, cone.n, cone.num_vars
    g = _gen(seed)
    w = 0.2 + torch.rand((S, n), generator=g, dtype=F64)
    y0, y1 = (torch.randn((S, v), generator=g, dtype=F64) for _ in range(2))
    k = 0.5 + torch.rand((S,), generator=g, dtype=F64)
    return w, y0, y1, k


def _outputs(cone, w, y0, y1, k):
    """Every method's tensors, G made dense (a diagonal on its diagonal)."""
    out = cone.schur(w)
    G = torch.diag_embed(out.G) if out.G.dim() == 2 else out.G
    res = dict(G=G, AW=out.AW, AQc=out.AQc, w_dot_c=out.w_dot_c, c_dot_Qc=out.c_dot_Qc)
    cache, ninf, nsq = cone.prepare_step(w, y0, k, 1.0)
    res.update(d=cache.d, norminf=ninf, normsq=nsq,
               take=cone.take_step(w, cache, 0.5 / ninf ** 2),
               affine=cone.affine_step(w, y0, 0.3))
    res.update({f"slack_{n}": x for n, x in cone.slack_stats(w, y0, k)._asdict().items()})
    lo, up, fail = cone.line_search(w, y0, y1, 0.0, k, 1.5)
    res.update(lower=lo, upper=up, fail=fail, dual=cone.dual_variable(w))
    return res


def _assert_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if b.dtype == torch.bool:
            assert torch.equal(a, b), name
            continue
        scale = b.abs().max().clamp(min=1e-300)
        assert float((a - b).abs().max()) <= RTOL * float(scale), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_method_of_the_split_cone_matches_the_dense_cone(case):
    A, c = CASES[case]()
    dense = LinearCone(A=A, c=c)
    split = dense.split_bound_rows()
    assert split is not dense and split.bound_cols is not None
    assert split.n == dense.n and split.rank() == dense.rank()
    assert split.num_vars == dense.num_vars
    args = _inputs(dense, 7)
    got, want = _outputs(split, *args), _outputs(dense, *args)
    _assert_close(got, want)
    assert torch.equal(got["dual"], want["dual"])
    if case != "mixed":
        # Every row bound: the block hands over G's diagonal, and the
        # dense G holds exact zeros off it.
        assert split.schur(args[0]).G.dim() == 2
        off = want["G"] - torch.diag_embed(torch.diagonal(want["G"], dim1=1, dim2=2))
        assert torch.equal(off, torch.zeros_like(off))


def test_the_mixed_cone_keeps_its_general_rows_dense():
    A, c = _mixed(3, 6, 4)
    split = LinearCone(A=A, c=c).split_bound_rows()
    # Rows 1, 4, 5, 6 are bound; 0 (two nonzeros in two scenarios), 2, 3,
    # 7 and 8 are general.
    assert split.A.shape == (3, 5, 6)
    assert split.general_rows[0].tolist() == [0, 2, 3, 7, 8]
    assert split.bound_rows[0].tolist() == [1, 4, 5, 6]
    assert torch.equal(split.A, A[:, [0, 2, 3, 7, 8]])
    assert split.schur(torch.ones_like(c)).G.dim() == 3
    # A row of one nonzero that is not finite stays general, as the dense
    # product spreads it.
    A[2, 4] = 0.0
    A[2, 4, 1] = float("inf")
    assert LinearCone(A=A, c=c).split_bound_rows().general_rows[0].tolist() == [0, 2, 3, 4, 7, 8]


@pytest.mark.parametrize("unit", [False, True], ids=["random", "unit"])
def test_box_rows_keep_the_dense_bits_of_minus_s_and_the_sums(unit):
    """minus_s is one rounding in both; AW and AQc of the box rows add two
    exact values (unit coefficients), so they match the dense bits."""
    A, c = _box(4, 9, 3, 5, unit=unit)
    dense = LinearCone(A=A, c=c)
    split = dense.split_bound_rows()
    w, y0, _, k = _inputs(dense, 11)
    assert torch.equal(split._minus_s(y0, k), dense._minus_s(y0, k))
    if unit:
        s, d = split.schur(w), dense.schur(w)
        assert torch.equal(s.AW, d.AW) and torch.equal(s.AQc, d.AQc)
        assert torch.equal(s.w_dot_c, d.w_dot_c) and torch.equal(s.c_dot_Qc, d.c_dot_Qc)


def _parent_outputs(cone, w, y0, y1, k):
    """The dense formulas as the cone ran them before bound rows were held
    apart."""
    A, c = cone.A, cone.c
    WA, WC = w[..., None] * A, w * c
    WAt = WA.transpose(1, 2)
    minus = lambda y, kk: (A @ y[..., None])[..., 0] - kk[:, None] * c
    d = w * minus(y0, k) + 1.0
    return dict(G=WAt @ WA, AW=(A.transpose(1, 2) @ w[..., None])[..., 0],
                AQc=(WAt @ WC[..., None])[..., 0], w_dot_c=WC.sum(1),
                c_dot_Qc=(WC * WC).sum(1), d=d)


@pytest.mark.parametrize("shape", [(3, 8, 5), (2, 0, 4), (2, 3, 0)],
                         ids=["dense", "zero_rows", "zero_vars"])
def test_a_cone_without_bound_rows_is_not_split_and_keeps_its_bits(shape):
    S, n, v = shape
    g = _gen(3)
    A = torch.randn(shape, generator=g, dtype=F64)
    c = 1.0 + torch.rand((S, n), generator=g, dtype=F64)
    cone = LinearCone(A=A, c=c)
    before = counters.copy()
    assert cone.split_bound_rows() is cone
    assert counters["lp.rows"] - before["lp.rows"] == n
    assert counters["lp.bound_rows"] == before["lp.bound_rows"]
    assert counters["sync.cone.lp_split"] - before["sync.cone.lp_split"] == (n > 0 and v > 0)
    w, y0, y1, k = _inputs(cone, 4)
    out = cone.schur(w)
    got = dict(G=out.G, AW=out.AW, AQc=out.AQc, w_dot_c=out.w_dot_c,
               c_dot_Qc=out.c_dot_Qc, d=w * cone._minus_s(y0, k) + 1.0)
    want = _parent_outputs(cone, w, y0, y1, k)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_a_split_cone_slices_along_its_scenario_axis():
    A, c = _mixed(4, 6, 8)
    split = LinearCone(A=A, c=c).split_bound_rows()
    pick = torch.tensor([2, 0])
    cut = tree_map(lambda x: x[pick], split)
    assert cut.bound_rows.shape[0] == cut.general_rows.shape[0] == 2
    w, y0, y1, k = _inputs(split, 9)
    whole = _outputs(split, w, y0, y1, k)
    part = _outputs(cut, w[pick], y0[pick], y1[pick], k[pick])
    for name, x in part.items():
        assert torch.equal(x, whole[name][pick]), name
    # And the all-bound cone of the portfolio's sample.
    A, c = _box(4, 5, 2, 9)
    split = LinearCone(A=A, c=c).split_bound_rows()
    w, y0, y1, k = _inputs(split, 10)
    part = _outputs(tree_map(lambda x: x[pick], split), w[pick], y0[pick], y1[pick], k[pick])
    whole = _outputs(split, w, y0, y1, k)
    for name, x in part.items():
        assert torch.equal(x, whole[name][pick]), name


def _assembled(blocks, ws, n_kkt, structure=None):
    return loop.assemble(tuple(blocks), (), tuple(ws), n_kkt, n_kkt, F64, structure)


@pytest.mark.parametrize("case", ["box", "mixed"])
def test_the_assembly_takes_a_split_cone_onto_vars_and_the_compressed_buffer(case):
    """The cone over variables (4, 1, 6, 3, 0, 7) of 8 (vars_), and over
    a chain of cliques in the compressed supernodal buffer: the same
    matrices and vectors as its dense cone's."""
    A, c = _box(2, 6, 0, 12) if case == "box" else _mixed(2, 6, 12)
    vars_ = (4, 1, 6, 3, 0, 7)
    dense = LinearCone(A=A, c=c, vars_=vars_)
    split = dense.split_bound_rows()
    w = 0.2 + torch.rand(c.shape, generator=_gen(13), dtype=F64)
    structure = CompressedSupernodalStructure.from_cliques(
        [[0, 1, 3, 4, 6, 7], [1, 2, 5]], 8)
    for st in (None, structure):
        got, want = _assembled([split], [w], 8, st), _assembled([dense], [w], 8, st)
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= RTOL * scale


def _portfolio_batch(S, k, n, chunk=0):
    problem = spec.load_problem("osqp_portfolio")
    config = dict(spec.load_config("osqp_portfolio_k10"), k=k, n=n)
    data = problem.make(config, 0, chunk, S, F64, "cpu")
    return config, [t.numpy() for t in problem.port_data(data)]


def _solve(Q, A, c, Aeq, beq, b, solver, ws=None):
    S = b.shape[0]
    blocks = (convert.quadratic_cost(Q), convert.linear_cone(A, c))
    if ws is None:
        ws = (torch.zeros((S, 0), dtype=F64), torch.ones(c.shape, dtype=F64))
    scal = dict(k=np.zeros(S), b_scaling=np.ones(S), c_scaling=np.ones(S))
    return ct.solve_scenarios(blocks, (convert.equality_block(Aeq, beq),),
                              convert.tensor(b), ws, convert.scalars(scal),
                              ct.SolverConfig(**solver))


@pytest.fixture
def dense_path(monkeypatch):
    """Switch the split off: every LinearCone runs its dense products."""
    def use():
        monkeypatch.setattr(LinearCone, "split_bound_rows", lambda self: self)
    return use


def test_one_split_per_solve_is_counted():
    config, (Q, A, c, Aeq, beq, b) = _portfolio_batch(2, 1, 100)
    solver = dict(config["solver"], max_iterations=4)
    before = counters.copy()
    _solve(Q, A, c, Aeq, beq, b, solver)
    diff = {key: counters[key] - before[key]
            for key in ("lp.rows", "lp.bound_rows", "sync.cone.lp_split")}
    assert diff == {"lp.rows": 200, "lp.bound_rows": 200, "sync.cone.lp_split": 1}
    # A uniform dense LP: n rows, none bound.
    g = _gen(21)
    Ad = torch.rand((2, 9, 4), generator=g, dtype=F64) + 0.1
    before = counters.copy()
    ct.solve_scenarios((LinearCone(A=Ad, c=torch.ones((2, 9), dtype=F64)),), (),
                       torch.ones((2, 4), dtype=F64), (torch.ones((2, 9), dtype=F64),),
                       convert.scalars(dict(k=np.zeros(2), b_scaling=np.ones(2),
                                            c_scaling=np.ones(2))),
                       ct.SolverConfig(max_iterations=3))
    diff = {key: counters[key] - before[key]
            for key in ("lp.rows", "lp.bound_rows", "sync.cone.lp_split")}
    assert diff == {"lp.rows": 9, "lp.bound_rows": 0, "sync.cone.lp_split": 1}


def test_a_nan_iterate_still_fails_its_scenario(dense_path):
    """Scenario 1 starts from a box iterate with a NaN: it fails, and the
    other solves, on the split path as on the dense one."""
    config, (Q, A, c, Aeq, beq, b) = _portfolio_batch(3, 1, 100, chunk=2)
    w = torch.ones(c.shape, dtype=F64)
    w[1, 7] = float("nan")
    ws = (torch.zeros((3, 0), dtype=F64), w)
    split = _solve(Q, A, c, Aeq, beq, b, config["solver"], ws)
    dense_path()
    dense = _solve(Q, A, c, Aeq, beq, b, config["solver"], ws)
    for res in (split, dense):
        assert res.fail.tolist() == [False, True, False]
        assert res.solved.tolist() == [True, False, True]
    assert torch.equal(split.num_iterations, dense.num_iterations)


def test_a_portfolio_batch_solves_as_on_the_dense_path_and_as_in_jax(dense_path):
    """k = 2, n = 200, two programs: the same solved flags and iteration
    counts, y within 1e-9 of the dense path's, and the trajectory of
    tests/test_torch_portfolio_qp.py against the JAX package."""
    config, (Q, A, c, Aeq, beq, b) = _portfolio_batch(2, 2, 200)
    solver = dict(config["solver"])
    S = b.shape[0]
    rj, rt = _batch_result(
        [JCost(Q=jnp.asarray(Q)), JLinear(A=jnp.asarray(A), c=jnp.asarray(c))],
        [JEq(A=jnp.asarray(Aeq), b=jnp.asarray(beq))],
        (convert.quadratic_cost(Q), convert.linear_cone(A, c)),
        (convert.equality_block(Aeq, beq),), b,
        [jnp.zeros((S, 0)), jnp.ones(c.shape)],
        (torch.zeros((S, 0), dtype=F64), torch.ones(c.shape, dtype=F64)), solver)
    assert rj.solved.all() and rt.solved.all()
    _assert_same_batch(rt, rj)
    np.testing.assert_allclose(rt.y, rj.y, rtol=0, atol=1e-8)
    dense_path()
    dense = convert.to_numpy(_solve(Q, A, c, Aeq, beq, b, solver))
    np.testing.assert_array_equal(rt.solved, dense.solved)
    np.testing.assert_array_equal(rt.num_iterations, dense.num_iterations)
    np.testing.assert_allclose(rt.y, dense.y, rtol=0, atol=1e-9)

"""The port's supernodal KKT path (conex_tpu_torch/supernodal, native/)
against conex_tpu, in f64 on the CPU.

Mirrors tests/test_supernodal.py and tests/test_compressed.py case by
case, on the same numpy inputs, as a batch of two scenarios (the case's
own matrix and one of another seed) that each agree with their own JAX
call.  Tolerances:

* the ordering, the elimination utilities, the index maps and the
  compressed packing: equal (host integer work and copies);
* the LDLT factors: 1e-12 relative, the bar of the dense LDLT
  (tests/test_torch_kkt.py).  Each block runs solver/kkt.py's column
  loop, whose update is one fused multiply-add per entry as XLA makes it;
  the off-diagonal triangular solves and products round as LAPACK and
  XLA each do (one ulp apart on tests/test_supernodal.py's first
  pattern).  The clamp decisions are part of the result: the clamped
  pivots are equal, +/-1e-9 in both;
* the LLT factors: 1e-12 relative (LAPACK's and XLA's Cholesky round
  alike on these orders, but nothing promises it);
* the solutions: 1e-12 relative to the JAX call, and the JAX tests' own
  bounds against numpy's dense solve (1e-9 LLT, 1e-8 / 1e-7 LDLT);
* ``matvec``: 1e-12 relative to the JAX call and the JAX test's 1e-10
  against G x.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from conex_tpu import native as jnative
from conex_tpu.supernodal import compressed as jc
from conex_tpu.supernodal import elimination as jelim
from conex_tpu.supernodal import ordering as jord
from conex_tpu.supernodal import scan as jscan
from conex_tpu.supernodal import solver as jsolver

from conex_tpu_torch import native
from conex_tpu_torch.config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from conex_tpu_torch.solver import kkt as tkkt
from conex_tpu_torch.supernodal import compressed as tc
from conex_tpu_torch.supernodal import elimination as telim
from conex_tpu_torch.supernodal import ordering as tord
from conex_tpu_torch.supernodal import scan as tscan
from conex_tpu_torch.supernodal import solver as tsolver

from test_compressed import PATTERNS, random_clique_spd
from test_supernodal import SCAN_PATTERNS, check_valid_elimination

ORDER_PATTERNS = [
    [[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8]],
    [[0, 1], [1, 2], [2, 3], [0, 3]],
    [[0, 1, 4], [1, 2, 4], [2, 3, 4], [0, 5]],
    [[0, 1, 2, 3, 4]],
    [[0, 1, 2, 3, 7, 8], [3, 4, 7], [4, 5, 6, 7, 8], [8, 9]],
]

# (JAX module, port module, structure class name) of each structure.
UNROLLED = (jsolver, tsolver, "SupernodalStructure")
SCAN = (jscan, tscan, "ScanSupernodalStructure")
COMPRESSED = (jc, tc, "CompressedSupernodalStructure")


def _tensor(x):
    return torch.tensor(np.asarray(x, np.float64))


def _leaves(fac):
    """The arrays of a factor, in order, with the scenario axis of the
    port's first."""
    if isinstance(fac, (tuple, list)):
        return [x for part in fac for x in _leaves(part)]
    return [fac]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


@functools.lru_cache(maxsize=None)
def _jit(module, name, structure):
    fn = getattr(module, name)
    if name.startswith("factor"):
        return jax.jit(lambda M: fn(M, structure))
    return jax.jit(lambda fac, b: fn(fac, structure, b))


def _structures(kind, cliques, n):
    jm, tm, cls = kind
    J = getattr(jm, cls).from_cliques(cliques, n)
    T = getattr(tm, cls).from_cliques(cliques, n)
    assert J.blocks == T.blocks and J.n == T.n
    return J, T


def _pack(kind, J, T, Ms):
    """The inputs of the factor: the dense matrices, or their compressed
    buffers (the port's equal to JAX's)."""
    if kind is not COMPRESSED:
        return [jnp.asarray(M) for M in Ms], _tensor(np.stack(Ms))
    jbufs = [jc.compress_dense(jnp.asarray(M), J) for M in Ms]
    tbuf = tc.compress_dense(_tensor(np.stack(Ms)), T)
    np.testing.assert_array_equal(tbuf.numpy(), np.stack([np.asarray(b) for b in jbufs]))
    return jbufs, tbuf


def _factor_solve_both(kind, mode, cliques, n, Ms, bs, fac_tol):
    """Factor and solve the batch Ms in the port and each scenario in JAX;
    hold the factors to fac_tol and the solutions; return the port's
    solutions, fail flags and factor, and JAX's factors."""
    jm, tm, _ = kind
    J, T = _structures(kind, cliques, n)
    jin, tin = _pack(kind, J, T, Ms)
    tfac, tfail = getattr(tm, f"factor_{mode}")(tin, T)
    tx = getattr(tm, f"solve_{mode}")(tfac, T, _tensor(np.stack(bs))).numpy()
    jfacs = []
    for s, (M, b) in enumerate(zip(Ms, bs)):
        jfac, jfail = _jit(jm, f"factor_{mode}", J)(jin[s])
        jfacs.append(jfac)
        assert bool(tfail[s]) == bool(jfail)
        for t, j in zip(_leaves(tfac), _leaves(jfac)):
            assert _rel(t[s].numpy(), j) <= fac_tol
        jx = _jit(jm, f"solve_{mode}", J)(jfac, jnp.asarray(b))
        assert _rel(tx[s], jx) <= 1e-12
    return tx, tfail, tfac, jfacs


def _batch(cliques, n, seed, indefinite=False):
    """The JAX test's matrix at ``seed`` and one of seed + 100, with a
    right-hand side each."""
    Ms, bs = [], []
    for sd in (seed, seed + 100):
        rng = np.random.default_rng(sd)
        G = random_clique_spd(cliques, n, rng)
        if indefinite:
            last = cliques[-1][-1]
            G[last, last] = -G[last, last]
        Ms.append(G)
        bs.append(rng.normal(size=n))
    return Ms, bs


# ---------------------------------------------------------------------------
# The ordering (tests/test_supernodal.py)
# ---------------------------------------------------------------------------


def test_path_in_tree():
    parent = [0, 0, 1, 2]
    height = [0, 1, 2, 3]
    for x, y in ((3, 1), (1, 3), (2, 2), (0, 3)):
        assert tord.path_in_tree(x, y, parent, height) == jord.path_in_tree(
            x, y, parent, height)
    assert tord.path_in_tree(3, 1, parent, height) == [3, 2, 1]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("cliques", ORDER_PATTERNS)
def test_pick_clique_order_matches_jax(cliques, use_native):
    """Both routes of the port give JAX's Python ordering, block for block,
    and a valid elimination."""
    n = max(max(c) for c in cliques) + 1
    want = jord.pick_clique_order(cliques, use_native=False)
    got = tord.pick_clique_order(cliques, use_native=use_native)
    assert got == want
    check_valid_elimination(cliques, got, n)


def test_clique_order_chain_and_fill_in():
    """tests/test_supernodal.py's two ordering cases on the port."""
    co = tord.pick_clique_order([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8]])
    assert sorted(sum((co.separators[e] for e in co.order), [])) == [2, 4, 6]
    co = tord.pick_clique_order([[0, 1], [1, 2], [2, 3], [0, 3]])
    assert sum(len(co.separators[e]) for e in co.order) >= 3


def test_native_builds_and_matches_python_ordering():
    """The port builds its own library from its copy of the C++ source
    (g++ is on this machine, as on the JAX package's) into _build/, under
    a name that carries the source's hash, and it gives the Python
    ordering; so does JAX's library."""
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libconex_clique_order_")
    assert jnative.available()
    for cliques in ORDER_PATTERNS + [[[2 * i, 2 * i + 1, 2 * i + 2] for i in range(40)]]:
        a = tord.pick_clique_order(cliques, use_native=True)
        b = tord.pick_clique_order(cliques, use_native=False)
        assert a == b == jord.pick_clique_order(cliques, use_native=True)


def test_valid_leaf_and_root_match_jax():
    """Equality-dual cliques (valid_leaf 0) and a fixed root, as
    Program._kkt_structure passes them."""
    cliques = [[0, 1, 2], [2, 3], [3, 4, 5], [0, 1, 6, 7], [4, 5, 8]]
    valid = [1, 1, 1, 0, 0]
    for root in (-1, 2):
        want = jord.pick_clique_order(cliques, valid_leaf=valid, root=root,
                                      use_native=False)
        for use_native in (True, False):
            assert tord.pick_clique_order(cliques, valid_leaf=valid, root=root,
                                          use_native=use_native) == want
    J = jsolver.SupernodalStructure.from_cliques(cliques, 10, valid_leaf=valid)
    T = tsolver.SupernodalStructure.from_cliques(cliques, 10, valid_leaf=valid)
    assert T == tuple(J) and T.blocks[-1] == ((9,), ())  # the uncovered variable


def test_elimination_ordering_utilities():
    """tests/test_supernodal.py's MCS / chordality case, and the port's
    copy against JAX's on random graphs."""
    A = np.zeros((4, 4), dtype=bool)
    for i, j in [(0, 1), (1, 2), (0, 2), (1, 3), (2, 3)]:
        A[i, j] = A[j, i] = True
    assert telim.is_chordal(A)
    order = telim.maximum_cardinality_search(A)
    assert sorted(order) == [0, 1, 2, 3] and telim.is_perfectly_ordered(A, order)
    C4 = np.zeros((4, 4), dtype=bool)
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        C4[i, j] = C4[j, i] = True
    assert not telim.is_chordal(C4)
    assert not telim.is_perfectly_ordered(C4, [0, 1, 2, 3])
    rng = np.random.default_rng(0)
    for _ in range(5):
        R = rng.random((7, 7)) < 0.4
        R = R | R.T
        np.fill_diagonal(R, False)
        assert telim.maximum_cardinality_search(R) == jelim.maximum_cardinality_search(R)
        assert telim.is_chordal(R) == jelim.is_chordal(R)
        np.testing.assert_array_equal(telim.eliminate(R, 3), jelim.eliminate(R, 3))


# ---------------------------------------------------------------------------
# Factor and solve: unrolled, padded (scan) and compressed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cliques,n", SCAN_PATTERNS)
@pytest.mark.parametrize("kind", [UNROLLED, SCAN, COMPRESSED],
                         ids=["unrolled", "scan", "compressed"])
def test_llt_matches_jax_and_dense(kind, cliques, n):
    Ms, bs = _batch(cliques, n, 0)
    x, fail, _, _ = _factor_solve_both(kind, "llt", cliques, n, Ms, bs, 1e-12)
    assert not fail.any()
    for s in range(2):
        np.testing.assert_allclose(x[s], np.linalg.solve(Ms[s], bs[s]), atol=1e-9)


@pytest.mark.parametrize("cliques,n", SCAN_PATTERNS)
@pytest.mark.parametrize("kind", [UNROLLED, SCAN, COMPRESSED],
                         ids=["unrolled", "scan", "compressed"])
def test_ldlt_matches_jax_and_dense(kind, cliques, n):
    """tests/test_supernodal.py::test_scan_ldlt_matches_dense's indefinite
    inputs, factored to JAX's bits on every structure."""
    Ms, bs = _batch(cliques, n, 1, indefinite=True)
    x, fail, _, _ = _factor_solve_both(kind, "ldlt", cliques, n, Ms, bs, 1e-12)
    assert not fail.any()
    for s in range(2):
        np.testing.assert_allclose(x[s], np.linalg.solve(Ms[s], bs[s]), atol=1e-7)


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_compressed_ldlt_on_spd_patterns(cliques, n):
    """tests/test_compressed.py::test_compressed_ldlt_matches_dense."""
    Ms, bs = _batch(cliques, n, 3)
    x, *_ = _factor_solve_both(COMPRESSED, "ldlt", cliques, n, Ms, bs, 0)
    for s in range(2):
        np.testing.assert_allclose(x[s], np.linalg.solve(Ms[s], bs[s]), atol=1e-8)


@pytest.mark.parametrize("kind", [UNROLLED, COMPRESSED], ids=["unrolled", "compressed"])
def test_ldlt_on_a_saddle_kkt_system(kind):
    """tests/test_supernodal.py::test_supernodal_ldlt_indefinite's
    [G A'; A 0] with the duals in the clique, and the ragged indefinite
    pattern of test_supernodal_ldlt_sparse_indefinite."""
    rng = np.random.default_rng(1)
    m, p = 5, 2
    K = np.zeros((m + p, m + p))
    Gtop = rng.normal(size=(m, m))
    K[:m, :m] = Gtop @ Gtop.T + np.eye(m)
    A = rng.normal(size=(p, m))
    K[m:, :m], K[:m, m:] = A, A.T
    b = rng.normal(size=m + p)
    cliques = [list(range(m + p))]
    x, fail, _, _ = _factor_solve_both(kind, "ldlt", cliques, m + p, [K, K], [b, -b],
                                 1e-12)
    assert not fail.any()
    np.testing.assert_allclose(x[0], np.linalg.solve(K, b), atol=1e-8)
    rng = np.random.default_rng(2)
    cliques, n = [[0, 1, 2, 6], [2, 3, 6], [3, 4, 5, 6]], 7
    G = random_clique_spd(cliques, n, rng)
    G[6, 6] = -G[6, 6]
    b = rng.normal(size=n)
    x, fail, _, _ = _factor_solve_both(kind, "ldlt", cliques, n, [G, G], [b, b],
                                 1e-12)
    np.testing.assert_allclose(x[0], np.linalg.solve(G, b), atol=1e-7)


@pytest.mark.parametrize("kind", [UNROLLED, SCAN, COMPRESSED],
                         ids=["unrolled", "scan", "compressed"])
def test_clamp_fires_in_one_scenario_and_not_the_other(kind, monkeypatch):
    """A structurally zero variable inside a supernode of scenario 0 only:
    its pivot is clamped to +1e-9 (the clamp of solver/kkt.py, which the
    blocks run), scenario 1's is not; each scenario's factor holds its own
    JAX call's, and the pivots JAX clamps are the port's, to the bit."""
    fired = []
    clamp = tkkt._clamp_pivot

    def record(d):
        fired.append((d.abs() < tkkt.LDLT_PIVOT_CLAMP).tolist())
        return clamp(d)

    monkeypatch.setattr(tkkt, "_clamp_pivot", record)
    cliques, n = [[0, 1, 2, 6], [2, 3, 6], [3, 4, 5, 6]], 7
    Ms, bs = _batch(cliques, n, 4, indefinite=True)
    Ms[0][1, :] = 0.0
    Ms[0][:, 1] = 0.0
    _, _, tfac, jfacs = _factor_solve_both(kind, "ldlt", cliques, n, Ms, bs, 1e-12)
    assert [True, False] in fired and [False, True] not in fired
    for s, jfac in enumerate(jfacs):
        td = np.concatenate([d[s].numpy().ravel() for d in _leaves(tfac[1])])
        jd = np.concatenate([np.asarray(d).ravel() for d in _leaves(jfac[1])])
        clamped = np.abs(jd) == tkkt.LDLT_PIVOT_CLAMP
        assert clamped.sum() == (s == 0)
        np.testing.assert_array_equal(td[clamped], jd[clamped])
        assert (np.abs(td) == tkkt.LDLT_PIVOT_CLAMP).sum() == clamped.sum()


@pytest.mark.parametrize("kind", [UNROLLED, SCAN, COMPRESSED],
                         ids=["unrolled", "scan", "compressed"])
def test_llt_fails_on_indefinite_per_scenario(kind):
    """-I fails (reference kkt_solver.cc:178-189), I does not, in one
    batch, as in JAX."""
    n = 4
    J, T = _structures(kind, [[0, 1, 2, 3]], n)
    Ms = [-np.eye(n), np.eye(n)]
    jin, tin = _pack(kind, J, T, Ms)
    _, fail = kind[1].factor_llt(tin, T)
    assert fail.tolist() == [True, False]
    assert [bool(kind[0].factor_llt(M, J)[1]) for M in jin] == [True, False]


def test_scan_matches_unrolled_long_chain():
    """tests/test_supernodal.py's 100-clique chain: the padded structure
    against the unrolled one, JAX and the dense solve."""
    K = 100
    cliques = [[2 * i, 2 * i + 1, 2 * i + 2] for i in range(K)]
    n = 2 * K + 1
    Ms, bs = _batch(cliques, n, 2)
    x, *_ = _factor_solve_both(SCAN, "llt", cliques, n, Ms, bs, 1e-12)
    T = tsolver.SupernodalStructure.from_cliques(cliques, n)
    fac, fail = tsolver.factor_llt(_tensor(np.stack(Ms)), T)
    xu = tsolver.solve_llt(fac, T, _tensor(np.stack(bs))).numpy()
    assert not fail.any() and _rel(x, xu) <= 1e-12
    np.testing.assert_allclose(x[0], np.linalg.solve(Ms[0], bs[0]), atol=1e-8)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("mode", ["llt", "ldlt"])
def test_solver_wrapper(scan, mode):
    """SupernodalKKTSolver on numpy input (device="cpu"), one matrix or a
    batch, against JAX's wrapper and the dense solve."""
    rng = np.random.default_rng(3)
    cliques = [[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8], [8, 9, 0]]
    n = 10
    G = random_clique_spd(cliques, n, rng)
    b = rng.normal(size=n)
    jsol = jsolver.SupernodalKKTSolver(cliques, n, mode=mode, scan=scan)
    tsol = tsolver.SupernodalKKTSolver(cliques, n, mode=mode, scan=scan, device="cpu")
    assert jsol.factor(G) and tsol.factor(G)
    x = tsol.solve(b)
    assert _rel(x, jsol.solve(b)) <= 1e-12
    np.testing.assert_allclose(x, np.linalg.solve(G, b), atol=1e-8)
    assert tsol.factor(np.stack([G, 2 * G]))
    xs = tsol.solve(np.stack([b, b]))
    np.testing.assert_allclose(xs[1], 0.5 * xs[0], rtol=1e-12)
    assert tsol.factor(torch.tensor(-np.eye(n))) == (mode == "ldlt")


# ---------------------------------------------------------------------------
# The compressed buffer (tests/test_compressed.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_compress_densify_matvec(cliques, n):
    """compress_dense gives JAX's buffer and densify recovers every
    pattern entry; matvec agrees with JAX's and with G x."""
    Ms, _ = _batch(cliques, n, 0)
    J, T = _structures(COMPRESSED, cliques, n)
    jbufs, tbuf = _pack(COMPRESSED, J, T, Ms)
    np.testing.assert_allclose(tc.densify(tbuf, T).numpy(), np.stack(Ms), atol=1e-12)
    x = np.random.default_rng(1).normal(size=(2, n))
    y = tc.matvec(tbuf, T, _tensor(x)).numpy()
    for s in range(2):
        assert _rel(y[s], jc.matvec(jbufs[s], J, jnp.asarray(x[s]))) <= 1e-12
        np.testing.assert_allclose(y[s], Ms[s] @ x[s], atol=1e-10)


@pytest.mark.parametrize("cliques,n", PATTERNS)
def test_index_maps_match_jax(cliques, n):
    """The layout, the update map and the assembly maps of every clique
    equal JAX's; each clique's real targets are distinct, so only the
    dump slot takes more than one write of a scatter."""
    J, T = _structures(COMPRESSED, cliques, n)
    for attr in ("smax", "pmax", "d_size", "o_size", "buf_size", "dump"):
        assert getattr(T, attr) == getattr(J, attr)
    np.testing.assert_array_equal(tc._update_map(T), jc._update_map(J))
    for a, b in zip(tc._padded_indices(T), jc._padded_indices(J)):
        np.testing.assert_array_equal(a, b)
    for c in cliques:
        m = tc.assembly_map(T, tuple(c), tuple(c))
        np.testing.assert_array_equal(m, jc.assembly_map(J, tuple(c), tuple(c)))
        real = m[m != T.dump]
        assert len(set(real.tolist())) == real.size
    for row in tc._update_map(T).reshape(len(T.blocks), -1):
        real = row[row != T.dump]
        assert len(set(real.tolist())) == real.size


def test_scatter_contribution_and_empty_buffer():
    """The assembly primitive on a batch: the same buffer as JAX's for
    each scenario, and the dense oracle after densify."""
    cliques, n = [[0, 1, 2, 6], [2, 3, 6], [3, 4, 5, 6]], 7
    J, T = _structures(COMPRESSED, cliques, n)
    rng = np.random.default_rng(8)
    vals = [rng.normal(size=(2, len(c), len(c))) for c in cliques]
    vals = [0.5 * (v + np.swapaxes(v, 1, 2)) for v in vals]
    buf = tc.empty_buffer(T, torch.float64, 2)
    assert buf.shape == (2, T.buf_size)
    for c, v in zip(cliques, vals):
        assert tc.scatter_contribution(buf, T, c, c, _tensor(v)) is buf
    buf[:, T.dump] = 0.0
    dense = np.zeros((2, n, n))
    for s in range(2):
        jbuf = jc.empty_buffer(J, jnp.float64)
        for c, v in zip(cliques, vals):
            jbuf = jc.scatter_contribution(jbuf, J, c, c, jnp.asarray(v[s]))
            dense[s][np.ix_(c, c)] += v[s]
        jbuf = jbuf.at[J.dump].set(0.0)
        np.testing.assert_array_equal(buf[s].numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(tc.densify(buf, T).numpy(), dense, atol=1e-14)


def test_compressed_factor_gives_the_same_bits_twice():
    cliques = [[2 * i, 2 * i + 1, 2 * i + 2] for i in range(30)]
    n = 61
    Ms, _ = _batch(cliques, n, 9)
    T = tc.CompressedSupernodalStructure.from_cliques(cliques, n)
    buf = tc.compress_dense(_tensor(np.stack(Ms)), T)
    held = buf.clone()
    for mode in ("llt", "ldlt"):
        a, _ = getattr(tc, f"factor_{mode}")(buf, T)
        b, _ = getattr(tc, f"factor_{mode}")(buf, T)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(buf, held)  # the factor leaves its input alone


def _chain_structure(K):
    """The compressed structure of the chain [2i, 2i+1, 2i+2], i < K
    (K >= 3), written out: the cliques from the far end inward, then
    [0, 1] and the root [2, 3, 4].  The ordering takes O(K^2) steps
    (33 s at K = 5000, in the C++ of both packages), so the test below
    checks this form against it at K = 50 and uses it at K = 5000."""
    blocks = tuple(((2 * i + 1, 2 * i + 2), (2 * i,)) for i in range(K - 1, 1, -1))
    blocks += (((0, 1), (2,)), ((2, 3, 4), ()))
    return tc.CompressedSupernodalStructure(blocks=blocks, n=2 * K + 1)


def test_big_chain_o_sum_block_memory():
    """tests/test_compressed.py's 10^4-variable chain, factored and solved
    with O(sum of block sizes) storage; the dense (N, N) matrix is never
    built.  Verified through the compressed matvec, as in JAX."""
    cliques = [[2 * i, 2 * i + 1, 2 * i + 2] for i in range(50)]
    assert _chain_structure(50) == tc.CompressedSupernodalStructure.from_cliques(
        cliques, 101)
    K = 5000
    n = 2 * K + 1
    cliques = [[2 * i, 2 * i + 1, 2 * i + 2] for i in range(K)]
    s = _chain_structure(K)
    # O(sum of blocks): ~6 floats per clique, not N^2 = 1e8.
    assert s.buf_size < 20 * K
    rng = np.random.default_rng(5)
    buf = np.zeros(s.buf_size)
    for c in cliques:
        M = rng.normal(size=(3, 3))
        M = M @ M.T + 2.0 * np.eye(3)
        idx = np.asarray(tc.assembly_map(s, tuple(c), tuple(c)))
        np.add.at(buf, idx.ravel(), M.ravel())
    buf[s.dump] = 0.0
    buf = _tensor(buf)[None]
    b = _tensor(rng.normal(size=n))[None]
    fac, fail = tc.factor_llt(buf, s)
    assert not fail.any()
    assert fac[0].shape == (1, K, s.smax, s.smax)
    x = tc.solve_llt(fac, s, b)
    r = tc.matvec(buf, s, x) - b
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)) < 1e-10


def test_kkt_dispatch_and_refinement_on_the_compressed_buffer():
    """kkt.factor / kkt.solve pick each structure's module; refinement on
    the compressed buffer runs through its matvec and gives JAX's
    refined solution."""
    from conex_tpu.solver import kkt as jkkt

    cliques, n = [[0, 1, 2, 6], [2, 3, 6], [3, 4, 5, 6]], 7
    for mode in (KKT_SOLVER_LLT, KKT_SOLVER_LDLT):
        Ms, bs = _batch(cliques, n, 6, indefinite=mode == KKT_SOLVER_LDLT)
        for kind in (UNROLLED, SCAN, COMPRESSED):
            J, T = _structures(kind, cliques, n)
            jin, tin = _pack(kind, J, T, Ms)
            f = tkkt.factor(tin, mode, T)
            x = tkkt.solve(f, _tensor(np.stack(bs)), mode, 2, T).numpy()
            jfn = jax.jit(lambda M, b: jkkt.solve(jkkt.factor(M, mode, J), b, mode,
                                                  2, J))
            for s in range(2):
                assert _rel(x[s], jfn(jin[s], jnp.asarray(bs[s]))) <= 1e-12
                np.testing.assert_allclose(x[s], np.linalg.solve(Ms[s], bs[s]),
                                           atol=1e-9)
    Ms, _ = _batch(cliques, n, 6)
    with pytest.raises(TypeError, match="unknown supernodal structure"):
        tkkt.factor(_tensor(np.stack(Ms)), tkkt.KKT_SOLVER_LLT, structure=object())

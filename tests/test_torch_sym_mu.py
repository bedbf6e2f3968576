"""algebra/sym.py and solver/mu.py of the port against conex_tpu, in f64.

The same numpy inputs go through both packages.  Tolerances:

* exact-arithmetic twins (Taylor exponential, mu formulas) agree to a few
  ulps of f64 (rtol 1e-12): the two packages only sum in other orders;
* the estimators run their eigenvector stages in f32 on f64 inputs, as the
  JAX package does, and XLA and PyTorch round their f32 products
  differently.  The cold estimator converges (512 power steps), so the f64
  Rayleigh quotient hides that (rtol 1e-10, ~1e-13 observed); the warm one
  takes 16 steps from a seed, leaving the estimate first-order in the f32
  rounding of an unconverged vector (rtol 1e-6, ~4e-9 observed).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from conex_tpu.algebra import sym as jsym
from conex_tpu.solver import mu as jmu
from conex_tpu_torch.algebra import sym as tsym
from conex_tpu_torch.cones.psd import PSDState
from conex_tpu_torch.solver import mu as tmu
from conex_tpu_torch.utils.profiling import counters


def _t(x):
    return torch.as_tensor(np.array(x))


def _ws_products(rng, shape, n):
    """WS = W S with W PSD and S symmetric indefinite: a real spectrum."""
    X = rng.uniform(-1, 1, shape + (n, n))
    W = X @ np.swapaxes(X, -1, -2) / n + 0.2 * np.eye(n)
    S = rng.uniform(-1, 1, shape + (n, n))
    S = 0.5 * (S + np.swapaxes(S, -1, -2))
    return W @ S


@pytest.mark.parametrize("n", [5, 12])
def test_expm_taylor_matches_jax(n):
    rng = np.random.default_rng(0)
    A = rng.uniform(-1, 1, (3, 2, n, n))
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    A = A / np.linalg.norm(A, 2, axis=(-2, -1), keepdims=True) * 1.4
    want = np.asarray(jsym.expm_taylor(jnp.asarray(A)))
    got = tsym.expm_taylor(_t(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n", [6, 16])
def test_extreme_eigenvalues_seeded_matches_jax(n):
    rng = np.random.default_rng(1)
    M = _ws_products(rng, (3, 2), n)
    jlo, jhi, jseeds, jlam = jsym.extreme_eigenvalues_seeded(jnp.asarray(M))
    tlo, thi, tseeds, tlam = tsym.extreme_eigenvalues_seeded(_t(M))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=1e-10)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=1e-10)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-10)
    # The seeds are f32-quality eigenvector estimates cast to f64.
    for t, j in zip(tseeds, jseeds):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    # ... and really the extremes of the spectrum.
    ev = np.sort(np.linalg.eigvals(M).real, axis=-1)
    np.testing.assert_allclose(tlo.numpy(), ev[..., 0], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(thi.numpy(), ev[..., -1], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n", [6, 16])
def test_extreme_eigenvalues_warm_matches_jax(n):
    rng = np.random.default_rng(2)
    M0 = _ws_products(rng, (3, 2), n)
    # Seeds from the cold estimator of a nearby matrix, as in the solve loop.
    _, _, seeds, lam = jsym.extreme_eigenvalues_seeded(jnp.asarray(M0))
    M = M0 + 0.05 * _ws_products(rng, (3, 2), n)
    seeds = [np.asarray(s) for s in seeds]
    lam = np.asarray(lam)
    jlo, jhi, jseeds, jlam = jsym.extreme_eigenvalues_warm(
        jnp.asarray(M), *map(jnp.asarray, seeds), jnp.asarray(lam)
    )
    tlo, thi, tseeds, tlam = tsym.extreme_eigenvalues_warm(
        _t(M), *map(_t, seeds), _t(lam)
    )
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=1e-6)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=1e-6)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=1e-6)
    for t, j in zip(tseeds, jseeds):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_extreme_eigenvalues_warm_cold_sentinel_matches_jax():
    """lam_prev == 0 (cold sentinel) takes the Frobenius shift."""
    rng = np.random.default_rng(3)
    n = 8
    M = _ws_products(rng, (2,), n)
    ones = np.full((2, n), 1.0 / np.sqrt(n))
    lam = np.zeros((2, 2))
    j = jsym.extreme_eigenvalues_warm(
        jnp.asarray(M), *(jnp.asarray(ones),) * 4, jnp.asarray(lam)
    )
    t = tsym.extreme_eigenvalues_warm(_t(M), *(_t(ones),) * 4, _t(lam))
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-6)


@pytest.mark.parametrize("n, cold", [
    (6, [True, False, True, False]),
    (6, [True] * 4),
    (6, [False] * 4),
    (102, [False, True, False]),
])
def test_cold_or_warm_estimate_takes_each_scenarios_estimator(n, cold):
    """The cones' shared estimate: the cold estimator's bits where a
    scenario's carried lam is all zero, the warm one's (max(16, min(64,
    n // 6)) steps) elsewhere, and one ``sync.cone.cold`` per call."""
    rng = np.random.default_rng(5)
    S = len(cold)
    M = _t(_ws_products(rng, (S, 2), n))
    _, _, seeds, lam = tsym.extreme_eigenvalues_seeded(
        M + 0.01 * _t(_ws_products(rng, (S, 2), n)))
    lam = torch.where(torch.tensor(cold)[:, None, None], 0.0, lam)
    carried = PSDState(M, *seeds, lam)
    before = counters["sync.cone.cold"]
    got = tsym.extreme_eigenvalues_cold_or_warm(M, carried)
    assert counters["sync.cone.cold"] == before + 1
    want_cold = tsym.extreme_eigenvalues_seeded(M)
    want_warm = tsym.extreme_eigenvalues_warm(M, *seeds, lam,
                                              num_steps=max(16, min(64, n // 6)))
    flat = lambda out: [out[0], out[1], *out[2], out[3]]
    for g, c, w in zip(flat(got), flat(want_cold), flat(want_warm)):
        for s in range(S):
            want = c[s] if cold[s] else w[s]
            assert g[s].dtype == want.dtype and torch.equal(g[s], want), s


@pytest.mark.parametrize(
    "B",
    [
        np.diag([2.0, 2.0, 1.0, 0.5]),  # two tied dominant columns
        np.ones((5, 5)),  # every column and row tied
        np.eye(4),  # all tied
    ],
    ids=["diag_tie", "ones", "identity"],
)
def test_dominant_rayleigh_argmax_ties_match_jax(B):
    """Tied column/row norms: both packages take the first maximal index,
    so the eigenvector estimates are the same vectors."""
    jlam, ju, jv = jsym._dominant_rayleigh_vec(jnp.asarray(B), 9)
    tlam, tu, tv = tsym._dominant_rayleigh_vec(_t(B), 9)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(float(tlam), float(jlam), rtol=1e-15)


def _slack_aggs(rng, S):
    """Slack statistics covering both divergence branches and fallbacks."""
    lam_min = rng.uniform(-0.5, 1.5, S)
    lam_max = lam_min + rng.uniform(0.0, 3.0, S)
    rank = 12.0
    frob_sq = (lam_min ** 2 + lam_max ** 2) + rng.uniform(0.0, 5.0, S)
    trace = rng.uniform(-2.0, 12.0, S)
    return (lam_min, lam_max, frob_sq, trace), rank


def test_mu_from_divergence_matches_jax():
    rng = np.random.default_rng(4)
    fields, rank = _slack_aggs(rng, 400)
    want = np.asarray(jmu.mu_from_divergence(
        jmu.SlackAgg(*map(jnp.asarray, fields)), rank, 1.0
    ))
    got = tmu.mu_from_divergence(tmu.SlackAgg(*map(_t, fields)), rank, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    # The samples reach the fallbacks too, not only the closed form.
    inv = tmu.divergence_upper_bound_inverse(
        rank, tmu.SlackAgg(*map(_t, fields)), rank
    )
    assert (inv == -1.0).any() and (inv > 0).any()


def test_divergence_bound_inverse_matches_jax_and_inverts():
    rng = np.random.default_rng(5)
    fields, rank = _slack_aggs(rng, 400)
    budget = 1.0 * rank
    jp = jmu.SlackAgg(*map(jnp.asarray, fields))
    tp = tmu.SlackAgg(*map(_t, fields))
    want = np.asarray(jmu.divergence_upper_bound_inverse(budget, jp, rank))
    got = tmu.divergence_upper_bound_inverse(budget, tp, rank)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    ok = got > 0
    assert ok.any()
    d = tmu.divergence_upper_bound(got, tp, rank)[ok]
    np.testing.assert_array_less(d.numpy(), budget * (1 + 1e-9))
    dj = np.asarray(jmu.divergence_upper_bound(jnp.asarray(want), jp, rank))
    np.testing.assert_allclose(
        tmu.divergence_upper_bound(got, tp, rank).numpy(), dj, rtol=1e-10
    )


# ---------------------------------------------------------------------------
# The rest of algebra/sym.py: Pade exponential, asymmetric Lanczos, the
# cold extreme_eigenvalues (tests/test_sdp.py's cases through both)
# ---------------------------------------------------------------------------


def _randsym(n, rng, scale=1.0):
    M = rng.uniform(-1, 1, (n, n)) * scale
    return 0.5 * (M + M.T)


def test_expm_pade_matches_jax():
    """tests/test_sdp.py::test_expm_pade_matches_scipy and _batched.  Both
    solve (V - U) X = V + U by LU with partial pivoting (LAPACK getrf and
    XLA's own), which round alike here: 1e-12."""
    from scipy.linalg import expm

    rng = np.random.default_rng(0)
    for n in [1, 2, 5, 8]:
        A = _randsym(n, rng, scale=0.3)
        got = tsym.expm_pade(_t(A)).numpy()
        np.testing.assert_allclose(got, np.asarray(jsym.expm_pade(jnp.asarray(A))),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got, expm(A), atol=1e-6)
    A = np.stack([_randsym(4, rng, 0.2) for _ in range(3)])
    got = tsym.expm_pade(_t(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsym.expm_pade(jnp.asarray(A))),
                               rtol=1e-12, atol=1e-14)
    for b in range(3):
        np.testing.assert_allclose(got[b], tsym.expm_pade(_t(A[b])).numpy(), atol=1e-12)


def _lanczos_inputs(n=12, seed=2):
    rng = np.random.default_rng(seed)
    M = rng.uniform(-1, 1, (n, n))
    W = M @ M.T + n * np.eye(n)
    S = _randsym(n, rng)
    return W @ S, W, S, rng.uniform(-1, 1, n)


@pytest.mark.parametrize("num_iter", [1, 6, 12])
def test_asymmetric_lanczos_matches_jax(num_iter):
    """tests/test_sdp.py::test_lanczos_extreme_eigenvalues (and depth 1).
    The tridiagonal's eigenvalues: jax's eigh_tridiagonal (bisection)
    against LAPACK's syevd on the dense matrix, both to a few ulps of its
    norm: 1e-12."""
    WS, W, S, r = _lanczos_inputs()
    want = np.asarray(jsym.asymmetric_lanczos(*map(jnp.asarray, (WS, W, r)), num_iter))
    got = tsym.asymmetric_lanczos(*map(_t, (WS, W, r)), num_iter).numpy()
    assert got.shape == want.shape == (num_iter,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    if num_iter == 12:
        L = np.linalg.cholesky(W)
        true = np.linalg.eigvalsh(L.T @ S @ L)
        assert got.max() == pytest.approx(true.max(), rel=1e-6)
        assert got.min() == pytest.approx(true.min(), rel=1e-6)


def test_lanczos_early_exit_mask_matches_jax():
    """tests/test_sdp.py::test_lanczos_early_exit_masking: a rank-2 WS
    stops after two steps; the masked steps repeat alpha_0 with zero
    off-diagonals in both."""
    n = 8
    W = np.eye(n)
    S = np.zeros((n, n))
    S[0, 0], S[1, 1] = 3.0, -2.0
    r = np.ones(n)
    want = np.asarray(jsym.asymmetric_lanczos(*map(jnp.asarray, (W @ S, W, r)), n // 2))
    got = tsym.asymmetric_lanczos(*map(_t, (W @ S, W, r)), n // 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got.max() == pytest.approx(3.0, abs=1e-8)
    assert got.min() == pytest.approx(-2.0, abs=1e-8)
    # The mask fired: the padded diagonal repeats alpha_0 (the Ritz value
    # of the first step), which stands among the eigenvalues.
    alpha0 = float(r @ S @ r / (r @ r))
    assert np.isclose(got, alpha0).sum() >= 1


def test_approximate_eigenvalues_matches_jax():
    WS, W, _, r = _lanczos_inputs(n=6, seed=3)
    for args in ((WS, W, r), (WS[:1, :1], W[:1, :1], r[:1])):
        want = np.asarray(jsym.approximate_eigenvalues(*map(jnp.asarray, args), 4))
        got = tsym.approximate_eigenvalues(*map(_t, args), 4).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_extreme_eigenvalues_cold_matches_jax_on_clustered_spectra():
    """tests/test_sdp.py::test_extreme_eigenvalues_clustered through both
    packages: the same accuracy asserts on the port, and the JAX value.
    The squaring passes run in f32 on f64 inputs, as in the JAX package;
    the f64 Rayleigh quotient is second-order in the f32 eigenvector's
    error.  The bottom of these spectra is crowded (126 uniform values in
    [0, 0.99]: a dominance ratio of about 1.008 per power step, 512 steps),
    so the estimate there is not converged and the two packages' f32
    rounding shows at up to 6.2e-11 of the spectral radius: 1e-9 of it.
    The top: where it is a cluster of width 1e-6, the f32 eigenvector is a
    mix inside the cluster that XLA and PyTorch round differently, and the
    estimate moves inside the cluster (within its width, which the JAX
    test counts as exact); else 1e-9 of the radius too."""
    rng = np.random.default_rng(0)

    def make(n, eigs):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        return Q @ np.diag(eigs) @ Q.T

    def both(M, gap):
        lo, hi = tsym.extreme_eigenvalues(_t(M))
        jlo, jhi = jsym.extreme_eigenvalues(jnp.asarray(M))
        radius = max(abs(float(jlo)), abs(float(jhi)))
        np.testing.assert_allclose(float(lo), float(jlo), rtol=0, atol=1e-9 * radius)
        np.testing.assert_allclose(float(hi), float(jhi), rtol=0,
                                   atol=max(1e-9, gap) * radius)
        return float(lo), float(hi)

    for n in (32, 64, 128):
        for gap in (1e-3, 1e-6):
            eigs = np.concatenate([[1.0, 1.0 - gap], rng.uniform(0.0, 0.99, n - 2)])
            lo, hi = both(make(n, eigs), gap)
            assert abs(hi - 1.0) <= max(5e-4, gap), (n, gap)
            assert abs(lo - eigs.min()) <= 5e-4, (n, gap)

    eigs = np.concatenate([[1.0, 1.0 - 1e-6], rng.uniform(-0.95, 0.95, 62)])
    lo, hi = both(make(64, eigs), 1e-6)
    assert abs(hi - 1.0) <= 1e-5
    assert abs(lo - eigs.min()) <= 1e-5

    n = 64
    W = make(n, rng.uniform(0.5, 2.0, n))
    S = 1e-6 * np.linalg.inv(W) + 1e-9 * make(n, rng.uniform(0, 1, n))
    WS = W @ S
    true = np.sort(np.linalg.eigvals(WS).real)
    lo, hi = both(WS, 0.0)
    assert abs(hi - true[-1]) / true[-1] <= 1e-2
    assert abs(lo - true[0]) / true[0] <= 1e-2

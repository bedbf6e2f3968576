"""The port's dense KKT paths (solver/kkt.py: LLT, the clamped LDLT and
QR) against conex_tpu, in f64.

The port factors all scenarios as one batch; each scenario is compared
with its own JAX call.  Factors and triangular solves of the same
well-conditioned matrices agree to rounding (rtol 1e-10 on the solution
for condition numbers up to ~1e3; the LDLT factor of a saddle KKT matrix
to 1e-12 relative).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from conex_tpu.config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT, KKT_SOLVER_QR
from conex_tpu.solver import kkt as jkkt
from conex_tpu_torch import convert
from conex_tpu_torch.solver import kkt as tkkt


def _spd(rng, S, N, asym=0.0):
    X = rng.uniform(-1, 1, (S, N, N))
    K = X @ np.swapaxes(X, 1, 2) + 0.5 * np.eye(N)
    # A rounding-level asymmetry, as an assembled Schur complement has.
    return K + asym * rng.uniform(-1, 1, (S, N, N))


@pytest.mark.parametrize("refine", [0, 2])
def test_llt_factor_solve_matches_jax(refine):
    rng = np.random.default_rng(0)
    S, N = 4, 7
    K = _spd(rng, S, N, asym=1e-13)
    b = rng.uniform(-1, 1, (S, N))
    f = tkkt.factor(convert.tensor(K), KKT_SOLVER_LLT)
    x = tkkt.solve(f, convert.tensor(b), KKT_SOLVER_LLT, refine)
    assert not f.fail.any()
    for s in range(S):
        jf = jkkt.factor(jnp.asarray(K[s]), KKT_SOLVER_LLT)
        jx = jkkt.solve(jf, jnp.asarray(b[s]), KKT_SOLVER_LLT, refine)
        np.testing.assert_allclose(f.factor[s].numpy(), np.asarray(jf.factor),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(x[s].numpy(), np.asarray(jx), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(np.einsum("sij,sj->si", K, x.numpy()), b, atol=1e-10)


def test_fail_flag_per_scenario_on_indefinite_and_nonfinite():
    rng = np.random.default_rng(1)
    S, N = 4, 5
    K = _spd(rng, S, N)
    K[1] = K[1] - 50.0 * np.eye(N)  # indefinite
    K[2, 0, 0] = np.nan  # non-finite
    f = tkkt.factor(convert.tensor(K), KKT_SOLVER_LLT)
    want = [bool(jkkt.factor(jnp.asarray(K[s]), KKT_SOLVER_LLT).fail) for s in range(S)]
    assert f.fail.tolist() == want == [False, True, True, False]


def test_singular_schur_complement_fails():
    """An all-zero A_v gives a zero row and column in G: LLT must fail."""
    rng = np.random.default_rng(2)
    K = _spd(rng, 2, 4)
    K[0, 2, :] = 0.0
    K[0, :, 2] = 0.0
    f = tkkt.factor(convert.tensor(K), KKT_SOLVER_LLT)
    assert f.fail.tolist() == [True, False]
    assert bool(jkkt.factor(jnp.asarray(K[0]), KKT_SOLVER_LLT).fail)


def test_f64_island_on_f32_system_matches_jax():
    rng = np.random.default_rng(3)
    S, N = 3, 6
    K = _spd(rng, S, N).astype(np.float32)
    b = rng.uniform(-1, 1, (S, N)).astype(np.float32)
    island = tkkt.island_dtype("float64")
    assert island is torch.float64
    f = tkkt.factor(convert.tensor(K), KKT_SOLVER_LLT, island_dtype=island)
    x = tkkt.solve(f, convert.tensor(b), KKT_SOLVER_LLT, 1)
    assert f.factor.dtype == torch.float64 and x.dtype == torch.float32
    for s in range(S):
        jf = jkkt.factor(jnp.asarray(K[s]), KKT_SOLVER_LLT, island_dtype=jnp.float64)
        jx = jkkt.solve(jf, jnp.asarray(b[s]), KKT_SOLVER_LLT, 1)
        # Both solve in f64 and round the solution to f32.
        np.testing.assert_allclose(x[s].numpy(), np.asarray(jx), rtol=1e-6)


def test_unported_modes_raise_naming_roadmap_item():
    """The LDLT and QR modes are ported (the tests below), and so are the
    supernodal structures, the distributed ones included
    (tests/test_torch_supernodal.py, test_torch_distributed.py); an object
    that is no known structure raises TypeError, and an unknown mode or
    island type raises ValueError."""
    K = convert.tensor(np.eye(3)[None])
    for mode in (KKT_SOLVER_LDLT, KKT_SOLVER_QR):
        f = tkkt.factor(K, mode)
        assert not f.fail.any()
        x = tkkt.solve(f, convert.tensor(np.ones((1, 3))), mode)
        np.testing.assert_array_equal(x.numpy(), np.ones((1, 3)))
    with pytest.raises(TypeError, match="unknown supernodal structure"):
        tkkt.factor(K, KKT_SOLVER_LLT, structure=object())
    with pytest.raises(ValueError, match="unknown kkt solver mode"):
        tkkt.factor(K, 7)
    with pytest.raises(ValueError, match="unknown kkt solver mode"):
        tkkt.solve(tkkt.factor(K, KKT_SOLVER_LLT), K[:, 0], 7)
    with pytest.raises(ValueError):
        tkkt.island_dtype("int32")


# ---------------------------------------------------------------------------
# The clamped LDLT and QR (item 10)
# ---------------------------------------------------------------------------


def _saddle(rng, n):
    """The indefinite matrix the solver factors: [[G, E^T], [E, 0]] with
    G SPD (the Schur complement) and E the equality rows (n // 6 of them),
    with a rounding-level asymmetry in G as an assembled one has."""
    k = max(1, n // 6)
    p = n - k
    X = rng.standard_normal((p, p))
    K = np.zeros((n, n))
    K[:p, :p] = X @ X.T + np.eye(p) + 1e-13 * rng.uniform(-1, 1, (p, p))
    E = rng.standard_normal((k, p))
    K[p:, :p] = E
    K[:p, p:] = E.T
    return K


def _rel_tril(got, want):
    """Relative max error on the factor (the lower triangle and the
    diagonal; the JAX package leaves stale intermediates above it)."""
    got, want = np.tril(np.asarray(got)), np.tril(np.asarray(want))
    return np.abs(got - want).max() / np.abs(want).max()


ROUTES = {"scalar": (tkkt._ldlt_scalar, jkkt._ldlt_scalar),
          "blocked": (tkkt._ldlt_clamped, jkkt._ldlt_clamped)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("n", [5, 130, 300])
def test_ldlt_matches_jax_on_kkt_matrices(n, route):
    """Both routes at orders below, just above and well above the panel
    (128), on a batch of two saddle KKT matrices, to 1e-12 relative: the
    same fixed elimination order, each update one fused multiply-add per
    entry as XLA makes it, the panel products summed in another order."""
    rng = np.random.default_rng(n)
    K = np.stack([_saddle(rng, n) for _ in range(2)])
    tfn, jfn = ROUTES[route]
    M, fail = tfn(convert.tensor(K))
    for s in range(2):
        jM, jfail = jfn(jnp.asarray(K[s]))
        assert bool(fail[s]) == bool(jfail) is False
        assert _rel_tril(M[s].numpy(), jM) <= 1e-12
    # L D L^T reproduces K's lower triangle.
    L = np.tril(M.numpy(), -1) + np.eye(n)
    d = np.diagonal(M.numpy(), axis1=1, axis2=2)
    recon = np.einsum("sij,sj,skj->sik", L, d, L)
    assert np.abs(np.tril(recon - K)).max() <= 1e-10 * np.abs(K).max()


@pytest.mark.parametrize("n", [5, 130, 300])
def test_ldlt_matches_jax_on_random_symmetric(n):
    """tests/test_blocked_ldlt.py's inputs: a random symmetric matrix,
    factored without pivoting, grows its entries and amplifies every
    rounding.  The scalar route makes JAX's roundings and holds 1e-12;
    the blocked route's panel products sum in another order than XLA's,
    and is held to the bound the JAX package holds its own blocked route
    to against its scalar one there (1e-9 of the largest entry)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    K = 0.5 * (A + A.T)
    Ms, _ = tkkt._ldlt_scalar(convert.tensor(K)[None])
    assert _rel_tril(Ms[0].numpy(), jkkt._ldlt_scalar(jnp.asarray(K))[0]) <= 1e-12
    Mb, fail = tkkt._ldlt_clamped(convert.tensor(K)[None])
    jMb, jfail = jkkt._ldlt_clamped(jnp.asarray(K))
    assert not bool(fail[0]) and not bool(jfail)
    scale = np.abs(np.tril(np.asarray(jMb))).max()
    np.testing.assert_allclose(np.tril(Mb[0].numpy()), np.tril(np.asarray(jMb)),
                               rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("n", [6, 150])
def test_clamp_fires_in_one_scenario_and_not_the_other(n):
    """A structurally zero pivot at step 4 (n = 6, the scalar route) or 40
    (n = 150, the blocked route) in scenario 0 only: scenario 0's pivot is
    clamped to +/-1e-9, scenario 1's is not, and each matches its own JAX
    call."""
    rng = np.random.default_rng(3)
    K = np.stack([_saddle(rng, n) for _ in range(2)])
    j = 4 if n == 6 else 40
    K[0, j, :] = 0.0
    K[0, :, j] = 0.0
    M, fail = tkkt._ldlt_clamped(convert.tensor(K))
    d = np.diagonal(M.numpy(), axis1=1, axis2=2)
    assert abs(d[0, j]) == tkkt.LDLT_PIVOT_CLAMP == jkkt.LDLT_PIVOT_CLAMP
    assert abs(d[1, j]) > 1e-3
    for s in range(2):
        jM, jfail = jkkt._ldlt_clamped(jnp.asarray(K[s]))
        assert bool(fail[s]) == bool(jfail)
        np.testing.assert_allclose(np.tril(M[s].numpy()), np.tril(np.asarray(jM)),
                                   rtol=0, atol=1e-12 * np.abs(np.tril(np.asarray(jM))).max())


def test_clamp_sign_follows_the_pivot_and_zero_goes_up():
    """|d| < 1e-9: +1e-9 for an exact 0 and a tiny positive pivot, -1e-9
    for a tiny negative one (the JAX package's d >= 0 rule)."""
    K = np.zeros((3, 2, 2))
    K[:, 0, 1] = K[:, 1, 0] = 1.0
    K[1, 0, 0] = 3e-10
    K[2, 0, 0] = -3e-10
    M, _ = tkkt._ldlt_scalar(convert.tensor(K))
    d0 = M[:, 0, 0].tolist()
    assert d0 == [1e-9, 1e-9, -1e-9]
    assert d0 == [float(jkkt._ldlt_scalar(jnp.asarray(k))[0][0, 0]) for k in K]


def _system(mode, rng, S, N):
    if mode == KKT_SOLVER_LLT:
        return _spd(rng, S, N, asym=1e-13)
    return np.stack([_saddle(rng, N) for _ in range(S)])


@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("mode", [KKT_SOLVER_LLT, KKT_SOLVER_LDLT, KKT_SOLVER_QR])
def test_factor_solve_and_refinement_match_jax_in_every_mode(mode, refine):
    """factor + solve with 0 and 2 refinement steps, per scenario against
    the JAX call (rtol 1e-10), and the residual of the batch."""
    rng = np.random.default_rng(10 + mode)
    S, N = 3, 12
    K = _system(mode, rng, S, N)
    b = rng.uniform(-1, 1, (S, N))
    f = tkkt.factor(convert.tensor(K), mode)
    x = tkkt.solve(f, convert.tensor(b), mode, refine)
    assert not f.fail.any()
    for s in range(S):
        jf = jkkt.factor(jnp.asarray(K[s]), mode)
        jx = jkkt.solve(jf, jnp.asarray(b[s]), mode, refine)
        assert not bool(jf.fail)
        np.testing.assert_allclose(x[s].numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.einsum("sij,sj->si", K, x.numpy()), b, atol=1e-9)


def test_qr_factors_once_and_keeps_q_and_r():
    """factor() returns the (Q, R) pair, the JAX package's reduced QR, and
    never reports a failure, even on a singular matrix."""
    rng = np.random.default_rng(4)
    K = _saddle(rng, 8)[None].repeat(2, axis=0)
    K[1, 3, :] = K[1, :, 3] = 0.0
    f = tkkt.factor(convert.tensor(K), KKT_SOLVER_QR)
    q, r = f.factor
    assert q.shape == r.shape == (2, 8, 8) and not f.fail.any()
    for s in range(2):
        jq, jr = jkkt.factor(jnp.asarray(K[s]), KKT_SOLVER_QR).factor
        np.testing.assert_allclose(np.abs(np.diagonal(r[s].numpy())),
                                   np.abs(np.diagonal(np.asarray(jr))), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(q[s].numpy() @ r[s].numpy(), K[s], atol=1e-12)


def test_ldlt_island_casts_up_and_back():
    rng = np.random.default_rng(5)
    K = np.stack([_saddle(rng, 10) for _ in range(2)]).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 10)).astype(np.float32)
    f = tkkt.factor(convert.tensor(K), KKT_SOLVER_LDLT, island_dtype=torch.float64)
    x = tkkt.solve(f, convert.tensor(b), KKT_SOLVER_LDLT, 1)
    assert f.factor.dtype == torch.float64 and x.dtype == torch.float32
    for s in range(2):
        jf = jkkt.factor(jnp.asarray(K[s]), KKT_SOLVER_LDLT, island_dtype=jnp.float64)
        jx = jkkt.solve(jf, jnp.asarray(b[s]), KKT_SOLVER_LDLT, 1)
        np.testing.assert_allclose(x[s].numpy(), np.asarray(jx), rtol=1e-6)

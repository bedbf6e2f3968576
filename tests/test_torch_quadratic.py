"""The port's Q-weighted quadratic cone, quadratic cost and equality block
against conex_tpu, method by method, in f64.

The same numpy inputs, drawn from a seed, go through each JAX block one
scenario at a time and through the port's block as one batch of S
scenarios.  Tolerance: 1e-12 relative per output (the same closed-form
formulas and einsums, summed in other orders).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from conex_tpu.cones.equality import EqualityBlock as JEq
from conex_tpu.cones.qcost import QuadraticCost as JCost
from conex_tpu.cones.quadratic import QuadraticCone as JQuad
from conex_tpu.cones.quadratic import epigraph_cone_data as jepigraph

from conex_tpu_torch import convert
from conex_tpu_torch.cones.quadratic import QuadraticCone, epigraph_cone_data

S, B, N, V = 3, 4, 5, 3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(want).all():
        np.testing.assert_array_equal(got, want)
        return 0.0
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _assert_close(got, want, tol=1e-12):
    for g, r in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(r), (g.shape, np.shape(r))
        assert _rel(g, r) <= tol, (g, r)


def _stack(outs):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


def _interior(rng, *shape):
    """Points inside the Lorentz cone (x0 > |x1|)."""
    x = rng.uniform(-0.4, 0.4, shape + (N + 1,))
    x[..., 0] = np.linalg.norm(x[..., 1:], axis=-1) + rng.uniform(0.3, 1.0, shape)
    return x


def _cone_data(seed, weighted):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (S, B, N + 1, V))
    c = _interior(rng, S, B) + 1.0
    Q = None
    if weighted:
        X = rng.uniform(-1, 1, (S, B, N, N))
        Q = np.einsum("sbij,sbkj->sbik", X, X) / N + 0.5 * np.eye(N)
    w = _interior(rng, S, B)
    y0, y1 = rng.uniform(-0.2, 0.2, (2, S, V))
    return A, c, Q, w, y0, y1


def _jax_cones(A, c, Q):
    return [JQuad.build(jnp.asarray(A[s]), jnp.asarray(c[s]),
                        None if Q is None else jnp.asarray(Q[s]))
            for s in range(S)]


@pytest.mark.parametrize("weighted", [False, True])
def test_quadratic_cone_methods_match_jax(weighted):
    A, c, Q, w, y0, _ = _cone_data(1, weighted)
    cone = convert.quadratic_cone(A, c, Q)
    jcones = _jax_cones(A, c, Q)
    tw, ty = convert.tensor(w), convert.tensor(y0)
    cw = np.array([0.7, 1.3, 2.0])
    step = np.array([0.25, 0.5, 1.0])

    assert cone.rank() == jcones[0].rank() == 2 * B
    assert (cone.n, cone.num_vars, cone.batch, cone.scenarios) == (N, V, B, S)
    assert cone.supports_line_search is JQuad.supports_line_search is False
    assert cone.dual_scale == JQuad.dual_scale == 2.0
    _assert_close([cone.A_gram], [np.stack([np.asarray(j.A_gram) for j in jcones])])
    _assert_close([cone.identity_state(torch.float64)],
                  [_stack([j.identity_state(jnp.float64) for j in jcones])])
    _assert_close(cone.schur(tw), _stack([j.schur(jnp.asarray(w[s]))
                                          for s, j in enumerate(jcones)]))
    cache, ninf, nsq = cone.prepare_step(tw, ty, convert.tensor(cw), 1.0)
    jprep = [j.prepare_step(jnp.asarray(w[s]), jnp.asarray(y0[s]), cw[s], 1.0)
             for s, j in enumerate(jcones)]
    _assert_close(list(cache) + [ninf, nsq],
                  list(_stack([p[0] for p in jprep]))
                  + [_stack([p[1] for p in jprep]), _stack([p[2] for p in jprep])])
    _assert_close([cone.take_step(tw, cache, convert.tensor(step))], [_stack([
        j.take_step(jnp.asarray(w[s]), p[0], step[s])
        for s, (j, p) in enumerate(zip(jcones, jprep))])])
    _assert_close([cone.affine_step(tw, ty, 0.0)], [_stack([
        j.affine_step(jnp.asarray(w[s]), jnp.asarray(y0[s]), 0.0)
        for s, j in enumerate(jcones)])])
    _assert_close(cone.slack_stats(tw, ty, convert.tensor(cw)), _stack([
        j.slack_stats(jnp.asarray(w[s]), jnp.asarray(y0[s]), cw[s])
        for s, j in enumerate(jcones)]))
    _assert_close([cone.dual_variable(tw)], [w])


def test_quadratic_cone_spectral_of_a_scalar_point():
    """|x1|_Q = 0 takes the k = 0 branch of the spectral map (no division
    by zero), as in the JAX package."""
    A, c, Q, w, _, _ = _cone_data(2, True)
    w[:, 0, 1:] = 0.0
    cone = convert.quadratic_cone(A, c, Q)
    jcones = _jax_cones(A, c, Q)
    got = cone._spectral(torch.sqrt, convert.tensor(w[..., 0]), convert.tensor(w[..., 1:]))
    want = _stack([j._spectral(jnp.sqrt, jnp.asarray(w[s, :, 0]), jnp.asarray(w[s, :, 1:]))
                   for s, j in enumerate(jcones)])
    _assert_close(got, want)
    assert np.isfinite(got[1].numpy()).all()


def test_quadratic_cone_with_q_identity_is_the_plain_cone():
    """Q = I and Q = None are one cone: the same outputs to 1e-12."""
    A, c, _, w, y0, _ = _cone_data(3, False)
    eye = np.broadcast_to(np.eye(N), (S, B, N, N))
    plain, weighted = convert.quadratic_cone(A, c), convert.quadratic_cone(A, c, eye)
    tw, ty = convert.tensor(w), convert.tensor(y0)
    _assert_close(weighted.schur(tw), [x.numpy() for x in plain.schur(tw)])
    _assert_close(weighted.slack_stats(tw, ty, 1.0),
                  [x.numpy() for x in plain.slack_stats(tw, ty, 1.0)])


def test_quadratic_cost_methods_match_jax():
    """The cost contributes Q to G and is neutral everywhere else; its
    state is empty, (S, 0) in the port and (0,) per JAX program."""
    rng = np.random.default_rng(4)
    X = rng.uniform(-1, 1, (S, V, V))
    Q = np.einsum("sij,skj->sik", X, X) + np.eye(V)
    cost = convert.quadratic_cost(Q)
    jcosts = [JCost(Q=jnp.asarray(Q[s])) for s in range(S)]
    assert cost.rank() == jcosts[0].rank() == 0
    assert cost.is_cost is JCost.is_cost is True
    assert cost.supports_line_search is JCost.supports_line_search is True
    assert cost.dual_scale == JCost.dual_scale == 1.0
    w = cost.identity_state(torch.float64)
    assert w.shape == (S, 0)
    jw = [j.identity_state(jnp.float64) for j in jcosts]
    assert jw[0].shape == (0,)
    y0, y1 = convert.tensor(rng.uniform(-1, 1, (2, S, V)))
    _assert_close(cost.schur(w), _stack([j.schur(jw[s]) for s, j in enumerate(jcosts)]))
    cache, ninf, nsq = cost.prepare_step(w, y0, 1.0, 1.0)
    jprep = [j.prepare_step(jw[s], None, 1.0, 1.0) for s, j in enumerate(jcosts)]
    _assert_close([cache.d, ninf, nsq],
                  [_stack([p[0].d for p in jprep]), _stack([p[1] for p in jprep]),
                   _stack([p[2] for p in jprep])])
    assert cost.take_step(w, cache, 0.5) is w
    assert cost.affine_step(w, y0, 0.0) is w
    _assert_close(cost.slack_stats(w, y0, 1.0),
                  _stack([j.slack_stats(jw[s], None, 1.0) for s, j in enumerate(jcosts)]))
    _assert_close(cost.line_search(w, y0, y1, 0.0, 1.0, 1.0),
                  _stack([j.line_search(jw[s], None, None, 0.0, 1.0, 1.0)
                          for s, j in enumerate(jcosts)]))
    assert cost.dual_variable(w) is w


def test_equality_block_matches_jax():
    rng = np.random.default_rng(5)
    p, m = 2, 4
    A = rng.uniform(-1, 1, (S, p, V))
    b = rng.uniform(-1, 1, (S, p))
    blk = convert.equality_block(A, b, dual_offset=1)
    jblks = [JEq(A=jnp.asarray(A[s]), b=jnp.asarray(b[s]), dual_offset=1)
             for s in range(S)]
    assert (blk.p, blk.num_vars, blk.rank()) == (jblks[0].p, jblks[0].num_vars,
                                                 jblks[0].rank()) == (p, V, 0)
    y_full = rng.uniform(-1, 1, (S, m + 1 + p + 2))
    got = blk.dual_variable(convert.tensor(y_full), m)
    want = _stack([j.dual_variable(jnp.asarray(y_full[s]), m) for s, j in enumerate(jblks)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), y_full[:, m + 1:m + 1 + p])


@pytest.mark.parametrize("nz", [1, 3])
def test_epigraph_cone_data_matches_jax(nz):
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, (nz, nz))
    Qi = X @ X.T + np.eye(nz)
    got = epigraph_cone_data(convert.tensor(Qi))
    want = jepigraph(jnp.asarray(Qi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The encoding: (0.5 t + 1)^2 >= (0.5 t - 1)^2 + x'Qi x  <=>  2 t >= x'Qi x.
    Q, A, b = (g.numpy() for g in got)
    x, t = rng.uniform(-1, 1, nz), 3.0
    s = b - A @ np.append(x, t)
    assert s[0] ** 2 - s[1:] @ Q @ s[1:] == pytest.approx(2 * t - x @ Qi @ x)


def test_build_without_q_keeps_none():
    A, c, _, _, _, _ = _cone_data(7, False)
    cone = QuadraticCone.build(convert.tensor(A), convert.tensor(c))
    assert cone.Q is None and cone.A_gram.shape == (S, B, V, V)

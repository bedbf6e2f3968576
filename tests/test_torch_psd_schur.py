"""The dense LMI cone of the port (cones/psd.py, cones/psd_schur.py)
against conex_tpu.

``schur_plain`` carries a scenario axis; the JAX package's cone has none, so
each scenario is compared with its own JAX call.  Tolerances:

* f64 against the JAX einsum path: the same contractions summed in other
  orders, rtol 1e-12;
* f32 against the Pallas kernel in interpret mode: as
  tests/test_sdp.py::test_fused_schur_kernel_matches_einsum holds the
  kernel to the einsum path (rtol 2e-5 for sums of up to Bc*n^2 = 512 f32
  terms);
* prepare_step / take_step / slack_stats: exact twins apart from the f32
  eigenvector stages (see tests/test_torch_sym_mu.py), rtol 1e-6 on the
  warm eigenvalue estimates and what is built from them.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from conex_tpu.cones.psd import DenseLMICone as JCone, make_psd_state as jstate
from conex_tpu.cones.psd_pallas import schur_fused as pallas_schur
from conex_tpu_torch import convert
from conex_tpu_torch.cones import psd_schur
from conex_tpu_torch.cones.psd import make_psd_state as tstate


def _sym(rng, shape):
    X = rng.uniform(-1, 1, shape)
    return 0.5 * (X + np.swapaxes(X, -1, -2))


def _inputs(rng, S, Bc, m, n, dtype=np.float64):
    A = _sym(rng, (S, Bc, m, n, n))
    C = np.eye(n) + 0.1 * _sym(rng, (S, Bc, n, n))
    W = np.eye(n) + 0.05 * _sym(rng, (S, Bc, n, n))
    return A.astype(dtype), C.astype(dtype), W.astype(dtype)


def _jax_schur(A, C, W, s):
    out = JCone(A=jnp.asarray(A[s]), C=jnp.asarray(C[s])).schur(
        jstate(jnp.asarray(W[s]))
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n", [16, 13])
def test_schur_plain_matches_jax_einsum(n):
    rng = np.random.default_rng(0)
    S, Bc, m = 3, 2, 4
    A, C, W = _inputs(rng, S, Bc, m, n)
    got = [x.numpy() for x in psd_schur.schur_plain(*map(convert.tensor, (A, W, C)))]
    for s in range(S):
        want = _jax_schur(A, C, W, s)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[s], w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [16, 13])
def test_schur_plain_matches_pallas_kernel_interpret_f32(n):
    rng = np.random.default_rng(1)
    S, Bc, m = 3, 2, 4
    A, C, W = _inputs(rng, S, Bc, m, n, np.float32)
    got = [x.numpy() for x in psd_schur.schur_plain(*map(convert.tensor, (A, W, C)))]
    for s in range(S):
        want = pallas_schur(
            jnp.asarray(A[s]), jnp.asarray(W[s]), jnp.asarray(C[s]),
            interpret=True,
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[s], np.asarray(w), rtol=2e-5, atol=1e-4)


def test_schur_fused_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    A, C, W = map(convert.tensor, _inputs(rng, 2, 1, 3, 7))
    before = psd_schur.schur_kernel.launches
    got = psd_schur.schur_fused(A, W, C)
    want = psd_schur.schur_plain(A, W, C)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert psd_schur.schur_kernel.launches == before


def test_schur_kernel_refuses_cpu_tensors():
    rng = np.random.default_rng(3)
    A, C, W = map(convert.tensor, _inputs(rng, 1, 1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        psd_schur.schur_kernel(A, W, C)


def test_cone_schur_per_scenario_matches_jax():
    rng = np.random.default_rng(4)
    S, Bc, m, n = 3, 2, 4, 9
    A, C, W = _inputs(rng, S, Bc, m, n)
    cone = convert.lmi_cone(A, C)
    got = cone.schur(tstate(convert.tensor(W)))
    for s in range(S):
        want = _jax_schur(A, C, W, s)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[s].numpy(), w, rtol=1e-12, atol=1e-12)


def _mixed_states(rng, S, Bc, n, A, C, W):
    """PSD states where scenario 1 is cold (lam == 0) and the others carry
    warm seeds from a cold estimate: the per-scenario cold/warm choice."""
    jst = []
    for s in range(S):
        st = jstate(jnp.asarray(W[s]))
        if s != 1:
            cone = JCone(A=jnp.asarray(A[s]), C=jnp.asarray(C[s]))
            y = jnp.asarray(rng.uniform(-0.3, 0.3, A.shape[2]))
            cache, _, _ = cone.prepare_step(st, y, 0.7, 1.0)
            st = st._replace(
                vhi=cache.seeds[0], uhi=cache.seeds[1], vlo=cache.seeds[2],
                ulo=cache.seeds[3], lam=cache.lam,
            )
        jst.append(st)
    fields = [np.stack([np.asarray(st[f]) for st in jst]) for f in range(6)]
    return jst, convert.psd_state(fields)


def test_prepare_step_and_slack_stats_match_jax_mixed_cold_warm():
    rng = np.random.default_rng(5)
    S, Bc, m, n = 3, 2, 3, 8
    A, C, W = _inputs(rng, S, Bc, m, n)
    jst, tst = _mixed_states(rng, S, Bc, n, A, C, W)
    y = rng.uniform(-0.3, 0.3, (S, m))
    cw = rng.uniform(0.5, 1.5, S)
    cone = convert.lmi_cone(A, C)
    cache, norminf, normsq = cone.prepare_step(
        tst, convert.tensor(y), convert.tensor(cw), 1.0
    )
    stats = cone.slack_stats(tst, convert.tensor(y), convert.tensor(cw))
    for s in range(S):
        jc = JCone(A=jnp.asarray(A[s]), C=jnp.asarray(C[s]))
        jcache, jninf, jnsq = jc.prepare_step(jst[s], jnp.asarray(y[s]), cw[s], 1.0)
        np.testing.assert_allclose(cache.WS[s].numpy(), np.asarray(jcache.WS),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(cache.lam[s].numpy(), np.asarray(jcache.lam),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(norminf[s]), float(jninf), rtol=1e-6)
        np.testing.assert_allclose(float(normsq[s]), float(jnsq), rtol=1e-12)
        jstats = jc.slack_stats(jst[s], jnp.asarray(y[s]), cw[s])
        for g, w in zip(stats, jstats):
            np.testing.assert_allclose(float(g[s]), float(w), rtol=1e-6)


def test_take_step_and_affine_step_match_jax():
    rng = np.random.default_rng(6)
    S, Bc, m, n = 3, 2, 3, 8
    A, C, W = _inputs(rng, S, Bc, m, n)
    jst, tst = _mixed_states(rng, S, Bc, n, A, C, W)
    y = rng.uniform(-0.3, 0.3, (S, m))
    cw = rng.uniform(0.5, 1.5, S)
    cone = convert.lmi_cone(A, C)
    cache, norminf, _ = cone.prepare_step(tst, convert.tensor(y), convert.tensor(cw), 1.0)
    step = torch.clamp(2.0 / (norminf * norminf), max=1.0)
    new = cone.take_step(tst, cache, step)
    aff = cone.affine_step(tst, convert.tensor(y), 0.0)
    for s in range(S):
        jc = JCone(A=jnp.asarray(A[s]), C=jnp.asarray(C[s]))
        jcache, jninf, _ = jc.prepare_step(jst[s], jnp.asarray(y[s]), cw[s], 1.0)
        jnew = jc.take_step(jst[s], jcache, min(1.0, 2.0 / float(jninf) ** 2))
        # W moves by exp(step (WS + I)); the step size carries the warm
        # estimate's rtol 1e-6.
        np.testing.assert_allclose(new.w[s].numpy(), np.asarray(jnew.w),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(new.lam[s].numpy(), np.asarray(jnew.lam),
                                   rtol=1e-6)
        jaff = jc.affine_step(jst[s], jnp.asarray(y[s]), 0.0)
        np.testing.assert_allclose(aff.w[s].numpy(), np.asarray(jaff.w),
                                   rtol=1e-12, atol=1e-13)
    assert torch.equal(cone.dual_variable(new), new.w)


def test_identity_state_matches_jax():
    cone = convert.lmi_cone(np.zeros((2, 3, 1, 5, 5)), np.zeros((2, 3, 5, 5)))
    st = cone.identity_state(torch.float64)
    jst = JCone(A=jnp.zeros((3, 1, 5, 5)), C=jnp.zeros((3, 5, 5))).identity_state(
        jnp.float64
    )
    for t, j in zip(st, jst):
        assert t.shape[0] == 2 and t[1].is_contiguous()
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j))


# The kernel's plan (cones/psd_schur.py::schur_plan): (S, Bc, m, n, itemsize,
# SMs).  The main path's shape, one program of many cones, two Gram tiles
# with a ragged n, many cones in f64, a tiny shape, a card so small that
# the plan needs no partials, and a batch whose panel takes two chunks.
PLAN_SHAPES = [(256, 1, 50, 100, 4, 132), (1, 256, 50, 100, 4, 132),
               (3, 2, 70, 130, 4, 132), (2, 64, 20, 100, 8, 132),
               (3, 2, 4, 13, 8, 132), (5, 1, 6, 9, 4, 1),
               (600, 1, 50, 100, 4, 132)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_schur_plan_covers_every_block_once(shape):
    """Every (scenario, cone, tile of M, depth chunk) is one Gram block,
    the depth chunks' units are every pair (I, K), I <= K, of UNIT-wide
    blocks once, and the chunks hold every cone once."""
    S, Bc, m, n, itemsize, sms = shape
    plan = psd_schur.schur_plan(S, Bc, m, n, itemsize, sms)
    blocks = plan.gram_blocks()
    tiles = -(-(m + 1) // psd_schur.GRAM_TILE)
    want = {(s, b, tv, tu, d) for s in range(S) for b in range(Bc)
            for tv in range(tiles) for tu in range(tiles)
            for d in range(plan.depth_chunks)}
    assert len(blocks) == len(set(blocks)) == len(want)
    assert set(blocks) == want
    nb = -(-n // psd_schur.UNIT)
    units = [u for d in range(plan.depth_chunks) for u in plan.depth_units(d)]
    assert units == [(i, k) for i in range(nb) for k in range(i, nb)]
    assert all(plan.depth_units(d) for d in range(plan.depth_chunks))
    counts = [plan.chunk_cones(c) for c in range(plan.chunks)]
    assert [c0 for c0, _ in counts] == [c * plan.cones_per_chunk
                                        for c in range(plan.chunks)]
    assert sum(k for _, k in counts) == S * Bc
    assert all(0 < k <= plan.cones_per_chunk for _, k in counts)
    plan.check()


@pytest.mark.parametrize("shape,want", [
    # Bench shape, f32: the whole panel (256 cones of 51 x 104^2 floats,
    # 565 MB) in one chunk; two depth chunks of 46 units give 512 blocks.
    ((256, 1, 50, 100, 4, 132),
     dict(cones_per_chunk=256, chunks=1, tiles=1, units=91, depth_chunks=2,
          units_per_chunk=46, scratch_shape=(256, 51, 104, 104),
          partial_shape=(512, 2652), launches=3, direct=False)),
    # One program of 256 cones: the same split, one scenario to reduce.
    ((1, 256, 50, 100, 4, 132),
     dict(cones_per_chunk=256, chunks=1, depth_chunks=2,
          partial_shape=(512, 2652), launches=3)),
    # m + 1 = 71: four tiles of M; n = 130: 17 blocks, 153 units.
    ((3, 2, 70, 130, 4, 132),
     dict(cones_per_chunk=6, tiles=2, units=153, depth_chunks=17,
          units_per_chunk=9, scratch_shape=(6, 71, 136, 136),
          partial_shape=(102, 5112), launches=3)),
    # Many cones of m = 20 in f64: four depth chunks of 23 units.
    ((2, 64, 20, 100, 8, 132),
     dict(cones_per_chunk=128, chunks=1, depth_chunks=4, units_per_chunk=23,
          scratch_shape=(128, 21, 104, 104), partial_shape=(512, 462),
          launches=3)),
    # Tiny: three units, one per depth chunk.
    ((3, 2, 4, 13, 8, 132),
     dict(cones_per_chunk=6, chunks=1, units=3, depth_chunks=3,
          units_per_chunk=1, scratch_shape=(6, 5, 16, 16),
          partial_shape=(18, 30), launches=3)),
    # Bc = 1, one depth chunk, one tile: outputs written directly.
    ((5, 1, 6, 9, 4, 1),
     dict(cones_per_chunk=5, chunks=1, depth_chunks=1, units_per_chunk=3,
          partial_shape=(0, 0), launches=2, direct=True)),
    # 600 panels of 2.2 MB exceed the 1 GiB scratch: two chunks, direct.
    ((600, 1, 50, 100, 4, 132),
     dict(cones_per_chunk=486, chunks=2, depth_chunks=1, launches=4,
          direct=True)),
])
def test_schur_plan_sizes(shape, want):
    plan = psd_schur.schur_plan(*shape)
    for name, value in want.items():
        assert getattr(plan, name) == value, name
    S, Bc, m, n, itemsize, _ = shape
    scratch = np.prod(plan.scratch_shape) * itemsize
    assert plan.cones_per_chunk == 1 or scratch <= psd_schur.SCRATCH_BYTES


def test_schur_plan_refuses_grids_beyond_cuda():
    with pytest.raises(ValueError, match="launch grid"):
        psd_schur.schur_plan(1, 1, 2000, 4, 4).check()


def _tf32(x):
    """float32 rounded to TF32 as the kernel rounds (cvt.rna.tf32.f32): to
    nearest on the 13 dropped mantissa bits, ties away from zero."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _tc_product(a, b, passes):
    """a @ b as the kernel's f32 tensor-core products: hi = tf32(x), lo =
    tf32(x - hi); three passes add lo hi + hi lo + hi hi, one pass hi hi;
    products exact, sums in f32."""
    ahi, bhi = _tf32(a), _tf32(b)
    if passes == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _emulated_schur(A, W, C, passes):
    """The kernel's numerical design in f32: the panel P_v = Op_v W and E
    over (i, k) pairs, both through _tc_product; E symmetrized, as the
    kernel forms it as M + M^T."""
    S, Bc, m, n, _ = A.shape
    ops = torch.cat([A, C[:, :, None]], dim=2)  # C as operator m
    P = _tc_product(ops, W[:, :, None], passes)  # (S, Bc, m+1, n, n)
    X = P.reshape(S, Bc, m + 1, n * n)
    Y = P.transpose(-1, -2).reshape(S, Bc, m + 1, n * n)
    E = _tc_product(X, Y.transpose(-1, -2), passes).sum(1)
    E = 0.5 * (E + E.transpose(-1, -2))
    tr = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1).sum(1)
    return E[:, :m, :m], tr[:, :m], E[:, :m, m], tr[:, m], E[:, m, m]


@pytest.mark.parametrize("passes,reaches", [(3, True), (1, False)])
def test_tf32_split_reaches_f64_and_one_pass_does_not(passes, reaches):
    """Three TF32 passes come within 1e-5 of the f64 oracle (relative
    Frobenius error per output); one pass does not."""
    rng = np.random.default_rng(8)
    A, C, W = map(convert.tensor, _inputs(rng, 2, 3, 5, 24))
    want = psd_schur.schur_plain(A, W, C)
    got = _emulated_schur(A.float(), W.float(), C.float(), passes)
    err = max(float(torch.linalg.vector_norm(g.double() - w)
                    / torch.linalg.vector_norm(w)) for g, w in zip(got, want))
    assert (err <= 1e-5) == reaches, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(3, 2, 4, 13), (2, 64, 20, 100)])
def test_schur_kernel_matches_plain_on_card(dtype, tol, shape):
    """The CUDA kernel against schur_plain on the card (relative Frobenius
    error; f32 against the f64 plain version), at a small shape and at one
    of many cones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7)
    A, C, W = (convert.tensor(x, "cuda") for x in _inputs(rng, *shape))
    before = psd_schur.schur_kernel.launches
    got = psd_schur.schur_fused(A.to(dtype), W.to(dtype), C.to(dtype))
    torch.cuda.synchronize()
    assert psd_schur.schur_kernel.launches == before + 1
    want = psd_schur.schur_plain(A, W, C)
    for g, w in zip(got, want):
        err = torch.linalg.vector_norm(g.double() - w) / torch.linalg.vector_norm(w)
        assert float(err) <= tol

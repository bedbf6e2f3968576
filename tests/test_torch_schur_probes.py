"""The port's Schur-phase probes (conex_tpu_torch/benchmarks/) against the
JAX probes in benchmarks/dev_pallas_probe.py and dev_tpu_probe2.py.

The JAX probe modules are loaded by path (benchmarks/ is not a package).
The same numpy inputs, made as the probes make them, go to both packages.
Tolerances:

* f64, each plain version against the JAX ``einsum_schur``, the oracle of
  both probes: rtol 1e-12 (the same contractions summed in other orders);
* f32, each plain version against its Pallas kernel in interpret mode: as
  tests/test_torch_psd_schur.py holds K1's plain version to its kernel
  (rtol 2e-5, atol 1e-4, for sums of up to n^2 = 169 f32 terms per cone).

The Pallas kernels run in interpret mode through a stand-in for the
probes' ``pl`` whose ``pallas_call`` passes ``interpret=True``; the JAX
files are not touched.  K4 is the exception: ``fused_b`` builds At
(dev_pallas_probe.py:154) but hands A to its pallas_call (:180), which
gives NaN, so the test calls ``_kernel_b`` through a pallas_call of its own
with the At operand and the specs of :155-179.

Nonsymmetric inputs (uniform A, W and C) tell the two functions apart:
K3/K6 compute the oracle's tr(A_v W A_u W), K4/K5 their TPU kernels'
tr(A_v W A_u^T W^T), which the K4/K5 kernels regroup (held in f64 at
1e-12 by a test-local einsum of that regrouping).

The CUDA kernels are held against the plain versions by the ``gpu`` test
below and by chip_smoke.py phase 3c on the card.
"""

import functools
import importlib.util
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from conex_tpu_torch import convert
from conex_tpu_torch.benchmarks import dev_pallas_probe as tp1
from conex_tpu_torch.benchmarks import dev_tpu_probe2 as tp2

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(3, 5, 7), (3, 5, 13)]
VARIANTS = ["a", "b", "b2", "a2"]  # K3, K4, K5, K6


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jp1 = _load("dev_pallas_probe")
jp2 = _load("dev_tpu_probe2")


def _port(variant):
    module = tp2 if variant.endswith("2") else tp1
    return (getattr(module, f"fused_{variant}"),
            getattr(module, f"fused_{variant}_plain"),
            getattr(module, f"fused_{variant}_kernel"))


def _inputs(shape, dtype):
    """The probes' inputs (dev_pallas_probe.py:211-217) as numpy."""
    B, m, n = shape
    return tuple(x.numpy().astype(dtype) for x in tp1.probe_inputs(B, m, n, "cpu"))


def _nonsymmetric(shape, dtype, seed=7):
    """A, W and C uniform on [-1, 1]: no symmetry anywhere."""
    B, m, n = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(dtype)
                 for s in ((B, m, n, n), (B, n, n), (B, n, n)))


def _rel(got, want):
    """Relative Frobenius error, as chip_smoke.py measures it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def interpret(monkeypatch):
    shim = types.SimpleNamespace(**vars(pl))
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jp1, "pl", shim)
    monkeypatch.setattr(jp2, "pl", shim)


def _kernel_b_on_at(A, w, C):
    """``_kernel_b`` through a pallas_call given At, with the padding and
    specs of dev_pallas_probe.py:148-182, in interpret mode."""
    B, m, n, _ = A.shape
    np_ = jp1._round_up(n, 128)
    A = jnp.pad(A, ((0, 0), (0, 0), (0, np_ - n), (0, np_ - n)))
    w = jnp.pad(w, ((0, 0), (0, np_ - n), (0, np_ - n)))
    C = jnp.pad(C, ((0, 0), (0, np_ - n), (0, np_ - n)))
    At = jnp.swapaxes(A, 1, 2)
    vmem = pltpu.VMEM
    out = pl.pallas_call(
        jp1._kernel_b,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, np_, m, np_), lambda b: (b, 0, 0, 0), memory_space=vmem),
            pl.BlockSpec((1, np_, np_), lambda b: (b, 0, 0), memory_space=vmem),
            pl.BlockSpec((1, np_, np_), lambda b: (b, 0, 0), memory_space=vmem),
        ],
        out_specs=[
            pl.BlockSpec((m, m), lambda b: (0, 0), memory_space=vmem),
            pl.BlockSpec((1, m), lambda b: (0, 0), memory_space=vmem),
            pl.BlockSpec((1, m), lambda b: (0, 0), memory_space=vmem),
            pl.BlockSpec((1, 1), lambda b: (0, 0), memory_space=vmem),
            pl.BlockSpec((1, 1), lambda b: (0, 0), memory_space=vmem),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((m, m), A.dtype),
            jax.ShapeDtypeStruct((1, m), A.dtype),
            jax.ShapeDtypeStruct((1, m), A.dtype),
            jax.ShapeDtypeStruct((1, 1), A.dtype),
            jax.ShapeDtypeStruct((1, 1), A.dtype),
        ],
        interpret=True,
    )(At, w, C)
    G, AW, AQc, wc, cqc = out
    return G, AW[0], AQc[0], wc[0, 0], cqc[0, 0]


def _pallas(variant):
    return {"a": jp1.fused_a, "b": _kernel_b_on_at, "b2": jp2.fused_b2,
            "a2": jp2.fused_a2}[variant]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_jax_einsum_f64(variant, shape):
    A, w, C = _inputs(shape, np.float64)
    want = jp1.einsum_schur(jnp.asarray(A), jnp.asarray(w), jnp.asarray(C))
    got = _port(variant)[1](*map(convert.tensor, (A, w, C)))
    assert len(got) == 5
    for g, r in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_kernel_interpret_f32(variant, shape, interpret):
    A, w, C = _inputs(shape, np.float32)
    want = _pallas(variant)(jnp.asarray(A), jnp.asarray(w), jnp.asarray(C))
    got = _port(variant)[1](*map(convert.tensor, (A, w, C)))
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=1e-4)


def test_the_jax_fused_b_hands_its_kernel_a_not_at(interpret):
    """Why K4 is held through _kernel_b_on_at: the JAX wrapper's own call
    gives NaN, the kernel on At agrees with the oracle."""
    A, w, C = map(jnp.asarray, _inputs((3, 5, 7), np.float32))
    assert not np.isfinite(np.asarray(jp1.fused_b(A, w, C)[0])).all()
    G = np.asarray(_kernel_b_on_at(A, w, C)[0])
    np.testing.assert_allclose(G, np.asarray(jp1.einsum_schur(A, w, C)[0]),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_tensors_take_the_plain_version_and_errors_raise(variant):
    fused, plain, kernel = _port(variant)
    A, w, C = map(convert.tensor, _inputs((2, 3, 5), np.float64))
    before = kernel.launches
    for g, r in zip(fused(A, w, C), plain(A, w, C)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel(A, w, C)
    with pytest.raises(ValueError, match="device meta"):
        fused(*(x.to("meta") for x in (A, w, C)))
    with pytest.raises(ValueError, match=r"A must be \(B, m, n, n\)"):
        fused(A.transpose(1, 2)[:, :, :3], w, C)  # not square in its last two axes
    with pytest.raises(ValueError, match="w and C must be"):
        fused(A, w[:1], C)
    with pytest.raises(TypeError, match="dtypes differ"):
        fused(A, w.float(), C)
    assert kernel.launches == before


def test_probe_main_runs_on_cpu(capsys):
    tp1.main(["3,5,13", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "shape B=3 m=5 n=13, device=cpu"
    assert lines[1].startswith("einsum oracle: best=")
    assert [line.split(":")[0] for line in lines[2:]] == [
        "fused_a (one big product, A layout)",
        "fused_b (batch-leading products, At layout)"]
    assert all(": OK rel_errs=" in line for line in lines[2:])


def test_probe2_part2_runs_on_cpu_and_part1_raises(capsys):
    tp2.part2(device="cpu", shape=(3, 5, 7))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "part2 shape B=3 m=5 n=7, device=cpu"
    assert [line.split(":")[0] for line in lines[2:]] == ["fused_b2", "fused_a2"]
    assert all(": OK rel_errs=" in line for line in lines[2:])
    for call in (tp2.part1, lambda: tp2.main(["part1", "--device", "cpu"])):
        with pytest.raises(NotImplementedError, match="Not to port"):
            call()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_kernel_interpret_nonsymmetric_f32(variant, shape,
                                                                interpret):
    A, w, C = _nonsymmetric(shape, np.float32)
    want = _pallas(variant)(jnp.asarray(A), jnp.asarray(w), jnp.asarray(C))
    got = _port(variant)[1](*map(convert.tensor, (A, w, C)))
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_nonsymmetric_inputs_separate_the_two_functions(variant):
    """K3/K6 keep the oracle's function for any input; K4/K5's G is
    tr(A_v W A_u^T W^T) and leaves it where A and W are not symmetric,
    while their AW, AQc, wc and cqc stay the oracle's (f64)."""
    A, w, C = _nonsymmetric((3, 5, 13), np.float64)
    want = jp1.einsum_schur(jnp.asarray(A), jnp.asarray(w), jnp.asarray(C))
    got = _port(variant)[1](*map(convert.tensor, (A, w, C)))
    start = 1 if variant.startswith("b") else 0
    for g, r in zip(got[start:], want[start:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
    if start:
        assert _rel(got[0].numpy(), want[0]) > 0.1


def _regrouped(A, w, C):
    """K4's function as its kernels regroup it (csrc/schur_probes.cu)."""
    wt = np.swapaxes(w, 1, 2)
    M = wt[:, None] @ A @ w[:, None]  # W^T A_v W
    N = np.swapaxes(w @ C @ w, 1, 2)  # (W C W)^T
    return (np.einsum("bvij,buij->vu", M, A), np.einsum("bvij,bji->v", A, w),
            np.einsum("bvij,bij->v", A, N), np.einsum("bij,bji->", C, w),
            np.einsum("bij,bij->", C, N))


@pytest.mark.parametrize("shape", [(3, 5, 13), (2, 70, 130)])
@pytest.mark.parametrize("variant", ["b", "b2"])
def test_regrouped_products_equal_the_at_layout_function(variant, shape):
    A, w, C = _nonsymmetric(shape, np.float64)
    got = _port(variant)[1](*map(convert.tensor, (A, w, C)))
    for g, r in zip(got, _regrouped(A, w, C)):
        assert _rel(g.numpy(), r) <= 1e-12


PLAN_SHAPES = [(256, 50, 100), (2, 70, 130), (3, 5, 13)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_at_plan_covers_every_cone_and_the_whole_depth_once(shape, itemsize):
    B, m, n = shape
    plan = tp1.probe_at_plan(B, m, n, itemsize)
    plan.check()
    # The shared route holds W split and two n x n buffers: f32 to n = 112,
    # f64 to n = 96.
    assert plan.route == ("shared" if n <= (112 if itemsize == 4 else 96)
                          else "device")
    assert plan.shared_bytes <= tp1.SHARED_BYTES
    blocks = plan.gram_blocks()
    assert len(blocks) == len(set(blocks))
    assert set(blocks) == {(b, d, t) for b in range(B)
                           for d in range(plan.depth_chunks)
                           for t in range(plan.tiles)}
    # The depth chunks tile [0, n^2) in order, none empty.
    ranges = [plan.depth_range(d) for d in range(plan.depth_chunks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n * n
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # The chunks of cones cover the batch, each under the scratch cap.
    assert sum(plan.chunk_cones(c)[1] for c in range(plan.chunks)) == B
    chunk = math.prod(plan.scratch_shape) + (math.prod(plan.t_shape) if plan.t_shape else 0)
    assert chunk * itemsize <= tp1.SCRATCH_BYTES
    assert plan.partial_shape == (B * plan.depth_chunks, (m + 2) * (m + 1))
    assert plan.launches == plan.chunks * (2 if plan.route == "shared" else 3) + 1


@pytest.mark.parametrize("itemsize, largest", [(4, 112), (8, 96)])
def test_at_plan_shared_route_ends_where_the_buffers_outgrow_a_block(itemsize,
                                                                     largest):
    assert tp1.at_shared_bytes(largest, itemsize) <= tp1.SHARED_BYTES
    assert tp1.at_shared_bytes(largest + 1, itemsize) > tp1.SHARED_BYTES
    assert tp1.probe_at_plan(2, 3, largest, itemsize).route == "shared"
    assert tp1.probe_at_plan(2, 3, largest + 1, itemsize).route == "device"


def test_at_plan_at_the_probe_shape():
    plan = tp1.probe_at_plan(256, 50, 100, 4)
    assert (plan.route, plan.cones_per_chunk, plan.depth_chunks) == ("shared", 256, 2)
    assert plan.launches == 3
    assert 2.0e9 < plan.traffic_bytes() < 2.2e9  # A twice, Y written and read
    f64 = tp1.probe_at_plan(256, 50, 100, 8)
    assert f64.route == "device" and f64.chunks == 2  # Y and T: 2.11 GB
    forced = tp1.probe_at_plan(256, 50, 100, 4, route="device")
    assert forced.chunks == 1 and forced.launches == 4  # Y and T: 1.05 GB
    with pytest.raises(ValueError, match="shared route does not hold n = 130"):
        tp1.probe_at_plan(2, 70, 130, 4, route="shared")
    with pytest.raises(ValueError, match="unknown route"):
        tp1.probe_at_plan(2, 5, 13, 4, route="global")


@pytest.mark.parametrize("shape, route", [((3, 5, 13), "shared"),
                                          ((3, 5, 13), "device"),
                                          ((2, 70, 130), "device")])
def test_at_plan_emulated_gives_the_at_layout_function(shape, route):
    """The kernels' data flow in plain numpy under the plan: Y's rows per
    cone, E's partials per (cone, depth chunk) summed in row order, and the
    reduce's map from E to the five outputs (f64, against fused_b_plain)."""
    A, w, C = _nonsymmetric(shape, np.float64)
    B, m, n = shape
    plan = tp1.probe_at_plan(B, m, n, 8, route=route)
    wt = np.swapaxes(w, 1, 2)
    Y = np.concatenate([wt[:, None] @ A @ w[:, None], wt[:, None],
                        np.swapaxes(w @ C @ w, 1, 2)[:, None]], 1)
    X = np.concatenate([A, C[:, None]], 1)
    Y, X = Y.reshape(B, m + 2, n * n), X.reshape(B, m + 1, n * n)
    part = np.zeros(plan.partial_shape)
    for b, d, _ in plan.gram_blocks():
        lo, hi = plan.depth_range(d)
        part[b * plan.depth_chunks + d] = (Y[b, :, lo:hi] @ X[b, :, lo:hi].T).ravel()
    E = part.sum(0).reshape(m + 2, m + 1)
    got = (E[:m, :m], E[m, :m], E[m + 1, :m], E[m, m], E[m + 1, m])
    want = tp1.fused_b_plain(*map(convert.tensor, (A, w, C)))
    for g, r in zip(got, want):
        assert _rel(g, r.numpy()) <= 1e-12


def _chip_smoke():
    import sys
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_rel_err_fails_on_nan():
    """A NaN output gives a NaN error, which no limit passes (max(0, nan)
    would give 0)."""
    rel_err = _chip_smoke().rel_err
    want = (torch.ones(3), torch.full((2,), 2.0))
    assert rel_err(want, want) == 0.0
    assert abs(rel_err((torch.ones(3) * 1.5, want[1]), want) - 0.5) < 1e-15
    err = rel_err((torch.tensor([1.0, float("nan"), 1.0]), want[1]), want)
    assert err != err and not err <= 1e-12


def test_schur_bound_counts_the_at_layout_function():
    chip_smoke = _chip_smoke()
    B, m, n = chip_smoke.PROBE_SHAPE
    at = chip_smoke.schur_bound(B, 1, m, n, tensor_cores=True, at_layout=True)
    assert at["bound_by"] == "operations"
    assert abs(at["bound_ms"] - 0.397) < 0.001  # 65.5 GFLOP, 3 TF32 passes
    k1 = chip_smoke.schur_bound(B, 1, m, n, tensor_cores=True)
    assert abs(k1["bound_ms"] - 0.199) < 0.001


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["probe", "nonsymmetric"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_on_card(variant, inputs):
    """Each CUDA kernel against its plain version on the card (relative
    Frobenius error: f64 <= 1e-12; f32 against the f64 plain version <= 1e-4,
    as chip_smoke.py phase 3c), on the probes' inputs and on nonsymmetric
    ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fused, plain, kernel = _port(variant)
    make = _inputs if inputs == "probe" else _nonsymmetric
    A, w, C = (convert.tensor(x, "cuda") for x in make((3, 5, 13), np.float64))
    want = plain(A, w, C)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        before = kernel.launches
        got = fused(A.to(dtype), w.to(dtype), C.to(dtype))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for g, r in zip(got, want):
            assert g.dtype == dtype and g.shape == r.shape
            err = torch.linalg.vector_norm(g.double() - r) / torch.linalg.vector_norm(r)
            assert float(err) <= tol

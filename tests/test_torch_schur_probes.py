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

The CUDA kernels are held against the plain versions by the ``gpu`` test
below and by chip_smoke.py phase 3c on the card.
"""

import functools
import importlib.util
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


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_on_card(variant):
    """Each CUDA kernel against its plain version on the card (relative
    Frobenius error: f64 <= 1e-12; f32 against the f64 plain version <= 1e-4,
    as chip_smoke.py phase 3c)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fused, plain, kernel = _port(variant)
    A, w, C = (convert.tensor(x, "cuda") for x in _inputs((3, 5, 13), np.float64))
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

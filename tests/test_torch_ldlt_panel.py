"""The clamped LDLT's column steps (solver/kkt.py): the plain torch loop on
a CPU tensor, csrc/ldlt.cu's kernel on a CUDA tensor, and the wrapper's
checks, which raise before anything is built or launched.  The card-only
cases hold the kernel to the plain loop to the bit; they skip without a
card."""

import pytest
import torch

from conex_tpu_torch import _build
from conex_tpu_torch.solver import kkt
from conex_tpu_torch.utils.profiling import counters

COUNTERS = ("kkt.ldlt.calls", "kkt.ldlt.columns", "kkt.ldlt.kernel_columns",
            "kkt.ldlt.panel_launches")


def _moved(before):
    return {k: counters[k] - before.get(k, 0) for k in COUNTERS}


def _indefinite(S, n, seed, dtype=torch.float64, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, dtype=torch.float64, device=device)
    X = torch.randn(S, n, n, **kw)
    signs = torch.where(torch.rand(S, n, **kw) < 0.5, -1.0, 1.0)
    return (X + X.transpose(-2, -1) + torch.diag_embed(n * signs)).to(dtype)


def _same_bits(got, want):
    nan = got.isnan()
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}[got.dtype]
    return (got.dtype == want.dtype and torch.equal(nan, want.isnan())
            and torch.equal(got.masked_fill(nan, 0).view(bits),
                            want.masked_fill(nan, 0).view(bits)))


@pytest.fixture
def no_build(monkeypatch):
    """Fails the test if the kernel library is built (so nothing launches)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("route,n", [("scalar", 7), ("scalar", 130), ("blocked", 300)])
def test_a_cpu_tensor_takes_the_plain_loop(no_build, route, n):
    """On the CPU the factor is the plain loop's: no kernel column or launch
    is counted, and kkt.ldlt.columns counts every column as before."""
    K = _indefinite(3, n, n)
    fn = kkt._ldlt_scalar if route == "scalar" else kkt._ldlt_clamped
    before = dict(counters)
    M, fail = fn(K)
    assert _moved(before) == {"kkt.ldlt.calls": 1, "kkt.ldlt.columns": n,
                              "kkt.ldlt.kernel_columns": 0, "kkt.ldlt.panel_launches": 0}
    # The first square's steps, as the plain loop takes them alone.
    w = n if route == "scalar" else kkt.LDLT_PANEL
    want = K.clone()
    kkt._factor_columns_plain(want, 0, w)
    assert _same_bits(M[:, :w, :w], want[:, :w, :w])
    assert not fail.any()


def test_the_factor_hands_the_column_steps_a_contiguous_matrix(monkeypatch):
    """A transposed K is copied to a contiguous M before the column steps,
    which the kernel needs; the factor is that of the contiguous K."""
    seen = []
    steps = kkt._factor_columns

    def record(M, lo, hi):
        seen.append(M.is_contiguous())
        steps(M, lo, hi)

    monkeypatch.setattr(kkt, "_factor_columns", record)
    K = _indefinite(2, 200, 1)
    for fn in (kkt._ldlt_clamped, kkt._ldlt_scalar):
        got, _ = fn(K.transpose(-2, -1))
        want, _ = fn(K.transpose(-2, -1).contiguous())
        assert _same_bits(got, want)
    assert seen and all(seen)


@pytest.mark.parametrize("case", ["transposed", "sliced", "float16", "int64", "complex128",
                                  "two_dims", "not_square", "lo_negative", "hi_past_n",
                                  "empty_range", "cpu"])
def test_the_kernel_wrapper_raises_before_it_launches(no_build, case):
    M = _indefinite(2, 16, 2)
    lo, hi = 0, 16
    err = ValueError
    if case == "transposed":
        M = M.transpose(-2, -1)
    elif case == "sliced":
        M = torch.zeros(2, 16, 20, dtype=torch.float64)[:, :, :16]
    elif case in ("float16", "int64", "complex128"):
        M, err = M.to(getattr(torch, case)), TypeError
    elif case == "two_dims":
        M = M[0]
    elif case == "not_square":
        M = M[:, :15, :].contiguous()
    elif case == "lo_negative":
        lo = -1
    elif case == "hi_past_n":
        hi = 17
    elif case == "empty_range":
        lo = hi = 4
    before = dict(counters)
    with pytest.raises(err):
        kkt._factor_columns_kernel(M, lo, hi)
    assert _moved(before) == dict.fromkeys(COUNTERS, 0)


def test_a_device_without_column_steps_raises():
    M = torch.empty(2, 8, 8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        kkt._factor_columns(M, 0, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [50, 128])
def test_the_kernel_equals_the_plain_loop_on_card(dtype, n):
    """chip_smoke.py phase 4j's check at widths 50 and 128: all of M and
    the fail flags equal to the bit, with a zero, a clamped and a NaN
    pivot planted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K = _indefinite(8, n, n, device="cuda")
    for s, value in enumerate((0.0, 5e-10, -5e-10, float("nan"))):
        p = (s + 1) * n // 5
        K[s, p, :] = 0.0
        K[s, :, p] = 0.0
        K[s, p, p] = value
    K = K.to(dtype).contiguous()
    before = dict(counters)
    got, got_fail = kkt._ldlt_scalar(K)
    assert _moved(before)["kkt.ldlt.kernel_columns"] == n
    want = K.clone()
    kkt._factor_columns_plain(want, 0, n)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert torch.equal(got_fail, ~torch.isfinite(want).all(dim=(-2, -1)))
    assert got_fail.tolist() == [False, False, False, True, False, False, False, False]

import torch

from portbench.reference.sdp import relative_gap
from portbench.problems.dense_sdp import make_chunk
from portbench.workload import chunk_seed


def test_the_same_seed_makes_the_same_programs():
    a = make_chunk(3_000_000_019, 1, 3, 6, 5, torch.float64, "cpu")
    b = make_chunk(3_000_000_019, 1, 3, 6, 5, torch.float64, "cpu")
    c = make_chunk(3_000_000_019, 2, 3, 6, 5, torch.float64, "cpu")
    d = make_chunk(3_000_000_020, 1, 3, 6, 5, torch.float64, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    assert 0 <= chunk_seed(2**40, 7) < 2**63


def test_programs_are_feasible_and_bounded():
    A, C, b = make_chunk(11, 0, 4, 7, 9, torch.float64, "cpu")
    assert torch.equal(A, A.transpose(-2, -1)) and A.abs().max() <= 1.0
    assert torch.equal(C, torch.eye(7).expand(4, 7, 7).double())
    # b = A(X0) for an X0 > 0 (dual strictly feasible); y = 0 leaves the
    # slack C = I > 0 (primal strictly feasible), so both have optima.
    gen = torch.Generator().manual_seed(chunk_seed(11, 0))
    torch.rand((4, 9, 7, 7), generator=gen, dtype=torch.float64)
    Y = torch.rand((4, 7, 7), generator=gen, dtype=torch.float64) * 2 - 1
    X0 = Y @ Y.transpose(-2, -1) + 0.1 * torch.eye(7, dtype=torch.float64)
    assert torch.linalg.eigvalsh(X0).min() >= 0.1 - 1e-12
    assert torch.allclose(b, torch.einsum("gvij,gij->gv", A, X0), rtol=1e-12, atol=1e-12)


def test_float32_programs_are_the_rounded_float64_ones():
    A64, _, b64 = make_chunk(5, 0, 2, 4, 3, torch.float64, "cpu")
    A32, C32, b32 = make_chunk(5, 0, 2, 4, 3, torch.float32, "cpu")
    assert A32.dtype == C32.dtype == b32.dtype == torch.float32
    assert torch.equal(A32, A64.float()) and torch.equal(b32, b64.float())


def test_relative_gap():
    C = torch.eye(2, dtype=torch.float64)[None]
    X = torch.diag(torch.tensor([1.0, 2.0], dtype=torch.float64))[None]
    b = torch.tensor([[1.0, 1.0]], dtype=torch.float64)
    y = torch.tensor([[1.0, 1.5]], dtype=torch.float64)
    assert torch.allclose(relative_gap(C, X, b, y), torch.tensor([0.5 / 3.5], dtype=torch.float64))

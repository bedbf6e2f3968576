import torch

from portbench.reference import sdp


def _lambda_min_program(n=6, seed=3):
    # maximize y s.t. C - y I PSD: y* = lambda_min(C); the dual
    # minimize <C, X> s.t. tr X = 1, X PSD: X* = v v' for its eigenvector.
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
    lam = torch.linspace(0.5, 3.0, n, dtype=torch.float64)
    C = Q @ torch.diag(lam) @ Q.T
    C = 0.5 * (C + C.T)
    A = torch.eye(n, dtype=torch.float64)[None]
    b = torch.ones(1, dtype=torch.float64)
    v = Q[:, 0]
    one = lambda t: t[None]
    return (one(A), one(C), one(b), one(torch.tensor([0.5], dtype=torch.float64)),
            one(torch.outer(v, v)))


def test_the_known_optimum_has_a_clean_certificate():
    A, C, b, y, X = _lambda_min_program()
    assert float(sdp.relative_gap(C, X, b, y)) < 1e-15
    assert float(sdp.infeasibility(A, C, b, y, X)) < 1e-15


def test_each_error_sees_its_fault():
    A, C, b, y, X = _lambda_min_program()
    gap = lambda y, X: float(sdp.relative_gap(C, X, b, y))
    bad = lambda y, X: float(sdp.infeasibility(A, C, b, y, X))
    assert gap(y - 1e-3, X) > 1e-4                       # a suboptimal y
    assert bad(y + 1e-3, X) > 1e-4                       # the slack leaves the cone
    assert bad(y, 1.01 * X) > 1e-3                       # <A, X> != b
    assert bad(y, X - 1e-3 * torch.eye(6, dtype=torch.float64)) > 1e-4  # X leaves it
    # A zero answer closes the gap and is caught by its infeasibility.
    assert gap(0 * y, 0 * X) == 0.0 and bad(0 * y, 0 * X) > 0.4


def test_schur_by_hand():
    # m = 1, n = 2: A = [[1, 2], [2, 0]], W = diag(1, 3), C = I.
    A = torch.tensor([[[1.0, 2.0], [2.0, 0.0]]], dtype=torch.float64)
    W = torch.diag(torch.tensor([1.0, 3.0], dtype=torch.float64))
    C = torch.eye(2, dtype=torch.float64)
    G, AW, AQc, wc, cqc = sdp.schur(A, W, C)
    # A W = [[1, 6], [2, 0]]; tr(A W A W) = 1 + 12 + 12 + 0 = 25
    assert G.tolist() == [[25.0]]
    assert AW.tolist() == [1.0]
    # C W A W = W A W = [[1, 6], [6, 0]]: trace 1
    assert AQc.tolist() == [1.0]
    assert float(wc) == 4.0 and float(cqc) == 10.0


def test_schur_against_the_trace_definition():
    gen = torch.Generator().manual_seed(7)
    A = torch.randn(4, 5, 5, generator=gen, dtype=torch.float64)
    A = A + A.transpose(-2, -1)
    W = torch.randn(5, 5, generator=gen, dtype=torch.float64)
    W = W @ W.T
    C = torch.randn(5, 5, generator=gen, dtype=torch.float64)
    C = C + C.T
    G, AW, AQc, wc, cqc = sdp.schur(A, W, C)
    for v in range(4):
        assert torch.allclose(AW[v], torch.trace(A[v] @ W))
        assert torch.allclose(AQc[v], torch.trace(C @ W @ A[v] @ W))
        for u in range(4):
            assert torch.allclose(G[v, u], torch.trace(A[v] @ W @ A[u] @ W))
    assert torch.allclose(cqc, torch.trace(C @ W @ C @ W))

"""Optimality certificate of dense SDP answers, and the Schur phase.

For maximize b'y s.t. Z(y) = C - sum_i y_i A_i PSD, with dual
minimize <C, X> s.t. <A_i, X> = b_i, X PSD, an answer (y, X) is judged by
its relative duality gap |<C, X> - b'y| / (1 + |b'y|) and by its
infeasibility, the largest of the DIMACS errors

- err1 = ||A(X) - b||_2 / (1 + max|b|), the dual residual;
- err2 = max(0, -lambda_min(X)) / (1 + max|b|), X outside the cone;
- err4 = max(0, -lambda_min(Z(y))) / (1 + max|C|), the slack outside it.

Every function takes batches (a leading program axis) and computes in
float64.
"""

from __future__ import annotations

import torch


def _f64(*ts):
    return tuple(t.to(torch.float64) for t in ts)


def relative_gap(C, X, b, y):
    """|<C, X> - b'y| / (1 + |b'y|) per program."""
    C, X, b, y = _f64(C, X, b, y)
    by = (b * y).sum(-1)
    return ((C * X).sum((-2, -1)) - by).abs() / (1.0 + by.abs())


def _lambda_min(M):
    return torch.linalg.eigvalsh(0.5 * (M + M.transpose(-2, -1)))[..., 0]


def infeasibility(A, C, b, y, X):
    """max(err1, err2, err4) per program: A (P, m, n, n), C and X
    (P, n, n), b and y (P, m)."""
    A, C, b, y, X = _f64(A, C, b, y, X)
    scale_b = 1.0 + b.abs().amax(-1)
    err1 = torch.linalg.vector_norm(torch.einsum("pvij,pij->pv", A, X) - b, dim=-1) / scale_b
    err2 = torch.clamp(-_lambda_min(X), min=0.0) / scale_b
    Z = C - torch.einsum("pv,pvij->pij", y, A)
    err4 = torch.clamp(-_lambda_min(Z), min=0.0) / (1.0 + C.abs().amax((-2, -1)))
    return torch.maximum(err1, torch.maximum(err2, err4))


def schur(A, W, C):
    """(G, AW, AQc, w_dot_c, c_dot_Qc) of one cone: G_vu = tr(A_v W A_u W),
    AW_v = tr(A_v W), AQc_v = tr(C W A_v W), w_dot_c = tr(C W),
    c_dot_Qc = tr(C W C W); A (m, n, n), W and C (n, n)."""
    A, W, C = _f64(A, W, C)
    P = A @ W
    CW = C @ W
    m, n = A.shape[0], A.shape[1]
    G = P.reshape(m, n * n) @ P.transpose(-2, -1).reshape(m, n * n).T
    AW = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)
    AQc = torch.einsum("ik,vki->v", CW, P)
    return G, AW, AQc, torch.trace(CW), torch.sum(CW * CW.T)

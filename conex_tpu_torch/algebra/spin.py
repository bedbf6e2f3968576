"""Spin-factor (Lorentz cone) Jordan algebra, batched.

Twin of ``conex_tpu/algebra/spin.py``.  Elements are vectors x = (x0, x1)
in R^{1+n} along the trailing axis; every operation is closed-form in the
two eigenvalues lam_pm = x0 +/- ||x1|| and broadcasts over any leading
batch axes (scenarios, cones).
"""

from __future__ import annotations

import torch


def eigenvalues(x):
    """Both spin-factor eigenvalues, shape (..., 2): (x0+|x1|, x0-|x1|).

    reference: SpectralDecompSpinFactor::Compute (soc_constraint.cc:42-51).
    """
    x0 = x[..., 0]
    nq = torch.linalg.vector_norm(x[..., 1:], dim=-1)
    return torch.stack([x0 + nq, x0 - nq], dim=-1)


def _spectral_apply(x, fn):
    """y = fn(lam1) P1 + fn(lam2) P2 with idempotents P_i = (1, +/-q)/2.

    reference: Idempotents (soc_constraint.cc:57-69); q = x1/|x1| with the
    |x1| = 0 convention that the essential part vanishes (no NaN from the
    division reaches the result).
    """
    x0 = x[..., 0]
    x1 = x[..., 1:]
    nq = torch.linalg.vector_norm(x1, dim=-1)
    safe = torch.where(nq == 0, 1.0, nq)
    qhat = torch.where(nq[..., None] > 0, x1 / safe[..., None], 0.0)
    f1 = fn(x0 + nq)
    f2 = fn(x0 - nq)
    head = 0.5 * (f1 + f2)
    tail = (0.5 * (f1 - f2))[..., None] * qhat
    return torch.cat([head[..., None], tail], dim=-1)


def sqrt(x):
    """Jordan square root (soc_constraint.cc:145-163)."""
    return _spectral_apply(x, torch.sqrt)


def exp(x):
    """Jordan exponential (soc_constraint.cc:165-176)."""
    return _spectral_apply(x, torch.exp)


def det(x):
    """det x = x0^2 - |x1|^2."""
    return x[..., 0] ** 2 - torch.sum(x[..., 1:] ** 2, dim=-1)


def quadratic_representation(x, y):
    """Q(x) y = 2 <x,y> x - det(x) R y with R = diag(1,-1,...,-1).

    reference: QuadraticRepresentation (soc_constraint.cc:130-143).
    Broadcasts over leading batch axes.
    """
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    minus_ry = torch.cat([-y[..., :1], y[..., 1:]], dim=-1)
    return 2.0 * dot * x + det(x)[..., None] * minus_ry


def norm_inf(x):
    """max |lam| (soc_constraint.cc:178-191)."""
    return torch.amax(torch.abs(eigenvalues(x)), dim=-1)

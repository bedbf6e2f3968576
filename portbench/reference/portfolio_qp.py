"""The portfolio QP of the OSQP benchmark suite, solved and factored plainly.

For F (n, k), D (n,) >= 0, mu (n,) and gamma > 0, the program is

    minimize  x'Dx + f'f - mu'x / gamma
    s.t.      F'x = f,  1'x = 1,  0 <= x <= 1

over v = (x, f).  ``solve_plain`` solves a batch of them by a primal-dual
interior-point method with Mehrotra's predictor-corrector (Nocedal and
Wright, Numerical Optimization, 2nd ed., ch. 16.6 and 14.2), and
certifies each answer by its own multipliers: the relative gap between
the primal and the dual objective, and the relative residuals of
stationarity, the equality rows and the bounds.  ``ldlt_plain`` is the
fixed-order LDLT with pivots clamped to +/-1e-9 (conex's RLDLT.h:381-393),
column by column in the left-looking order; ``assemble_plain`` builds the
KKT matrix [G Aeq'; Aeq 0] that conex factors for this program at a
box iterate w.

Plain PyTorch in float64; it imports nothing of the port.  Every function
takes batches (a leading program axis).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# What a certified answer keeps to: its relative duality gap, and its
# relative residuals of stationarity and of the equality rows (the bounds
# hold strictly at every iterate).
GAP_BAR = 1e-11
RESIDUAL_BAR = 1e-12
PIVOT_CLAMP = 1e-9
MAX_ITERATIONS = 100
STEP_TO_BOUNDARY = 0.995


class Optimum(NamedTuple):
    """Each program's answer v = (x, f), its multipliers (lam of the rows
    F'x - f = 0 and 1'x = 1, z_lo of x >= 0, z_hi of x <= 1), objective,
    relative gap and largest relative residual, and whether both keep to
    their bars."""

    v: torch.Tensor
    lam: torch.Tensor
    z_lo: torch.Tensor
    z_hi: torch.Tensor
    objective: torch.Tensor
    gap: torch.Tensor
    residual: torch.Tensor
    certified: torch.Tensor


def exact(fn):
    """``fn`` with TF32 off on the card, the caller's flags restored after."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return inner


def _f64(*ts):
    return tuple(t.to(torch.float64) for t in ts)


def objective(D, mu, gamma, v):
    """x'Dx + f'f - mu'x / gamma of each program, v = (x, f)."""
    D, mu, gamma, v = _f64(D, mu, gamma, v)
    n = D.shape[-1]
    x, f = v[..., :n], v[..., n:]
    return (D * x * x).sum(-1) + (f * f).sum(-1) - (mu * x).sum(-1) / gamma


def rows(F):
    """Aeq (P, k + 1, n + k) and beq (P, k + 1): F'x - f = 0, 1'x = 1."""
    (F,) = _f64(F)
    P, n, k = F.shape
    top = torch.cat([F.transpose(1, 2), -torch.eye(k, dtype=F.dtype, device=F.device)
                     .expand(P, k, k)], dim=2)
    budget = torch.cat([F.new_ones(P, 1, n), F.new_zeros(P, 1, k)], dim=2)
    beq = F.new_zeros(P, k + 1)
    beq[:, k] = 1.0
    return torch.cat([top, budget], dim=1), beq


def _qp(F, D, mu, gamma):
    """The rows (E, e) and the cost's diagonal Hessian H and gradient g at
    0, over v = (x, f): the objective is 1/2 v'Hv + g'v."""
    P, _, k = F.shape
    E, e = rows(F)
    H = torch.cat([2.0 * D, F.new_full((P, k), 2.0)], dim=1)
    g = torch.cat([-mu / gamma[:, None], F.new_zeros(P, k)], dim=1)
    return E, e, H, g


def _residuals(H, g, E, e, v, lam, z_lo, z_hi, n):
    """Stationarity H v + g - E'lam - z_lo + z_hi (bound terms on x only)
    and the rows' residual E v - e."""
    r_d = H * v + g - (E.transpose(1, 2) @ lam[..., None])[..., 0]
    r_d[:, :n] += z_hi - z_lo
    return r_d, (E @ v[..., None])[..., 0] - e


def _largest_step(t, dt):
    """The largest alpha in (0, 1] with t + alpha dt >= 0, per program."""
    ratio = torch.where(dt < 0, -t / dt, torch.full_like(t, float("inf")))
    return ratio.amin(-1).clamp(max=1.0)


@exact
def solve_plain(F, D, mu, gamma, max_iterations: int = MAX_ITERATIONS) -> Optimum:
    """The optimum of each program of the batch: F (P, n, k), D and mu
    (P, n), gamma (P,)."""
    F, D, mu, gamma = _f64(F, D, mu, gamma)
    P, n, k = F.shape
    E, e, H, g = _qp(F, D, mu, gamma)
    v = torch.cat([F.new_full((P, n), 1.0 / n), F.sum(1) / n], dim=1)
    lam = F.new_zeros(P, k + 1)
    z_lo, z_hi = F.new_ones(P, n), F.new_ones(P, n)
    scale_d = 1.0 + g.abs().amax(-1)
    scale_p = 1.0 + e.abs().amax(-1)

    def newton(r_d, r_p, r_lo, r_hi, x, s):
        """The step (dv, dlam, dz_lo, dz_hi) for the complementarity
        residuals r_lo = x z_lo - sigma mu and r_hi = s z_hi - sigma mu,
        with s = 1 - x: the bound multipliers eliminated, H + Sigma is
        diagonal, and the rows' Schur complement E Phi^-1 E' is solved
        densely."""
        phi = H.clone()
        phi[:, :n] += z_lo / x + z_hi / s
        rhs = -r_d
        rhs[:, :n] += -r_lo / x + r_hi / s
        Et = E.transpose(1, 2)
        M = E @ (Et / phi[..., None])
        t = -r_p - (E @ (rhs / phi)[..., None])[..., 0]
        dlam = torch.linalg.solve(M, t[..., None])[..., 0]
        dv = (rhs + (Et @ dlam[..., None])[..., 0]) / phi
        dx = dv[:, :n]
        return dv, dlam, -(r_lo + z_lo * dx) / x, -(r_hi - z_hi * dx) / s

    for _ in range(max_iterations):
        x = v[:, :n]
        s = 1.0 - x
        r_d, r_p = _residuals(H, g, E, e, v, lam, z_lo, z_hi, n)
        comp = (x * z_lo + s * z_hi).sum(-1)
        mu_c = comp / (2 * n)
        done = ((r_d.abs().amax(-1) / scale_d <= 0.1 * RESIDUAL_BAR)
                & (r_p.abs().amax(-1) / scale_p <= 0.1 * RESIDUAL_BAR)
                & (comp <= 0.1 * GAP_BAR * (1.0 + objective(D, mu, gamma, v).abs())))
        if bool(done.all()):
            break
        # Predictor: the affine step.
        dv, dlam, dzl, dzh = newton(r_d, r_p, x * z_lo, s * z_hi, x, s)
        dx = dv[:, :n]
        a_p = torch.minimum(_largest_step(x, dx), _largest_step(s, -dx))
        a_d = torch.minimum(_largest_step(z_lo, dzl), _largest_step(z_hi, dzh))
        comp_aff = (((x + a_p[:, None] * dx) * (z_lo + a_d[:, None] * dzl)).sum(-1)
                    + ((s - a_p[:, None] * dx) * (z_hi + a_d[:, None] * dzh)).sum(-1))
        sigma = (comp_aff / comp.clamp(min=1e-300)) ** 3
        # Corrector: centering and the second-order term.
        target = (sigma * mu_c)[:, None]
        dv, dlam, dzl, dzh = newton(r_d, r_p, x * z_lo + dx * dzl - target,
                                    s * z_hi - dx * dzh - target, x, s)
        dx = dv[:, :n]
        a_p = STEP_TO_BOUNDARY * torch.minimum(_largest_step(x, dx), _largest_step(s, -dx))
        a_d = STEP_TO_BOUNDARY * torch.minimum(_largest_step(z_lo, dzl),
                                               _largest_step(z_hi, dzh))
        # A program that is done stays where it is.
        a_p = torch.where(done, torch.zeros_like(a_p), a_p)
        a_d = torch.where(done, torch.zeros_like(a_d), a_d)
        v = v + a_p[:, None] * dv
        lam = lam + a_d[:, None] * dlam
        z_lo = z_lo + a_d[:, None] * dzl
        z_hi = z_hi + a_d[:, None] * dzh
    return _certify(F, D, mu, gamma, v, lam, z_lo, z_hi)


def _certify(F, D, mu, gamma, v, lam, z_lo, z_hi) -> Optimum:
    """The certificate of (v, lam, z_lo, z_hi): the relative gap between
    the primal objective and the Lagrangian dual's, -1/2 v'Hv + e'lam -
    1'z_hi at a stationary point, and the largest relative residual of
    stationarity and of the rows; the bounds and the multipliers' signs
    must hold."""
    n = F.shape[1]
    E, e, H, g = _qp(F, D, mu, gamma)
    r_d, r_p = _residuals(H, g, E, e, v, lam, z_lo, z_hi, n)
    primal = objective(D, mu, gamma, v)
    dual = -0.5 * (H * v * v).sum(-1) + (e * lam).sum(-1) - z_hi.sum(-1)
    gap = (primal - dual).abs() / (1.0 + primal.abs())
    residual = torch.maximum(r_d.abs().amax(-1) / (1.0 + g.abs().amax(-1)),
                             r_p.abs().amax(-1) / (1.0 + e.abs().amax(-1)))
    x = v[:, :n]
    inside = ((x >= 0) & (x <= 1)).all(-1) & (z_lo >= 0).all(-1) & (z_hi >= 0).all(-1)
    certified = inside & (gap <= GAP_BAR) & (residual <= RESIDUAL_BAR)
    return Optimum(v=v, lam=lam, z_lo=z_lo, z_hi=z_hi, objective=primal, gap=gap,
                   residual=residual, certified=certified)


def clamp_pivot(d):
    """|d| < 1e-9 becomes +/-1e-9 by its sign, an exact 0 +1e-9
    (RLDLT.h:381-393)."""
    clamp = torch.full_like(d, PIVOT_CLAMP)
    return torch.where(d.abs() < PIVOT_CLAMP, torch.where(d >= 0, clamp, -clamp), d)


@exact
def ldlt_plain(K):
    """(L, d) of each (N, N) K of the batch by the fixed-order LDLT with
    clamped pivots, one column at a time: d_j = K_jj - sum_{i<j} L_ji^2 d_i,
    clamped, then L_rj = (K_rj - sum_{i<j} L_ri d_i L_ji) / d_j for r > j.
    L is unit lower triangular; only K's lower triangle is read."""
    (K,) = _f64(K)
    P, N, _ = K.shape
    L = torch.eye(N, dtype=K.dtype, device=K.device).repeat(P, 1, 1)
    d = K.new_zeros(P, N)
    for j in range(N):
        ld = L[:, j, :j] * d[:, :j]
        d[:, j] = clamp_pivot(K[:, j, j] - (ld * L[:, j, :j]).sum(-1))
        below = K[:, j + 1:, j] - (L[:, j + 1:, :j] @ ld[..., None])[..., 0]
        L[:, j + 1:, j] = below / d[:, j:j + 1]
    return L, d


def assemble_plain(F, D, w):
    """conex's KKT matrix of the program at the iterate w = (w_hi, w_lo)
    of its 2n box rows (c - A y >= 0 with A = [I 0; -I 0], c = (1, 0)):
    G = Q + A' diag(w)^2 A with Q = blockdiag(2D, 2I), then the rows
    Aeq of F'x - f = 0 and 1'x = 1 beside and below it."""
    F, D, w = _f64(F, D, w)
    P, n, k = F.shape
    m = n + k
    Aeq, _ = rows(F)
    K = F.new_zeros(P, m + k + 1, m + k + 1)
    diag = torch.cat([2.0 * D + w[:, :n] ** 2 + w[:, n:] ** 2, F.new_full((P, k), 2.0)],
                     dim=1)
    K[:, :m, :m] = torch.diag_embed(diag)
    K[:, m:, :m] = Aeq
    K[:, :m, m:] = Aeq.transpose(1, 2)
    return K

"""Mu (centering parameter) selection.

Twin of ``conex_tpu/solver/mu.py``: the closed-form inverse of the
geodesic-divergence upper bound (reference conex/divergence.cc) and the
mu-update fallback chain of the solve loop (cone_program.cc:162-214), as
branch-free elementwise arithmetic on (S,) tensors, one entry per scenario.

The divergence upper bound, as a function of k = 1/sqrt(mu), is

    D(k) = (k^2 |lam|^2 - 2 k tr + rank) / (1 - ||k lam - 1||_inf)

and we seek the largest k with D(k) <= budget, evaluated in closed form on
the lambda_max branch (rational equation) and the lambda_min branch
(quadratic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SlackAgg(NamedTuple):
    """Aggregated WeightedSlackEigenvalues over all cones, per scenario.

    reference: GetWeightedSlackEigenvalues aggregation,
    cone_program.cc:31-57 (max of lam_max, min of lam_min, sums).
    """

    lam_min: torch.Tensor
    lam_max: torch.Tensor
    frob_sq: torch.Tensor
    trace: torch.Tensor


def _solve_rational(a, b, c, d, k):
    """Largest solution of (a x^2 + b x + c) / (2 - d x) = k.

    reference: SolveRationalEquation, divergence.cc:18-23.
    """
    under_radical = b * b - 4.0 * a * c + 8.0 * a * k + 2.0 * b * d * k + (d * k) ** 2
    # sqrt of a negative produces NaN; callers reject non-finite results.
    return -(b + d * k - torch.sqrt(under_radical)) / (2.0 * a)


def _inverse_lambda_max_branch(budget, p: SlackAgg, rank):
    # reference: InverseLambdaMaxBranch, divergence.cc:26-41
    a = p.frob_sq
    b = -2.0 * p.trace
    c = rank
    d = p.lam_max
    x = _solve_rational(a, b, c, d, budget)
    lower_bound = 2.0 / (p.lam_max + p.lam_min)
    valid = torch.isfinite(x) & (x >= lower_bound)
    return torch.where(valid, x, -1.0)


def _inverse_lambda_min_branch(budget, p: SlackAgg, rank):
    # reference: InverseLambdaMinBranch + SolveQuadratic,
    # divergence.cc:43-83.  Solves  a k - b + n/k = c  with
    # a = |lam|^2/lam_min, b = -2 tr/lam_min, n = rank/lam_min.
    a = p.frob_sq / p.lam_min
    b = 2.0 * p.trace / p.lam_min
    # rank / tensor would multiply by a rounded reciprocal (Tensor.__rdiv__)
    n = torch.full_like(p.lam_min, rank) / p.lam_min
    c = budget
    under_radical = b * b + 2.0 * b * c + c * c - 4.0 * a * n
    ok = under_radical >= 0
    sq = torch.sqrt(torch.clamp(under_radical, min=0.0))
    k_a = (b + c + sq) / (2.0 * a)
    k_b = (b + c - sq) / (2.0 * a)
    lower = 0.0
    upper = 2.0 / (p.lam_max + p.lam_min)

    def in_limits(x):
        return (x >= lower) & (x <= upper)

    k = torch.where(ok & in_limits(k_a), k_a, -1.0)
    k = torch.where(ok & in_limits(k_b) & (k_b > k), k_b, k)
    return k


def _bound_is_finite(k, p: SlackAgg):
    # reference: BoundIsFinite, divergence.cc:85-94
    norm_inf = torch.maximum(
        torch.abs(k * p.lam_max - 1.0), torch.abs(k * p.lam_min - 1.0)
    )
    return norm_inf < 1.0


def divergence_upper_bound_inverse(budget, p: SlackAgg, rank):
    """Largest k with divergence bound <= budget; -1 on failure.

    reference: DivergenceUpperBoundInverse, divergence.cc:96-111.
    """
    k1 = _inverse_lambda_min_branch(budget, p, rank)
    k2 = _inverse_lambda_max_branch(budget, p, rank)
    k = torch.where(_bound_is_finite(k1, p), k1, -1.0)
    k = torch.where((k2 > k) & _bound_is_finite(k2, p), k2, k)
    return k


def divergence_upper_bound(k, p: SlackAgg, rank):
    """Forward evaluation D(k) (for tests).

    reference: DivergenceUpperBound, divergence.cc:113-121.
    """
    numerator = k * k * p.frob_sq - 2.0 * k * p.trace + rank
    norm_inf = torch.maximum(
        torch.abs(k * p.lam_max - 1.0), torch.abs(k * p.lam_min - 1.0)
    )
    return numerator / (1.0 - norm_inf)


def mu_from_divergence(p: SlackAgg, rank, divergence_budget_per_rank):
    """The full fallback chain of ComputeMuFromDivergence.

    reference: cone_program.cc:173-214.  Returns inv_sqrt_mu (may be <= 0;
    the caller then halves the previous value, cone_program.cc:394-398).
    """
    budget = divergence_budget_per_rank * rank
    k = divergence_upper_bound_inverse(budget, p, rank)

    # Fallback 1: minimize ||k lam - 1||_inf  (MinimizeNormInf,
    # cone_program.cc:166-172), applied when inverse returned exactly -1.
    k_minnorm = torch.where(p.lam_min > 0, 2.0 / (p.lam_min + p.lam_max), -1.0)
    k = torch.where(k == -1.0, k_minnorm, k)

    # Fallback 2: choose k satisfying a norm bound (cone_program.cc:194-211).
    kstar = p.trace / p.frob_sq
    norm_bound = 1.5 * (p.frob_sq * kstar * kstar - 2.0 * p.trace * kstar + rank)
    norm_bound = torch.clamp(norm_bound, max=rank * 0.7)
    a = p.frob_sq
    b = -2.0 * p.trace
    c = rank - norm_bound
    disc = b * b - 4.0 * a * c
    k_quad = torch.where(
        disc < 0,
        p.trace / p.frob_sq,
        (-b + torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a),
    )
    use_fb2 = (k < 0) & (p.trace > 1e-12)
    k = torch.where(use_fb2, k_quad, k)
    return k

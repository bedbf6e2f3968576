"""Linear (nonnegative-orthant) cone blocks, batched.

Twin of ``conex_tpu/cones/lp.py``.  One block holds, for each of S
scenarios, n linear inequalities ``c - A y >= 0`` over the same variables.
Every tensor carries the scenario axis first: A (S, n, v), c (S, n), and
the iterate w is a positive (S, n) tensor.  Everything is elementwise work
and two batched products, as in the JAX package, which computes it outside
any Pallas kernel too.

Key formulas (reference linear_constraint.cc, per method):
  minus_s = A y - k c            d = e_weight + w * minus_s
  take_step: w <- w * exp(step * d)
  schur: G = (WA)^T (WA), AW = A^T w, AQc = (WA)^T (W c)
  exact line search: an interval of mu per coordinate, intersected
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .base import SchurOut, SlackStats, per_scenario


class LPStepCache(NamedTuple):
    d: torch.Tensor  # (S, n) Newton direction in the algebra


@dataclasses.dataclass(frozen=True)
class LinearCone:
    """S x n linear inequalities: c_s - A_s y_s >= 0 elementwise."""

    A: torch.Tensor  # (S, n, v)
    c: torch.Tensor  # (S, n)
    vars_: Optional[Tuple[int, ...]] = None

    supports_line_search = True

    @property
    def scenarios(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    def rank(self) -> int:
        # reference: linear_constraint.h:51
        return self.n

    def identity_state(self, dtype) -> torch.Tensor:
        # reference: SetIdentity, linear_constraint.cc:105
        return torch.ones(self.c.shape, dtype=dtype, device=self.A.device)

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack, linear_constraint.cc:164-168
        return (self.A @ y[..., None])[..., 0] - per_scenario(k, 2) * self.c

    def schur(self, w: torch.Tensor) -> SchurOut:
        # reference: ConstructSchurComplementSystem,
        # linear_constraint.cc:177-205
        WA = w[..., None] * self.A
        WC = w * self.c
        WAt = WA.transpose(1, 2)
        return SchurOut(
            G=WAt @ WA,
            AW=(self.A.transpose(1, 2) @ w[..., None])[..., 0],
            AQc=(WAt @ WC[..., None])[..., 0],
            w_dot_c=torch.sum(WC, dim=1),
            c_dot_Qc=torch.sum(WC * WC, dim=1),
        )

    def prepare_step(self, w, y, c_weight, e_weight):
        # reference: PrepareStep, linear_constraint.cc:108-128
        d = w * self._minus_s(y, c_weight) + per_scenario(e_weight, 2)
        norminf = torch.amax(torch.abs(d), dim=1)
        normsq = torch.sum(d * d, dim=1)
        return LPStepCache(d=d), norminf, normsq

    def take_step(self, w, cache: LPStepCache, step_size):
        # reference: TakeStep, linear_constraint.cc:130-144
        return w * torch.exp(per_scenario(step_size, 2) * cache.d)

    def affine_step(self, w, y, e_weight):
        # reference: PrepareStep(affine) + AffineUpdate,
        # linear_constraint.cc:124-127, 170-175: dual recovery,
        # W += W * (minus_s * W) with minus_s = A y (c_weight = 0).
        sw = self._minus_s(y, 0.0) * w
        return w * (1.0 + per_scenario(e_weight, 2)) + w * sw

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues, linear_constraint.cc:147-162
        ws = w * self._minus_s(y, c_weight)
        return SlackStats(
            lam_min=-torch.amax(ws, dim=1),
            lam_max=-torch.amin(ws, dim=1),
            frob_sq=torch.sum(ws * ws, dim=1),
            trace=-torch.sum(ws, dim=1),
        )

    def line_search(self, w, y0, y1, c0_weight, c1_weight, dinf_max):
        # reference: PerformLineSearch + FindMinimumMu,
        # linear_constraint.cc:47-103.  d(mu) is affine in mu along the
        # segment (y0, c0) -> (y1, c1); each coordinate gives an interval
        # of admissible mu, and a scenario's intervals are intersected.
        d0 = w * self._minus_s(y0, c0_weight) + 1.0
        d1 = w * self._minus_s(y1, c1_weight) + 1.0
        delta = d1 - d0
        bound_a = (dinf_max - d0) / delta
        bound_b = (-dinf_max - d0) / delta
        upper = torch.amin(torch.maximum(bound_a, bound_b), dim=1)
        lower = torch.amax(torch.minimum(bound_a, bound_b), dim=1)
        return lower, upper, lower > upper

    def dual_variable(self, w):
        # reference: constraint.h:159-166 (dual variable == workspace W)
        return w

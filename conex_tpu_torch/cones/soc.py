"""Second-order (Lorentz) cone blocks, batched.

Twin of ``conex_tpu/cones/soc.py``.  One block holds, for each of S
scenarios, B same-dimension cones ``c_b - A_b y in Q^{n+1}`` over the same
variables.  Every tensor carries the scenario axis first: A (S, B, n+1, v),
c (S, B, n+1), and the iterate w is a plain (S, B, n+1) tensor.

As in the JAX package, the iterate stays w and w^{1/2} travels in the step
cache (the reference keeps w^{1/2} in its workspace between PrepareStep and
TakeStep, soc_constraint.cc:251-270).  The Schur phase is einsum: the JAX
package computes it outside any Pallas kernel too.

Spans and counters (utils/profiling.py): ``schur`` runs inside
``conex.soc.schur`` and counts ``soc.schur.calls``; ``prepare_step``,
``take_step``, ``slack_stats`` and ``affine_step`` run inside
``conex.soc.step``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..algebra import spin
from ..utils.profiling import counters, spanned
from .base import SchurOut, SlackStats, per_scenario


class SOCStepCache(NamedTuple):
    d: torch.Tensor  # (S, B, n+1) Newton direction in the algebra
    wsqrt: torch.Tensor  # (S, B, n+1) cached square root of the iterate


@dataclasses.dataclass(frozen=True)
class SOCCone:
    """S x B Lorentz-cone constraints: c_sb - A_sb y_s in Q^{n+1}."""

    A: torch.Tensor  # (S, B, n+1, v)
    c: torch.Tensor  # (S, B, n+1)
    vars_: Optional[Tuple[int, ...]] = None

    supports_line_search = False
    # The spin-factor trace inner product is 2 u.v; scaling the stored
    # iterate by 2 makes the user-facing dual satisfy the euclidean
    # conditions A'x = b, <slack, x> ~ 0 (conex_tpu/cones/soc.py:44-48).
    dual_scale = 2.0

    @property
    def scenarios(self) -> int:
        return self.A.shape[0]

    @property
    def batch(self) -> int:
        return self.A.shape[1]

    @property
    def num_vars(self) -> int:
        return self.A.shape[3]

    def rank(self) -> int:
        # Each Lorentz cone has rank 2 (soc_constraint.h:24).
        return 2 * self.batch

    def identity_state(self, dtype) -> torch.Tensor:
        e = torch.zeros(self.A.shape[:3], dtype=dtype, device=self.A.device)
        e[..., 0] = 1.0
        return e

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack (soc_constraint.cc:193-197)
        return torch.einsum("sbnv,sv->sbn", self.A, y) - per_scenario(k, 3) * self.c

    @spanned("conex.soc.schur")
    def schur(self, w: torch.Tensor) -> SchurOut:
        # reference: ConstructSchurComplementSystem (soc_constraint.cc:272-303)
        counters["soc.schur.calls"] += 1
        wsqrt = spin.sqrt(w)
        # Row (s, b, i) of WA holds Q(wsqrt_sb) A_sb[:, i]; Q is linear in
        # its argument, so it applies to every column at once.
        WA = spin.quadratic_representation(
            wsqrt[:, :, None, :], self.A.transpose(2, 3)
        )  # (S, B, v, n+1)
        WsqrtC = spin.quadratic_representation(wsqrt, self.c)  # (S, B, n+1)
        return SchurOut(
            G=2.0 * torch.einsum("sbvn,sbun->svu", WA, WA),
            AW=2.0 * torch.einsum("sbnv,sbn->sv", self.A, w),
            AQc=2.0 * torch.einsum("sbvn,sbn->sv", WA, WsqrtC),
            w_dot_c=2.0 * torch.sum(WsqrtC[..., 0], dim=1),
            c_dot_Qc=2.0 * torch.sum(WsqrtC * WsqrtC, dim=(1, 2)),
        )

    @spanned("conex.soc.step")
    def prepare_step(self, w, y, c_weight, e_weight):
        # reference: PrepareStep (soc_constraint.cc:251-270)
        minus_s = self._minus_s(y, c_weight)
        wsqrt = spin.sqrt(w)
        d = spin.quadratic_representation(wsqrt, minus_s)
        d = torch.cat([d[..., :1] + per_scenario(e_weight, 3), d[..., 1:]], dim=-1)
        norminf = torch.amax(spin.norm_inf(d), dim=1)
        normsq = 2.0 * torch.sum(d * d, dim=(1, 2))
        return SOCStepCache(d=d, wsqrt=wsqrt), norminf, normsq

    @spanned("conex.soc.step")
    def take_step(self, w, cache: SOCStepCache, step_size):
        # reference: TakeStep (soc_constraint.cc:225-249)
        expd = spin.exp(per_scenario(step_size, 3) * cache.d)
        return spin.quadratic_representation(cache.wsqrt, expd)

    @spanned("conex.soc.step")
    def affine_step(self, w, y, e_weight):
        # Dual recovery: the first-order update W += Q(w) s with s = A y
        # (conex_tpu/cones/soc.py:105-112; the reference SOC kernel has no
        # affine branch).
        minus_s = self._minus_s(y, 0.0)
        return w * (1.0 + per_scenario(e_weight, 3)) + spin.quadratic_representation(
            w, minus_s
        )

    @spanned("conex.soc.step")
    def slack_stats(self, w, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues (soc_constraint.cc:200-223)
        minus_s = self._minus_s(y, c_weight)
        ws = spin.quadratic_representation(spin.sqrt(w), minus_s)
        ev = spin.eigenvalues(ws)  # (S, B, 2)
        lam_max = -torch.amin(ev, dim=-1)
        lam_min = -torch.amax(ev, dim=-1)
        return SlackStats(
            lam_min=torch.amin(lam_min, dim=1),
            lam_max=torch.amax(lam_max, dim=1),
            frob_sq=torch.sum(lam_max**2 + lam_min**2, dim=1),
            trace=torch.sum(lam_max + lam_min, dim=1),
        )

    def dual_variable(self, w):
        return w

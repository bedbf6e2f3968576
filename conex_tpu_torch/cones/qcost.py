"""Quadratic cost block: adds Q to the KKT matrix (a cost, not a cone).

Twin of ``conex_tpu/cones/qcost.py``, batched: Q is (S, v, v), one cost
per scenario (the JAX block has no batch axis).  Solves
    maximize  b'y - 1/2 y'Q y   subject to cones
by contributing Q to the top-left KKT block (reference
quadratic_cost.cc:46-57).  Requires the line-search mu update and no
rescaling (reference guard, cone_program.cc:237-240; ``Program`` checks
it).  Rank 0; its state is empty, (S, 0), and every cone-sweep method is
the neutral element.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .base import SchurOut, SlackStats, StepCache


@dataclasses.dataclass(frozen=True)
class QuadraticCost:
    Q: torch.Tensor  # (S, v, v) symmetric PSD cost matrices
    vars_: Optional[Tuple[int, ...]] = None

    supports_line_search = True  # no-op success (quadratic_cost.cc:59-66)
    dual_scale = 1.0
    is_cost = True

    @property
    def scenarios(self) -> int:
        return self.Q.shape[0]

    @property
    def num_vars(self) -> int:
        return self.Q.shape[2]

    def rank(self) -> int:
        return 0

    def _per_scenario(self, value):
        return torch.full((self.scenarios,), value, dtype=self.Q.dtype,
                          device=self.Q.device)

    def identity_state(self, dtype) -> torch.Tensor:
        return torch.zeros((self.scenarios, 0), dtype=dtype, device=self.Q.device)

    def schur(self, w) -> SchurOut:
        zeros = self.Q.new_zeros(self.Q.shape[:2])
        return SchurOut(G=self.Q, AW=zeros, AQc=zeros,
                        w_dot_c=self._per_scenario(0.0),
                        c_dot_Qc=self._per_scenario(0.0))

    def prepare_step(self, w, y, c_weight, e_weight):
        zero = self._per_scenario(0.0)
        return StepCache(d=w), zero, zero

    def take_step(self, w, cache, step_size):
        return w

    def affine_step(self, w, y, e_weight):
        return w

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        return SlackStats(
            lam_min=self._per_scenario(float("inf")),
            lam_max=self._per_scenario(-float("inf")),
            frob_sq=self._per_scenario(0.0),
            trace=self._per_scenario(0.0),
        )

    def line_search(self, w, y0, y1, c0_weight, c1_weight, dinf_max):
        return (self._per_scenario(-float("inf")),
                self._per_scenario(float("inf")),
                torch.zeros((self.scenarios,), dtype=torch.bool,
                            device=self.Q.device))

    def dual_variable(self, w):
        return w

"""Affine equality constraints A y = b, batched.

Twin of ``conex_tpu/cones/equality.py``.  One block holds, for each of S
scenarios, p equality rows over the same variables: A (S, p, v), b (S, p).
An equality block has no cone iterate; it adds the off-diagonal blocks
[0 A^T; A 0] to the KKT matrix and b to the residual AQc
(reference equality_constraint.cc:13-28), and its dual variable lambda is
read back from the tail of the KKT solution (equality_constraint.cc:30-35).
Its presence makes the KKT matrix indefinite, so ``Program`` forces the
LDLT path (reference kkt_solver.cc:180-187).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EqualityBlock:
    A: torch.Tensor  # (S, p, v)
    b: torch.Tensor  # (S, p)
    vars_: Optional[Tuple[int, ...]] = None
    # Row offset of this block's dual variables within the KKT system,
    # counted from the start of the dual-variable segment: the block's
    # duals occupy KKT rows [m + dual_offset, m + dual_offset + p)
    # (reference constraint_manager.h:71-86, duals after the primals).
    dual_offset: int = 0

    @property
    def p(self) -> int:
        return self.A.shape[1]

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    def rank(self) -> int:
        # reference: equality_constraint.h:30
        return 0

    def dual_variable(self, y_full: torch.Tensor, m: int) -> torch.Tensor:
        """lambda (S, p): the tail of the KKT solutions y_full (S, N)
        (equality_constraint.cc:30-35)."""
        off = m + self.dual_offset
        return y_full[:, off:off + self.p]

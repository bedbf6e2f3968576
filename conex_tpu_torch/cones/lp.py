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

Bound rows.  A row with at most one nonzero in every scenario (a variable
bound, such as 0 <= y_j <= 1) adds to G's diagonal alone: every
off-diagonal product of its row of WA holds an exact zero.
``split_bound_rows``, called once at the solve's entry, finds those rows
from A itself and keeps each one's column and coefficient per scenario,
so that its A y is one product and its Schur terms are summed per column;
the other rows keep the dense products, on a compact A of their own.  A
cone without bound rows is returned as it is, and runs the dense code.
The iterate w keeps the caller's row order either way.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import counters, spanned
from .base import SchurOut, SlackStats, per_scenario


class LPStepCache(NamedTuple):
    d: torch.Tensor  # (S, n) Newton direction in the algebra


@dataclasses.dataclass(frozen=True)
class LinearCone:
    """S x n linear inequalities: c_s - A_s y_s >= 0 elementwise.

    After ``split_bound_rows`` A holds the general rows alone, and the
    bound rows are held by the fields below it (None before the split),
    each with the scenario axis first, so that slicing the scenario axis
    slices the split too.
    """

    A: torch.Tensor  # (S, n, v); after the split (S, ng, v), the general rows
    c: torch.Tensor  # (S, n)
    vars_: Optional[Tuple[int, ...]] = None
    bound_cols: Optional[torch.Tensor] = None  # (S, nb) int64: each bound row's column
    bound_coefs: Optional[torch.Tensor] = None  # (S, nb): its coefficient, 0 for a zero row
    column_rows: Optional[torch.Tensor] = None  # (S, v, t) int64: each column's bound
    # rows (places in bound_cols) in ascending order, padded with nb
    bound_rows: Optional[torch.Tensor] = None  # (S, nb) int64 rows of c; None: every row
    general_rows: Optional[torch.Tensor] = None  # (S, ng) int64 rows of c held by A

    supports_line_search = True

    @property
    def scenarios(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.c.shape[1]

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    def rank(self) -> int:
        # reference: linear_constraint.h:51
        return self.n

    def identity_state(self, dtype) -> torch.Tensor:
        # reference: SetIdentity, linear_constraint.cc:105
        return torch.ones(self.c.shape, dtype=dtype, device=self.A.device)

    @spanned("conex.lp.split")
    def split_bound_rows(self) -> "LinearCone":
        """This cone with its bound rows held apart: one pass over A and one
        host read (``sync.cone.lp_split``).  A bound row has at most one
        nonzero, all of its entries finite, in every scenario; the column
        of its nonzero may differ between scenarios.  Counts the rows in
        ``lp.rows`` and the bound ones in ``lp.bound_rows``.  Returns self
        where no row is bound.  The per-column table holds S v t entries,
        t the most bound rows on one column: at most as many as A."""
        A = self.A
        S, n, v = A.shape
        counters["lp.rows"] += n
        if n == 0 or v == 0:
            return self
        nonzero = A != 0
        bound = ((nonzero.sum(-1) <= 1) & A.isfinite().all(-1)).all(0)  # (n,)
        cols = nonzero.to(torch.uint8).argmax(-1)  # (S, n): the nonzero's column, or 0
        coefs = A.gather(2, cols[..., None])[..., 0]
        # Each column's bound rows with a nonzero, in ascending order: a
        # stable sort by column, the others (key v) last.
        key = torch.where(bound & (coefs != 0), cols, v)
        sorted_key, order = torch.sort(key, dim=1, stable=True)
        columns = torch.arange(v, device=A.device).expand(S, v).contiguous()
        start = torch.searchsorted(sorted_key, columns)
        count = torch.searchsorted(sorted_key, columns, right=True) - start
        host = torch.cat([bound.long(), count.amax().reshape(1)]).cpu()
        counters["sync.cone.lp_split"] += 1
        is_bound = host[:n].bool()
        nb = int(is_bound.sum())
        counters["lp.bound_rows"] += nb
        if nb == 0:
            return self
        slot = start[..., None] + torch.arange(max(int(host[n]), 1), device=A.device)
        rows = order.gather(1, slot.clamp(max=n - 1).flatten(1)).reshape(slot.shape)
        if nb < n:
            rows = (torch.cumsum(bound, 0) - 1)[rows]  # row -> place among bound rows
        table = torch.where(slot < (start + count)[..., None], rows, nb)
        if nb == n:
            return dataclasses.replace(self, bound_cols=cols, bound_coefs=coefs,
                                       column_rows=table)
        in_b = is_bound.nonzero()[:, 0].to(A.device)
        in_g = (~is_bound).nonzero()[:, 0].to(A.device)
        return dataclasses.replace(
            self, A=A.index_select(1, in_g), bound_cols=cols.index_select(1, in_b),
            bound_coefs=coefs.index_select(1, in_b), column_rows=table,
            bound_rows=in_b.expand(S, nb), general_rows=in_g.expand(S, n - nb))

    def _bound(self, x):
        """The bound rows of an (S, n) tensor."""
        return x if self.bound_rows is None else x.gather(1, self.bound_rows)

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack, linear_constraint.cc:164-168.  A
        # bound row's A y is its one product; the dense product's other
        # terms are exact zeros.
        if self.bound_cols is None:
            return (self.A @ y[..., None])[..., 0] - per_scenario(k, 2) * self.c
        Ay = self.bound_coefs * y.gather(1, self.bound_cols)
        if self.general_rows is not None:
            Ay = (torch.empty_like(self.c).scatter_(1, self.bound_rows, Ay)
                  .scatter_(1, self.general_rows, (self.A @ y[..., None])[..., 0]))
        return Ay - per_scenario(k, 2) * self.c

    def schur(self, w: torch.Tensor) -> SchurOut:
        # reference: ConstructSchurComplementSystem,
        # linear_constraint.cc:177-205.  Where every row is bound, G is
        # handed over as its diagonal (S, v) (cones/base.py's SchurOut).
        WC = w * self.c
        dots = dict(w_dot_c=torch.sum(WC, dim=1), c_dot_Qc=torch.sum(WC * WC, dim=1))
        if self.bound_cols is None:
            G, AW, AQc = _dense_products(self.A, w, WC)
            return SchurOut(G=G, AW=AW, AQc=AQc, **dots)
        WA = self._bound(w) * self.bound_coefs
        terms = torch.stack([WA * WA, WA, WA * self._bound(WC)], dim=-1)
        G, AW, AQc = _column_sums(terms, self.column_rows).unbind(-1)
        if self.general_rows is not None:
            Gg, AWg, AQcg = _dense_products(self.A, w.gather(1, self.general_rows),
                                            WC.gather(1, self.general_rows))
            Gg.diagonal(dim1=1, dim2=2).add_(G)
            G, AW, AQc = Gg, AWg + AW, AQcg + AQc
        return SchurOut(G=G, AW=AW, AQc=AQc, **dots)

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


def _dense_products(A, w, WC):
    """G = (WA)^T (WA), AW = A^T w and AQc = (WA)^T (W c) of the rows A
    (S, r, v), their iterate w and W c (S, r)."""
    WA = w[..., None] * A
    WAt = WA.transpose(1, 2)
    return WAt @ WA, (A.transpose(1, 2) @ w[..., None])[..., 0], (WAt @ WC[..., None])[..., 0]


def _column_sums(terms, column_rows):
    """Per column, the sum of its bound rows' terms (S, nb, k): gathered
    through column_rows (S, v, t), whose padding nb reads a zero, and added
    in pairs, (r0 + r1) + (r2 + r3) ..., the same order on every device
    and with no atomics.  Returns (S, v, k)."""
    S, v, t = column_rows.shape
    k = terms.shape[-1]
    padded = torch.cat([terms, terms.new_zeros((S, 1, k))], dim=1)
    x = padded.gather(1, column_rows.reshape(S, v * t, 1).expand(S, v * t, k))
    x = x.reshape(S, v, t, k)
    while x.shape[2] > 1:
        if x.shape[2] % 2:
            x = torch.cat([x, x.new_zeros((S, v, 1, k))], dim=2)
        x = x[:, :, 0::2] + x[:, :, 1::2]
    return x[:, :, 0]

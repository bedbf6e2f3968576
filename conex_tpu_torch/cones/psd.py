"""Real PSD cone via dense linear matrix inequalities (LMIs), batched.

Twin of ``conex_tpu/cones/psd.py``.  One block holds, for each of S
scenarios, B same-shape LMIs ``C_b - sum_i y_i A_{b,i} >= 0`` over the same
variables.  Every tensor carries the scenario axis first: A (S, B, v, n, n),
C (S, B, n, n), the iterate W (S, B, n, n).

The Schur phase goes through ``psd_schur.schur_fused``: the hand-written
CUDA kernel on the card, its plain einsum twin on the CPU.  The eigenvalue
estimates are the matmul-only estimators of algebra/sym.py and the
geodesic step uses the Taylor exponential.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..algebra import sym
from .base import SchurOut, SlackStats, per_scenario
from .psd_schur import schur_fused


class PSDState(NamedTuple):
    """PSD cone state: the iterate W plus warm-start eigenvector seeds of
    the WS product, carried across iterations.  lam == 0 is the cold-start
    sentinel (identity initialization / warmstart aborts)."""

    w: torch.Tensor  # (S, B, n, n)
    vhi: torch.Tensor  # (S, B, n) right eigenvector seed, max end
    uhi: torch.Tensor  # (S, B, n) left eigenvector seed, max end
    vlo: torch.Tensor  # (S, B, n) right eigenvector seed, min end
    ulo: torch.Tensor  # (S, B, n) left eigenvector seed, min end
    lam: torch.Tensor  # (S, B, 2) previous (lo, hi) estimates; zeros = cold


def make_psd_state(w) -> PSDState:
    """Build a PSDState around an iterate tensor of shape (..., n, n)."""
    n = w.shape[-1]
    kw = dict(dtype=w.dtype, device=w.device)
    ones = torch.full(w.shape[:-1], 1.0 / (n ** 0.5), **kw)
    lam = torch.zeros(w.shape[:-2] + (2,), **kw)
    return PSDState(w=w, vhi=ones, uhi=ones, vlo=ones, ulo=ones, lam=lam)


class PSDStepCache(NamedTuple):
    WS: torch.Tensor  # (S, B, n, n) the product W * minus_s
    seeds: tuple  # updated (vhi, uhi, vlo, ulo)
    lam: torch.Tensor  # (S, B, 2) updated estimates


@dataclasses.dataclass(frozen=True)
class DenseLMICone:
    """S x B LMIs: C_sb - sum_i y_si A_sbi PSD, over v variables."""

    A: torch.Tensor  # (S, B, v, n, n) symmetric constraint matrices
    C: torch.Tensor  # (S, B, n, n) symmetric affine term
    vars_: Optional[Tuple[int, ...]] = None

    @property
    def scenarios(self) -> int:
        return self.A.shape[0]

    @property
    def batch(self) -> int:
        return self.A.shape[1]

    @property
    def n(self) -> int:
        return self.A.shape[3]

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    def rank(self) -> int:
        return self.n * self.batch

    def identity_state(self, dtype) -> PSDState:
        # reference: SetIdentity (psd_constraint.cc:92-95).  Contiguous, as
        # the Schur kernel requires.
        eye = torch.eye(self.n, dtype=dtype, device=self.A.device)
        shape = (self.scenarios, self.batch, self.n, self.n)
        return make_psd_state(eye.expand(shape).contiguous())

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack (dense_lmi_constraint.cc:24-27):
        # minus_s = sum_i y_i A_i - k C
        return (
            torch.einsum("sv,sbvij->sbij", y, self.A)
            - per_scenario(k, 4) * self.C
        )

    def schur(self, state: PSDState) -> SchurOut:
        # reference: SCHUR_COMPLEMENT_FUNCTION (dense_lmi_constraint.cc:72-103)
        G, AW, AQc, w_dot_c, c_dot_Qc = schur_fused(self.A, state.w, self.C)
        return SchurOut(G=G, AW=AW, AQc=AQc, w_dot_c=w_dot_c, c_dot_Qc=c_dot_Qc)

    def prepare_step(self, state: PSDState, y, c_weight, e_weight):
        # reference: PrepareStep (psd_constraint.cc:45-84)
        w = state.w
        minus_s = self._minus_s(y, c_weight)
        WS = w @ minus_s
        lo, hi, seeds, lam = sym.extreme_eigenvalues_cold_or_warm(WS, state)
        norminf = torch.amax(
            torch.maximum(torch.abs(e_weight + lo), torch.abs(e_weight + hi)),
            dim=1,
        )
        # norm2 = tr(WS WS) + 2 tr(WS) + rank (psd_constraint.cc:79-80;
        # the reference assumes e_weight = 1 here).
        normsq = (
            _tr_prod(WS, WS)
            + 2.0 * torch.diagonal(WS, dim1=-2, dim2=-1).sum(dim=(1, 2))
            + self.rank()
        )
        return PSDStepCache(WS=WS, seeds=seeds, lam=lam), norminf, normsq

    def take_step(self, state: PSDState, cache: PSDStepCache, step_size):
        # reference: GeodesicUpdate (psd_constraint.cc:13-28): with
        # d = WS + e I (e_weight folded in by TakeStep), compute
        # W <- expm(step * d) W, then re-symmetrize.
        w = state.w
        d = cache.WS + torch.eye(self.n, dtype=w.dtype, device=w.device)
        d = d * per_scenario(step_size, 4)
        expd = sym.expm_taylor(d)
        w_new = expd @ w
        w_new = 0.5 * (w_new + w_new.transpose(-2, -1))
        vhi, uhi, vlo, ulo = cache.seeds
        return PSDState(
            w=w_new, vhi=vhi, uhi=uhi, vlo=vlo, ulo=ulo, lam=cache.lam
        )

    def affine_step(self, state: PSDState, y, e_weight):
        # reference: PrepareStep(affine) + AffineUpdate
        # (psd_constraint.cc:30-43, 53-57): W <- (1 + e) W + W S W.
        w = state.w
        minus_s = self._minus_s(y, 0.0)
        WSW = (w @ minus_s) @ w
        return state._replace(w=(1.0 + per_scenario(e_weight, 4)) * w + WSW)

    def slack_stats(self, state: PSDState, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues (psd_constraint.cc:97-128)
        WS = state.w @ self._minus_s(y, c_weight)
        lo, hi, _, _ = sym.extreme_eigenvalues_cold_or_warm(WS, state)
        return SlackStats(
            lam_min=torch.amin(-hi, dim=1),
            lam_max=torch.amax(-lo, dim=1),
            frob_sq=_tr_prod(WS, WS),
            trace=-torch.diagonal(WS, dim1=-2, dim2=-1).sum(dim=(1, 2)),
        )

    def dual_variable(self, state: PSDState):
        return state.w


def _tr_prod(X, Y):
    """sum_b tr(X_b Y_b) per scenario, for (S, B, n, n) tensors."""
    return torch.sum(X * Y.transpose(-2, -1), dim=(1, 2, 3))

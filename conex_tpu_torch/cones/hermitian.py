"""Hermitian PSD cones over hypercomplex algebras, batched.

Twin of ``conex_tpu/cones/hermitian.py``: the reference's
HermitianPsdConstraint<T> for T in {Real, Complex, Quaternions, Octonions}
(conex/hermitian_psd.{h,cc}).  One block holds, for each of S scenarios, B
same-shape Hermitian LMIs ``C_b - sum_i y_i A_{b,i} >= 0`` in the algebra
of dimension ``d``.  Every tensor carries the scenario axis first: A
(S, B, v, d, n, n), C (S, B, d, n, n), the iterate w (S, B, d, n, n).
d = 8 selects the octonion specializations: non-associativity forces
Q-representation products, the closed-form scaled geodesic update, and the
reference's heuristic norm estimates (hermitian_psd.cc:116-168); its state
is a bare tensor.

Spectral estimates for d <= 4 go through the faithful real representation
(eigenvalues with multiplicity d) and the matmul-only estimators of
algebra/sym.py, warm-started from eigenvector seeds carried in HermState as
in cones/psd.py.  No kernel of its own: the products are cuBLAS's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..algebra import hypercomplex as hc
from ..algebra import sym
from ..utils.profiling import counters
from .base import SchurOut, SlackStats, per_scenario, tree_select

# Benchmark switch: force the cold squaring estimator on every iteration,
# to measure what the warm seeds buy.  Read at each call.
FORCE_COLD = False


class HermState(NamedTuple):
    """Hermitian cone state for d <= 4: the iterate plus warm eigenvector
    seeds on the real representation R(WS) (dn x dn), as PSDState.
    lam == 0 is the cold-start sentinel.  Octonions (d = 8) never compute
    spectra (heuristic norms, hermitian_psd.cc:147-168) and keep a bare
    tensor as state."""

    w: torch.Tensor  # (S, B, d, n, n)
    vhi: torch.Tensor  # (S, B, dn) right eigenvector seed, max end
    uhi: torch.Tensor  # (S, B, dn) left eigenvector seed, max end
    vlo: torch.Tensor  # (S, B, dn)
    ulo: torch.Tensor  # (S, B, dn)
    lam: torch.Tensor  # (S, B, 2) previous (lo, hi) estimates; zeros = cold


def make_herm_state(w) -> HermState:
    """Build a HermState around an iterate tensor of shape (..., d, n, n)."""
    dn = w.shape[-3] * w.shape[-1]
    kw = dict(dtype=w.dtype, device=w.device)
    ones = torch.full(w.shape[:-3] + (dn,), 1.0 / (dn ** 0.5), **kw)
    lam = torch.zeros(w.shape[:-3] + (2,), **kw)
    return HermState(w=w, vhi=ones, uhi=ones, vlo=ones, ulo=ones, lam=lam)


class HermStepCache(NamedTuple):
    WS: torch.Tensor  # (S, B, d, n, n): W * minus_s (d<=4) or minus_s (d=8)
    seeds: tuple = ()  # updated (vhi, uhi, vlo, ulo) for d <= 4
    lam: Optional[torch.Tensor] = None  # (S, B, 2) updated estimates


def _trace0(X):
    """sum_b tr(X_b[0]) per scenario: the real part's trace, for
    (S, B, d, n, n) tensors."""
    return torch.diagonal(X[:, :, 0], dim1=-2, dim2=-1).sum(dim=(1, 2))


@dataclasses.dataclass(frozen=True)
class HermitianCone:
    """S x B Hermitian-PSD LMIs over a d-dimensional algebra."""

    A: torch.Tensor  # (S, B, v, d, n, n)
    C: torch.Tensor  # (S, B, d, n, n)
    vars_: Optional[Tuple[int, ...]] = None

    supports_line_search = False
    dual_scale = 1.0

    @property
    def scenarios(self) -> int:
        return self.A.shape[0]

    @property
    def batch(self) -> int:
        return self.A.shape[1]

    @property
    def d(self) -> int:
        return self.A.shape[3]

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def num_vars(self) -> int:
        return self.A.shape[2]

    @property
    def octonion(self) -> bool:
        return self.d == 8

    def rank(self) -> int:
        # reference: hermitian_psd.h:57 (rank = matrix order n)
        return self.n * self.batch

    def identity_state(self, dtype):
        e = torch.zeros((self.scenarios, self.batch, self.d, self.n, self.n),
                        dtype=dtype, device=self.A.device)
        e[:, :, 0] = torch.eye(self.n, dtype=dtype, device=self.A.device)
        if self.octonion:
            return e
        return make_herm_state(e)

    def _w(self, state):
        return state if self.octonion else state.w

    def _minus_s(self, y, k):
        # reference: ComputeNegativeSlack (hermitian_psd.h:104-109)
        return (torch.einsum("sv,sbvdij->sbdij", y, self.A)
                - per_scenario(k, 5) * self.C)

    def _waw(self, w, x):
        """W x W for associative algebras, Q(W)x for octonions
        (hermitian_psd.cc:182-187)."""
        if self.octonion:
            return hc.quadratic_representation(w, x)
        return hc.multiply(w, hc.multiply(x, w))

    def schur(self, state) -> SchurOut:
        # reference: ConstructSchurComplementSystem (hermitian_psd.cc:170-230).
        # The JAX package vmaps W A_v W over v; here w broadcasts along it.
        w = self._w(state)
        WAW = self._waw(w[:, :, None], self.A)  # (S, B, v, d, n, n)
        WCW = self._waw(w, self.C)
        return SchurOut(
            G=torch.einsum("sbudij,sbvdij->suv", self.A, WAW),
            AW=torch.einsum("sbvdij,sbdij->sv", self.A, w),
            AQc=torch.einsum("sbdij,sbvdij->sv", self.C, WAW),
            w_dot_c=torch.einsum("sbdij,sbdij->s", self.C, w),
            c_dot_Qc=torch.einsum("sbdij,sbdij->s", self.C, WCW),
        )

    def _extreme_eigs(self, WS, state: HermState):
        """(lo, hi, seeds, lam) spectrum extremes of WS via the real
        representation R(WS) (eigenvalues appear with multiplicity d).

        The JAX package picks the cold squaring estimator or the warm power
        iteration with a ``lax.cond`` on ``max|lam| == 0``, which vmap makes
        a choice per scenario.  Here it is a per-scenario select, and the
        cold estimator runs only when some scenario is cold (one host sync
        to find out), as in cones/psd.py."""
        R = hc.real_representation(WS)
        if FORCE_COLD:
            return sym.extreme_eigenvalues_seeded(R)
        is_cold = torch.amax(torch.abs(state.lam), dim=(1, 2)) == 0.0  # (S,)
        counters["sync.cone.cold"] += 1
        n_cold = int(is_cold.sum())
        cold = sym.extreme_eigenvalues_seeded(R) if n_cold else None
        if n_cold == is_cold.shape[0]:
            return cold
        # Step count scales with the real representation's order dn, as in
        # the JAX package (clustered spectra at large order stall the mu
        # progression at the fixed 16 steps).
        steps = max(16, min(64, R.shape[-1] // 6))
        warm = sym.extreme_eigenvalues_warm(
            R, state.vhi, state.uhi, state.vlo, state.ulo, state.lam,
            num_steps=steps,
        )
        if cold is None:
            return warm
        return tree_select(is_cold, cold, warm)

    def prepare_step(self, state, y, c_weight, e_weight):
        w = self._w(state)
        minus_s = self._minus_s(y, c_weight)
        if self.octonion:
            # reference: PrepareStep<Octonions> (hermitian_psd.cc:130-145)
            trace_ws = hc.trace_inner_product(w, minus_s)  # (S, B)
            qws = hc.quadratic_representation(w, minus_s)
            normsq = torch.sum(
                hc.trace_inner_product(qws, minus_s) + 2.0 * trace_ws, dim=1
            ) + self.rank()
            norminf = torch.amax((trace_ws + self.n) / 3.0, dim=1)
            return HermStepCache(WS=minus_s), norminf, normsq

        # reference: PrepareStep<T> (hermitian_psd.cc:33-71)
        WS = hc.multiply(w, minus_s)
        lo, hi, seeds, lam = self._extreme_eigs(WS, state)
        norminf = torch.amax(
            torch.maximum(torch.abs(e_weight + lo), torch.abs(e_weight + hi)),
            dim=1,
        )
        # Component 0 only: the real part carries the trace.
        normsq = (_trace0(hc.multiply(WS, WS)) + 2.0 * _trace0(WS)
                  + self.rank())
        return HermStepCache(WS=WS, seeds=seeds, lam=lam), norminf, normsq

    def take_step(self, state, cache: HermStepCache, step_size):
        w = self._w(state)
        step = per_scenario(step_size, 5)
        if self.octonion:
            # reference: TakeStep<Octonions> (hermitian_psd.cc:116-128)
            return hc.geodesic_update_scaled(w, step * cache.WS)
        # reference: TakeStep<T> (hermitian_psd.cc:9-31)
        d_alg = cache.WS + hc.identity(self.d, self.n, w.dtype, w.device)
        expd = hc.exponential_map(step * d_alg)
        w_new = hc.make_hermitian(hc.multiply(expd, w))
        vhi, uhi, vlo, ulo = cache.seeds
        return HermState(
            w=w_new, vhi=vhi, uhi=uhi, vlo=vlo, ulo=ulo, lam=cache.lam
        )

    def affine_step(self, state, y, e_weight):
        # reference: PrepareStep affine branch (hermitian_psd.cc:43-57);
        # octonions use the Q-representation linearization.
        w = self._w(state)
        minus_s = self._minus_s(y, 0.0)
        e = per_scenario(e_weight, 5)
        if self.octonion:
            return (1.0 + e) * w + hc.quadratic_representation(w, minus_s)
        WS = hc.multiply(w, minus_s)
        return state._replace(w=(1.0 + e) * w + hc.multiply(WS, w))

    def slack_stats(self, state, y, c_weight) -> SlackStats:
        w = self._w(state)
        minus_s = self._minus_s(y, c_weight)
        if self.octonion:
            # reference heuristics: GetWeightedSlackEigenvalues<Octonions>
            # (hermitian_psd.cc:147-168)
            qws = hc.quadratic_representation(w, minus_s)
            frob = hc.trace_inner_product(qws, minus_s)  # (S, B)
            tr_ws = hc.trace_inner_product(w, minus_s)
            lam_max = torch.abs(frob) / (1e-15 + torch.abs(tr_ws))
            lam_min = 0.01 * lam_max
            return SlackStats(
                lam_min=torch.amin(lam_min, dim=1),
                lam_max=torch.amax(lam_max, dim=1),
                frob_sq=torch.sum(frob, dim=1),
                trace=-torch.sum(tr_ws, dim=1),
            )
        WS = hc.multiply(w, minus_s)
        lo, hi, _, _ = self._extreme_eigs(WS, state)
        return SlackStats(
            lam_min=torch.amin(-hi, dim=1),
            lam_max=torch.amax(-lo, dim=1),
            frob_sq=_trace0(hc.multiply(WS, WS)),
            trace=-_trace0(WS),
        )

    def dual_variable(self, state):
        return self._w(state)

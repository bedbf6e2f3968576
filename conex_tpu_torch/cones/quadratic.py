"""Q-weighted second-order cones and the quadratic epigraph, batched.

Twin of ``conex_tpu/cones/quadratic.py``.  One block holds, for each of S
scenarios, B same-dimension cones ``c_b - A_b y`` in the Lorentz cone
under the inner product <x, y> = x0 y0 + x1' Q y1 (Q PSD; Q = None means
the identity, the plain SOC).  Every tensor carries the scenario axis
first: A (S, B, n+1, v), c (S, B, n+1), Q (S, B, n, n), the precomputed
A_gram = A1' Q A1 (S, B, v, v), and the iterate w (S, B, n+1).

All spectral work is closed-form in the two Q-weighted eigenvalues
x0 +/- |x1|_Q, and the Schur complement uses the reference's
rank-structured closed form (quadratic_cone_constraint.cc:239-290)

    A' Q(w) A = -det(w) (A0 A0' - A1' Q A1) + 2 (A1'Q w1 + A0 w0)(...)'

with A_gram computed once at construction (``build``), as in the JAX
package, which computes it outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .base import SchurOut, SlackStats, per_scenario


class QuadStepCache(NamedTuple):
    d0: torch.Tensor  # (S, B)
    d1: torch.Tensor  # (S, B, n)
    w0s: torch.Tensor  # (S, B) sqrt(w) scalar part
    w1s: torch.Tensor  # (S, B, n) sqrt(w) vector part


@dataclasses.dataclass(frozen=True)
class QuadraticCone:
    """S x B Q-weighted Lorentz cones: c_sb - A_sb y_s in K_Q."""

    A: torch.Tensor  # (S, B, n+1, v)
    c: torch.Tensor  # (S, B, n+1)
    Q: Optional[torch.Tensor]  # (S, B, n, n) or None for the identity
    A_gram: torch.Tensor  # (S, B, v, v) = A1' Q A1 (precomputed)
    vars_: Optional[Tuple[int, ...]] = None

    supports_line_search = False
    dual_scale = 2.0

    @staticmethod
    def build(A, c, Q=None, vars_=None):
        A1 = A[:, :, 1:, :]
        if Q is None:
            A_gram = torch.einsum("sbnv,sbnu->sbvu", A1, A1)
        else:
            A_gram = torch.einsum("sbnv,sbnm,sbmu->sbvu", A1, Q, A1)
        return QuadraticCone(A=A, c=c, Q=Q, A_gram=A_gram, vars_=vars_)

    @property
    def scenarios(self) -> int:
        return self.A.shape[0]

    @property
    def batch(self) -> int:
        return self.A.shape[1]

    @property
    def n(self) -> int:
        return self.A.shape[2] - 1

    @property
    def num_vars(self) -> int:
        return self.A.shape[3]

    def rank(self) -> int:
        return 2 * self.batch

    def identity_state(self, dtype) -> torch.Tensor:
        e = torch.zeros(self.c.shape, dtype=dtype, device=self.A.device)
        e[..., 0] = 1.0
        return e

    # -- Q-metric helpers --------------------------------------------------

    def _qx(self, x1):
        """Q x1 per cone; the identity if Q is None."""
        if self.Q is None:
            return x1
        return torch.einsum("sbnm,sbm->sbn", self.Q, x1)

    def _qnorm2(self, x1):
        return torch.sum(x1 * self._qx(x1), dim=-1)

    def _qip(self, x1, y1):
        return torch.sum(x1 * self._qx(y1), dim=-1)

    def _spectral(self, f, x0, x1):
        """f applied on the spectrum: the parts of f(lam+)P+ + f(lam-)P-.

        reference: Exp/Sqrt (quadratic_cone_constraint.cc:57-74).
        """
        k = torch.sqrt(torch.abs(self._qnorm2(x1)))
        fp = f(x0 + k)
        fm = f(x0 - k)
        positive = k > 0
        safe_k = torch.where(positive, k, torch.ones_like(k))
        coef = torch.where(positive, 0.5 * (fp - fm) / safe_k, torch.zeros_like(k))
        return 0.5 * (fp + fm), x1 * coef[..., None]

    def _quad_rep(self, x0, x1, y0, y1):
        """Q(x) y in the Q-metric (quadratic_cone_constraint.cc:39-55)."""
        det_x = x0 * x0 - self._qnorm2(x1)
        scale = 2.0 * (x0 * y0 + self._qip(x1, y1))
        z0 = scale * x0 - det_x * y0
        z1 = scale[..., None] * x1 + det_x[..., None] * y1
        return z0, z1

    def _minus_s(self, y, k):
        ms = (torch.einsum("sbnv,sv->sbn", self.A, y)
              - per_scenario(k, 3) * self.c)
        return ms[..., 0], ms[..., 1:]

    # -- cone interface ----------------------------------------------------

    def schur(self, w: torch.Tensor) -> SchurOut:
        # reference: ConstructSchurComplementSystem
        # (quadratic_cone_constraint.cc:239-290); everything x2 at the end
        # for the Jordan trace inner product.
        w0, w1 = w[..., 0], w[..., 1:]
        A0 = self.A[:, :, 0, :]  # (S, B, v)
        A1 = self.A[:, :, 1:, :]  # (S, B, n, v)
        C0, C1 = self.c[..., 0], self.c[..., 1:]
        Qw1 = self._qx(w1)
        QC1 = self._qx(C1)
        det_w = w0 * w0 - torch.sum(w1 * Qw1, dim=-1)
        A_dot_x = torch.einsum("sbnv,sbn->sbv", A1, Qw1)  # A1' Q w1
        r = A_dot_x + A0 * w0[..., None]  # (S, B, v)
        G = torch.einsum(
            "sb,sbvu->svu", det_w,
            self.A_gram - torch.einsum("sbv,sbu->sbvu", A0, A0),
        ) + 2.0 * torch.einsum("sbv,sbu->svu", r, r)
        AW = torch.sum(r, dim=1)
        AQC1 = torch.einsum("sbnv,sbn->sbv", A1, QC1)
        scale = torch.sum(w1 * QC1, dim=-1) + C0 * w0
        AQc = torch.einsum("sb,sbv->sv", det_w, AQC1 - A0 * C0[..., None]) + \
            2.0 * torch.einsum("sb,sbv->sv", scale, r)
        c_dot_x = torch.sum(C1 * Qw1, dim=-1)
        c_dot_Qc = torch.sum(
            det_w * (torch.sum(C1 * QC1, dim=-1) - C0 * C0)
            + 2.0 * (c_dot_x + C0 * w0) * scale, dim=1,
        )
        w_dot_c = torch.sum(scale, dim=1)
        return SchurOut(
            G=2.0 * G,
            AW=2.0 * AW,
            AQc=2.0 * AQc,
            w_dot_c=2.0 * w_dot_c,
            c_dot_Qc=2.0 * c_dot_Qc,
        )

    def prepare_step(self, w, y, c_weight, e_weight):
        # reference: PrepareStep (quadratic_cone_constraint.cc:175-207)
        ms0, ms1 = self._minus_s(y, c_weight)
        w0s, w1s = self._spectral(torch.sqrt, w[..., 0], w[..., 1:])
        d0, d1 = self._quad_rep(w0s, w1s, ms0, ms1)
        d0 = d0 + per_scenario(e_weight, 2)
        k = torch.sqrt(torch.abs(self._qnorm2(d1)))
        ev_hi, ev_lo = d0 + k, d0 - k
        norminf = torch.amax(torch.maximum(torch.abs(ev_hi), torch.abs(ev_lo)), dim=1)
        normsq = torch.sum(ev_hi**2 + ev_lo**2, dim=1)
        return QuadStepCache(d0=d0, d1=d1, w0s=w0s, w1s=w1s), norminf, normsq

    def take_step(self, w, cache: QuadStepCache, step_size):
        # reference: TakeStep (quadratic_cone_constraint.cc:117-137)
        d0 = per_scenario(step_size, 2) * cache.d0
        d1 = per_scenario(step_size, 3) * cache.d1
        e0, e1 = self._spectral(torch.exp, d0, d1)
        z0, z1 = self._quad_rep(cache.w0s, cache.w1s, e0, e1)
        return torch.cat([z0[..., None], z1], dim=-1)

    def affine_step(self, w, y, e_weight):
        # First-order W += Q(w) s linearization (dual recovery); the
        # reference quadratic cone has no affine branch.
        ms0, ms1 = self._minus_s(y, 0.0)
        z0, z1 = self._quad_rep(w[..., 0], w[..., 1:], ms0, ms1)
        z = torch.cat([z0[..., None], z1], dim=-1)
        return (1.0 + per_scenario(e_weight, 3)) * w + z

    def slack_stats(self, w, y, c_weight) -> SlackStats:
        # reference: GetWeightedSlackEigenvalues
        # (quadratic_cone_constraint.cc:138-173)
        ms0, ms1 = self._minus_s(y, c_weight)
        w0s, w1s = self._spectral(torch.sqrt, w[..., 0], w[..., 1:])
        z0, z1 = self._quad_rep(w0s, w1s, ms0, ms1)
        k = torch.sqrt(torch.abs(self._qnorm2(z1)))
        lam_max = -(z0 - k)
        lam_min = -(z0 + k)
        return SlackStats(
            lam_min=torch.amin(lam_min, dim=1),
            lam_max=torch.amax(lam_max, dim=1),
            frob_sq=torch.sum(lam_max**2 + lam_min**2, dim=1),
            trace=torch.sum(lam_max + lam_min, dim=1),
        )

    def dual_variable(self, w):
        return w


def epigraph_cone_data(Qi: torch.Tensor):
    """(Q, A, b) of the Lorentz-cone encoding of t >= 1/2 x'Qi x, for one
    (nz, nz) Qi.

    reference: AddQuadraticCostEpigraph (quadratic_cone_constraint.h:91-118):
    with z the cost variables and t the epigraph variable,
    (0.5 t + 1)^2 >= (0.5 t - 1)^2 + x'Qi x  <=>  2 t >= x'Qi x.
    """
    nz = Qi.shape[0]
    kw = dict(dtype=Qi.dtype, device=Qi.device)
    Q = torch.zeros((nz + 1, nz + 1), **kw)
    Q[0, 0] = 1.0
    Q[1:, 1:] = Qi
    A = torch.zeros((nz + 2, nz + 1), **kw)
    A[0, nz] = -0.5
    A[1, nz] = -0.5
    A[2:, :nz] = torch.eye(nz, **kw)
    b = torch.zeros((nz + 2,), **kw)
    b[0] = 1.0
    b[1] = -1.0
    return Q, A, b

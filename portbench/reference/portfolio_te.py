"""The tracking-error-limited portfolio SOCP, solved and checked plainly.

For F (n, k), D (n,) > 0, mu (n,), a benchmark portfolio x_b (n,) and caps
sigma and tau, the program (Jorion, "Portfolio optimization with
tracking-error constraints", Financial Analysts Journal 59(5), 2003) is,
over v = (x, f) with Sigma = F F' + diag(D):

    maximize   mu'x
    s.t.       (sigma; sqrt(D) x; f)                   in Q^{1+n+k}
               (tau;   sqrt(D) (x - x_b); f - F'x_b)   in Q^{1+n+k}
               F'x - f = 0,  1'x = 1,  0 <= x <= 1.

Both cones are c_b - A y in Q^{1+n+k} with one A = [0; -diag(sqrt D), 0;
0, -I_k] and c_1 = (sigma, 0, 0), c_2 = (tau, -sqrt(D) x_b, -F'x_b).

``solve_plain`` solves a batch of them by a primal-dual interior-point
method with Nesterov-Todd scaling and Mehrotra's predictor-corrector
(Alizadeh and Goldfarb, "Second-order cone programming", Math. Prog. 95,
2003, section 5; the scaling in the form of Vandenberghe's notes on the
CVXOPT cone solvers), over the cone K = R_+^{2n} x Q x Q of the box rows
and both cones, and certifies each answer by its own multipliers: the
relative gap between the primal and the dual objective, and the relative
residuals of stationarity, of the equality rows and of the cone rows, with
every slack and multiplier inside K.  ``schur_plain`` is the Schur block
that conex forms for a Lorentz-cone block at an iterate w, written from
the quadratic representation Q(w) = 2 w w' - det(w) R, R = diag(1, -1,
..., -1); ``assemble_plain`` builds conex's KKT matrix of the program from
it, for portfolio_qp.ldlt_plain.

Plain PyTorch in float64; it imports nothing of the port.  Every function
takes batches (a leading program axis).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .portfolio_qp import exact, rows

# What a certified answer keeps to: its relative duality gap, and its
# relative residuals of stationarity, of the equality rows and of the cone
# rows; a hundred times below the configuration's 1e-7.  The iterations go
# on towards portfolio_qp's bars (TARGET_GAP, TARGET_RESIDUAL) until a
# program reaches them or its best iterate has not improved for STALL
# iterations: near a Lorentz cone's boundary the last digits of a step are
# rounding, and an iterate can come within reach of the bars and leave.
GAP_BAR = 1e-9
RESIDUAL_BAR = 1e-10
TARGET_GAP = 1e-11
TARGET_RESIDUAL = 1e-12
STALL = 3
MAX_ITERATIONS = 100
STEP_TO_BOUNDARY = 0.99
# Rounds of iterative refinement of each Newton step: one leaves the last
# steps' residuals at 1e-10 on the portfolios of n = 40.
REFINEMENTS = 3


class Caps(NamedTuple):
    """The benchmark portfolio x_b (P, n), its factor exposure F'x_b (P, k)
    and the caps sigma and tau (P,) of each program."""

    x_b: torch.Tensor
    f_b: torch.Tensor
    sigma: torch.Tensor
    tau: torch.Tensor


class Optimum(NamedTuple):
    """Each program's answer v = (x, f), its multipliers (lam of the rows
    F'x - f = 0 and 1'x = 1; z of the cone rows: the 2n box rows, then
    both cones), objective mu'x, relative gap and largest relative
    residual, and whether both keep to their bars."""

    v: torch.Tensor
    lam: torch.Tensor
    z: torch.Tensor
    objective: torch.Tensor
    gap: torch.Tensor
    residual: torch.Tensor
    certified: torch.Tensor


def _f64(*ts):
    return tuple(t.to(torch.float64) for t in ts)


def caps(F, D, tracking=0.25):
    """x_b = 1/n, an equal-weighted index; sigma = sigma_b = sqrt(x_b' Sigma
    x_b), the index's own volatility; tau = ``tracking`` sigma_b."""
    F, D = _f64(F, D)
    P, n, _ = F.shape
    x_b = F.new_full((P, n), 1.0 / n)
    f_b = (F.transpose(1, 2) @ x_b[..., None])[..., 0]
    sigma = torch.sqrt((D * x_b * x_b).sum(-1) + (f_b * f_b).sum(-1))
    return Caps(x_b=x_b, f_b=f_b, sigma=sigma, tau=tracking * sigma)


def cones(F, D, cap: Caps):
    """A (P, 2, 1+n+k, n+k) and c (P, 2, 1+n+k) of both cones, c_b - A y in
    Q^{1+n+k}: the total risk first, the tracking error second."""
    F, D = _f64(F, D)
    P, n, k = F.shape
    A = F.new_zeros(P, 1 + n + k, n + k)
    A[:, 1:1 + n, :n] = -torch.diag_embed(D.sqrt())
    A[:, 1 + n:, n:] = -torch.eye(k, dtype=F.dtype, device=F.device)
    c1 = torch.cat([cap.sigma[:, None], F.new_zeros(P, n + k)], dim=1)
    c2 = torch.cat([cap.tau[:, None], -D.sqrt() * cap.x_b, -cap.f_b], dim=1)
    return torch.stack([A, A], dim=1), torch.stack([c1, c2], dim=1)


def box(P, n, k, like):
    """The 2n box rows c - A y >= 0 over y = (x, f): x <= 1, then -x <= 0."""
    eye = torch.eye(n, dtype=torch.float64, device=like.device).expand(P, n, n)
    zeros = like.new_zeros(P, n, k, dtype=torch.float64)
    A = torch.cat([torch.cat([eye, zeros], dim=2), torch.cat([-eye, zeros], dim=2)], dim=1)
    c = torch.cat([like.new_ones(P, n, dtype=torch.float64),
                   like.new_zeros(P, n, dtype=torch.float64)], dim=1)
    return A, c


def objective(mu, v):
    """mu'x of each program, v = (x, f)."""
    mu, v = _f64(mu, v)
    return (mu * v[..., :mu.shape[-1]]).sum(-1)


# The cone K = R_+^{2n} x Q x Q, its slacks and multipliers held as (the
# 2n entries of the box, (P, 2, 1+n+k) of the cones).


def _det(u):
    """u_0^2 - |u_1|^2 of each Lorentz-cone element, as (u_0 - |u_1|)(u_0 +
    |u_1|), which keeps its digits near the cone's boundary."""
    norm = u[..., 1:].norm(dim=-1)
    return (u[..., 0] - norm) * (u[..., 0] + norm)


def _apply_j(u):
    return torch.cat([u[..., :1], -u[..., 1:]], dim=-1)


def _circ(u, t):
    """The Jordan product u o t of each Lorentz-cone element:
    (u't, u_0 t_1 + t_0 u_1)."""
    head = (u * t).sum(-1, keepdim=True)
    return torch.cat([head, u[..., :1] * t[..., 1:] + t[..., :1] * u[..., 1:]], dim=-1)


def _inv_circ(u, r):
    """t with u o t = r, for u inside the cone."""
    t0 = (u[..., 0] * r[..., 0] - (u[..., 1:] * r[..., 1:]).sum(-1)) / _det(u)
    t1 = (r[..., 1:] - t0[..., None] * u[..., 1:]) / u[..., :1]
    return torch.cat([t0[..., None], t1], dim=-1)


class _Scaling(NamedTuple):
    """The Nesterov-Todd scaling W of each cone: W = diag(d) on the box
    rows; W = beta (2 q q' - J) on a Lorentz cone, q'Jq = 1."""

    d: torch.Tensor
    beta: torch.Tensor
    q: torch.Tensor

    def apply(self, u, t):
        """W (u, t)."""
        b = self.beta[..., None]
        return self.d * u, b * (2.0 * self.q * (self.q * t).sum(-1, keepdim=True) - _apply_j(t))

    def inverse(self, u, t):
        """W^-1 (u, t)."""
        jq = _apply_j(self.q)
        b = self.beta[..., None]
        return u / self.d, (2.0 * jq * (jq * t).sum(-1, keepdim=True) - _apply_j(t)) / b


def _scaling(s_lp, s_soc, z_lp, z_soc) -> _Scaling:
    """The point W with W z = W^-1 s for s, z inside K."""
    s_bar = s_soc / _det(s_soc).sqrt()[..., None]
    z_bar = z_soc / _det(z_soc).sqrt()[..., None]
    gamma = ((1.0 + (s_bar * z_bar).sum(-1)) / 2.0).sqrt()
    w_bar = (s_bar + _apply_j(z_bar)) / (2.0 * gamma[..., None])
    e = torch.zeros_like(w_bar)
    e[..., 0] = 1.0
    q = (w_bar + e) / (2.0 * (w_bar[..., :1] + 1.0)).sqrt()
    beta = (_det(s_soc) / _det(z_soc)) ** 0.25
    return _Scaling(d=(s_lp / z_lp).sqrt(), beta=beta, q=q)


def _largest_step(u_lp, u_soc, du_lp, du_soc):
    """The largest alpha in (0, 1] with u + alpha du inside K, per program:
    on a Lorentz cone the least positive root of det(u + alpha du)."""
    ratio = torch.where(du_lp < 0, -u_lp / du_lp, torch.full_like(u_lp, float("inf")))
    alpha = ratio.amin(-1)
    a = _det(du_soc)
    b = 2.0 * (u_soc * _apply_j(du_soc)).sum(-1)
    c = _det(u_soc)
    disc = b * b - 4.0 * a * c
    root = disc.clamp(min=0.0).sqrt()
    sgn = torch.where(b >= 0, torch.ones_like(b), -torch.ones_like(b))
    big = -0.5 * (b + sgn * root)
    inf = torch.full_like(c, float("inf"))
    r1 = torch.where(a != 0, big / a, inf)
    r2 = torch.where(big != 0, c / big, inf)
    pos = lambda r: torch.where((r > 0) & torch.isfinite(r), r, inf)
    cone = torch.where(disc >= 0, torch.minimum(pos(r1), pos(r2)), inf)
    return torch.minimum(alpha, cone.amin(-1)).clamp(max=1.0)


class _Program(NamedTuple):
    """minimize g'v s.t. E v = e and h - G v in K, the box rows and the
    cones held apart."""

    g: torch.Tensor
    E: torch.Tensor
    e: torch.Tensor
    G_lp: torch.Tensor
    h_lp: torch.Tensor
    G_soc: torch.Tensor
    h_soc: torch.Tensor


def _program(F, D, mu, cap: Caps) -> _Program:
    F, D, mu = _f64(F, D, mu)
    P, n, k = F.shape
    E, e = rows(F)
    G_lp, h_lp = box(P, n, k, F)
    G_soc, h_soc = cones(F, D, cap)
    g = torch.cat([-mu, F.new_zeros(P, k)], dim=1)
    return _Program(g=g, E=E, e=e, G_lp=G_lp, h_lp=h_lp, G_soc=G_soc, h_soc=h_soc)


def _g_times(pr: _Program, v):
    """(G v) of the box rows and of the cones."""
    return ((pr.G_lp @ v[..., None])[..., 0],
            torch.einsum("pbrv,pv->pbr", pr.G_soc, v))


def _gt_times(pr: _Program, u, t):
    """G'(u, t)."""
    return ((pr.G_lp.transpose(1, 2) @ u[..., None])[..., 0]
            + torch.einsum("pbrv,pbr->pv", pr.G_soc, t))


def _residuals(pr: _Program, v, lam, z_lp, z_soc, s_lp, s_soc):
    """Stationarity g + G'z - E'lam, the rows' E v - e and the cone rows'
    G v + s - h."""
    r_v = pr.g + _gt_times(pr, z_lp, z_soc) - (pr.E.transpose(1, 2) @ lam[..., None])[..., 0]
    r_e = (pr.E @ v[..., None])[..., 0] - pr.e
    gv_lp, gv_soc = _g_times(pr, v)
    return r_v, r_e, gv_lp + s_lp - pr.h_lp, gv_soc + s_soc - pr.h_soc


@exact
def solve_plain(F, D, mu, cap: Caps = None, max_iterations: int = MAX_ITERATIONS,
                tracking: bool = True) -> Optimum:
    """The optimum of each program of the batch: F (P, n, k), D and mu
    (P, n), the caps (``caps(F, D)`` by default).  Without ``tracking``
    the tracking-error cone is left out (for tests)."""
    F, D, mu = _f64(F, D, mu)
    cap = caps(F, D) if cap is None else cap
    pr = _program(F, D, mu, cap)
    if not tracking:
        pr = pr._replace(G_soc=pr.G_soc[:, :1], h_soc=pr.h_soc[:, :1])
    P, n, k = F.shape
    nc = pr.G_soc.shape[1]
    degree = 2 * n + nc
    v = torch.cat([cap.x_b, cap.f_b], dim=1)
    lam = F.new_zeros(P, k + 1)
    z_lp, s_lp = F.new_ones(P, 2 * n), F.new_ones(P, 2 * n)
    e_soc = F.new_zeros(P, nc, 1 + n + k)
    e_soc[..., 0] = 1.0
    z_soc, s_soc = e_soc.clone(), e_soc.clone()

    def step(W, lam_lp, lam_soc, done):
        """The Newton step's solver at the scaling W: for the residuals r
        and the centrality target c = lam o (W dz + W^-1 ds), dz and ds
        eliminated, the normal matrix G'W^-2 G and the rows' Schur
        complement, factored once and solved densely, then REFINEMENTS
        rounds of iterative refinement on the whole linear system.

        Both cones' first rows are zero (the caps are constants), so JG =
        -G, and on a cone with W^-1 = (2 Jq q'J - J) / beta the normal
        matrix is G'W^-2 G = (G'G + 4 (1 + q'q) a a') / beta^2 with a =
        G'Jq: a part that keeps its digits and a rank-one term that grows
        without bound near the cone's boundary.  The first, with the box
        rows', is factored by Cholesky, and the rank-one terms are added
        by the Sherman-Morrison-Woodbury formula; formed whole, the sum
        loses its small eigenvalues and stops being positive definite."""
        Wg_lp = pr.G_lp / W.d[..., None]
        jq = _apply_j(W.q)
        beta = W.beta[..., None]
        a = torch.einsum("pbr,pbrv->pbv", jq, pr.G_soc)
        Wg_soc = (2.0 * jq[..., None] * a[:, :, None, :]
                  - _apply_j(pr.G_soc.transpose(2, 3)).transpose(2, 3)) / beta[..., None]
        Gb = pr.G_soc / beta[..., None]
        C = (2.0 * (1.0 + (W.q * W.q).sum(-1, keepdim=True)).sqrt() * a / beta).transpose(1, 2)
        H = Wg_lp.transpose(1, 2) @ Wg_lp + torch.einsum("pbrv,pbru->pvu", Gb, Gb)
        H = torch.where(done[:, None, None], torch.eye(H.shape[-1], dtype=H.dtype,
                                                       device=H.device), H)
        C = torch.where(done[:, None, None], torch.zeros_like(C), C)
        Lh = torch.linalg.cholesky(H)
        HiC = torch.cholesky_solve(C, Lh)
        S = torch.linalg.lu_factor(torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
                                   + C.transpose(1, 2) @ HiC)

        def h_solve(X):
            """(H + C C')^-1 X."""
            Y = torch.cholesky_solve(X, Lh)
            return Y - HiC @ torch.linalg.lu_solve(*S, C.transpose(1, 2) @ Y)

        Et = pr.E.transpose(1, 2)
        HiEt = h_solve(Et)
        M = torch.linalg.lu_factor(pr.E @ HiEt)

        def solve(r_v, r_e, r_lp, r_soc, c_lp, c_soc):
            wr_lp, wr_soc = W.inverse(r_lp, r_soc)
            t_lp, t_soc = wr_lp + c_lp / lam_lp, wr_soc + _inv_circ(lam_soc, c_soc)
            rhs = -r_v - ((Wg_lp.transpose(1, 2) @ t_lp[..., None])[..., 0]
                          + torch.einsum("pbrv,pbr->pv", Wg_soc, t_soc))
            Hir = h_solve(rhs[..., None])[..., 0]
            dlam = torch.linalg.lu_solve(*M, (-r_e - (pr.E @ Hir[..., None])[..., 0])[..., None])
            dv = Hir + (HiEt @ dlam)[..., 0]
            gd_lp = (Wg_lp @ dv[..., None])[..., 0]
            gd_soc = torch.einsum("pbrv,pv->pbr", Wg_soc, dv)
            dz_lp, dz_soc = W.inverse(gd_lp + t_lp, gd_soc + t_soc)
            gv_lp, gv_soc = _g_times(pr, dv)
            return dv, dlam[..., 0], dz_lp, dz_soc, -r_lp - gv_lp, -r_soc - gv_soc

        def refined(r_v, r_e, r_lp, r_soc, c_lp, c_soc):
            d = solve(r_v, r_e, r_lp, r_soc, c_lp, c_soc)
            for _ in range(REFINEMENTS):
                dv, dlam, dz_lp, dz_soc, ds_lp, ds_soc = d
                # What the step leaves of each equation: stationarity, the
                # rows and the centrality (the cone rows hold by ds's form).
                e_v = (r_v + _gt_times(pr, dz_lp, dz_soc)
                       - (pr.E.transpose(1, 2) @ dlam[..., None])[..., 0])
                e_e = r_e + (pr.E @ dv[..., None])[..., 0]
                wz_lp, wz_soc = W.apply(dz_lp, dz_soc)
                ws_lp, ws_soc = W.inverse(ds_lp, ds_soc)
                e_lp = c_lp - lam_lp * (wz_lp + ws_lp)
                e_cone = c_soc - _circ(lam_soc, wz_soc + ws_soc)
                fix = solve(e_v, e_e, torch.zeros_like(r_lp), torch.zeros_like(r_soc), e_lp,
                            e_cone)
                d = tuple(a + b for a, b in zip(d, fix))
            return d

        return refined

    def pick(which, new, old):
        return tuple(torch.where(which.view((-1,) + (1,) * (x.dim() - 1)), x, y)
                     for x, y in zip(new, old))

    # Each program's best iterate so far, by the larger of its gap and
    # residual over their targets; the certificate is given to the best.
    best, merit = None, None
    done = torch.zeros(P, dtype=torch.bool, device=F.device)
    for _ in range(max_iterations):
        r_v, r_e, r_lp, r_soc = _residuals(pr, v, lam, z_lp, z_soc, s_lp, s_soc)
        gap = (s_lp * z_lp).sum(-1) + (s_soc * z_soc).sum((-2, -1))
        mu_c = gap / degree
        rel_gap, res = _measure(pr, mu, v, lam, z_lp, z_soc, r_v, r_e, r_lp, r_soc)
        state = (v, lam, z_lp, z_soc, s_lp, s_soc)
        now = torch.maximum(rel_gap / TARGET_GAP, res / TARGET_RESIDUAL)
        if best is None:
            best, merit, since = state, now, torch.zeros_like(now)
        else:
            better = now < merit
            best, merit = pick(better, state, best), torch.where(better, now, merit)
            since = torch.where(better, torch.zeros_like(since), since + 1)
        # Stalled: a best iterate within the certificate's bars that the
        # last STALL iterations did not better.
        near = merit <= min(GAP_BAR / TARGET_GAP, RESIDUAL_BAR / TARGET_RESIDUAL)
        done = done | (merit <= 1.0) | (near & (since >= STALL))
        if bool(done.all()):
            break
        W = _scaling(s_lp, s_soc, z_lp, z_soc)
        # A program whose scaling is no longer finite (a multiplier's
        # determinant lost to rounding) stops where it is, under an
        # identity scaling that keeps the batch's factors finite; its
        # certificate says whether it got there.
        ok = (torch.isfinite(W.d).all(-1) & torch.isfinite(W.beta).all(-1)
              & torch.isfinite(W.q).all(-1).all(-1))
        done = done | ~ok
        W = _Scaling(d=torch.where(ok[:, None], W.d, torch.ones_like(W.d)),
                     beta=torch.where(ok[:, None], W.beta, torch.ones_like(W.beta)),
                     q=torch.where(ok[:, None, None], W.q, e_soc))
        lam_lp, lam_soc = W.apply(z_lp, z_soc)
        newton = step(W, lam_lp, lam_soc, done)
        # Predictor: the affine step, lam o (W dz + W^-1 ds) = -lam o lam.
        dv, dlam, dzl, dzs, dsl, dss = newton(r_v, r_e, r_lp, r_soc,
                                              -lam_lp * lam_lp, -_circ(lam_soc, lam_soc))
        a_p = _largest_step(s_lp, s_soc, dsl, dss)
        a_d = _largest_step(z_lp, z_soc, dzl, dzs)
        a = torch.minimum(a_p, a_d)[:, None]
        gap_aff = (((s_lp + a * dsl) * (z_lp + a * dzl)).sum(-1)
                   + ((s_soc + a[..., None] * dss) * (z_soc + a[..., None] * dzs)).sum((-2, -1)))
        sigma = (gap_aff / gap.clamp(min=1e-300)).clamp(0.0, 1.0) ** 3
        # Corrector: centering and the second-order term, in the scaled
        # directions W^-1 ds and W dz.
        sd_lp, sd_soc = W.inverse(dsl, dss)
        zd_lp, zd_soc = W.apply(dzl, dzs)
        target = (sigma * mu_c)[:, None]
        c_lp = -lam_lp * lam_lp - sd_lp * zd_lp + target
        c_soc = -_circ(lam_soc, lam_soc) - _circ(sd_soc, zd_soc)
        c_soc[..., 0] += target
        dv, dlam, dzl, dzs, dsl, dss = newton(r_v, r_e, r_lp, r_soc, c_lp, c_soc)
        a_p = STEP_TO_BOUNDARY * _largest_step(s_lp, s_soc, dsl, dss)
        a_d = STEP_TO_BOUNDARY * _largest_step(z_lp, z_soc, dzl, dzs)
        # One step length for both, as the symmetric method takes; a
        # program that is done stays where it is.
        a = torch.minimum(a_p, a_d).clamp(max=1.0)[:, None]
        v, lam, z_lp, z_soc, s_lp, s_soc = pick(
            done, (v, lam, z_lp, z_soc, s_lp, s_soc),
            (v + a * dv, lam + a * dlam, z_lp + a * dzl, z_soc + a[..., None] * dzs,
             s_lp + a * dsl, s_soc + a[..., None] * dss))
    v, lam, z_lp, z_soc, s_lp, s_soc = best
    return _certify(pr, mu, v, lam, z_lp, z_soc, s_lp, s_soc)


def _inside(u_lp, u_soc):
    return (u_lp >= 0).all(-1) & (u_soc[..., 0] >= u_soc[..., 1:].norm(dim=-1)).all(-1)


def _measure(pr: _Program, mu, v, lam, z_lp, z_soc, r_v, r_e, r_lp, r_soc):
    """The relative gap between the primal objective mu'x and the dual's,
    h'z - e'lam at a stationary point, and the largest relative residual
    of stationarity, the rows and the cone rows."""
    primal = objective(mu, v)
    dual = ((pr.h_lp * z_lp).sum(-1) + (pr.h_soc * z_soc).sum((-2, -1))
            - (pr.e * lam).sum(-1))
    gap = (primal - dual).abs() / (1.0 + primal.abs())
    scale_h = 1.0 + torch.maximum(pr.h_lp.abs().amax(-1), pr.h_soc.abs().amax((-2, -1)))
    residual = torch.maximum(
        torch.maximum(r_v.abs().amax(-1) / (1.0 + pr.g.abs().amax(-1)),
                      r_e.abs().amax(-1) / (1.0 + pr.e.abs().amax(-1))),
        torch.maximum(r_lp.abs().amax(-1), r_soc.abs().amax((-2, -1))) / scale_h)
    return gap, residual


def _certify(pr: _Program, mu, v, lam, z_lp, z_soc, s_lp, s_soc) -> Optimum:
    """The certificate of (v, lam, z): ``_measure``'s gap and residual
    under their bars, the cone rows' slack s = h - G v up to that
    residual, and every slack and multiplier in K."""
    r_v, r_e, r_lp, r_soc = _residuals(pr, v, lam, z_lp, z_soc, s_lp, s_soc)
    gap, residual = _measure(pr, mu, v, lam, z_lp, z_soc, r_v, r_e, r_lp, r_soc)
    inside = _inside(s_lp, s_soc) & _inside(z_lp, z_soc)
    certified = inside & (gap <= GAP_BAR) & (residual <= RESIDUAL_BAR)
    z = torch.cat([z_lp, z_soc.flatten(1)], dim=1)
    return Optimum(v=v, lam=lam, z=z, objective=objective(mu, v), gap=gap,
                   residual=residual, certified=certified)


def quadratic_plain(w):
    """Q(w) = 2 w w' - det(w) R of each Lorentz-cone element (..., d): the
    (..., d, d) matrix."""
    (w,) = _f64(w)
    R = torch.ones(w.shape[-1], dtype=w.dtype, device=w.device)
    R[1:] = -1.0
    return 2.0 * w[..., :, None] * w[..., None, :] - _det(w)[..., None, None] * torch.diag(R)


@exact
def schur_plain(A, c, w):
    """conex's Schur block of a Lorentz-cone block c_b - A_b y in Q at its
    iterate w (P, B, d), with the spin factor's trace inner product 2 u'v:
    G = 2 sum_b A_b' Q(w_b) A_b, AW = 2 sum_b A_b' w_b and AQc = 2 sum_b
    A_b' Q(w_b) c_b."""
    A, c, w = _f64(A, c, w)
    Qw = quadratic_plain(w)
    G = 2.0 * torch.einsum("pbrv,pbrs,pbsu->pvu", A, Qw, A)
    AW = 2.0 * torch.einsum("pbrv,pbr->pv", A, w)
    AQc = 2.0 * torch.einsum("pbrv,pbrs,pbs->pv", A, Qw, c)
    return G, AW, AQc


def assemble_plain(F, D, w_soc, w_box, cap: Caps = None):
    """conex's KKT matrix of the program at the iterates w_soc (P, 2,
    1+n+k) of both cones and w_box (P, 2n) of the box rows: G = the cones'
    Schur block plus diag(w_hi^2 + w_lo^2) on x, then the rows Aeq of
    F'x - f = 0 and 1'x = 1 beside and below it."""
    F, D, w_soc, w_box = _f64(F, D, w_soc, w_box)
    cap = caps(F, D) if cap is None else cap
    P, n, k = F.shape
    m = n + k
    A, c = cones(F, D, cap)
    G, _, _ = schur_plain(A, c, w_soc)
    G.diagonal(dim1=1, dim2=2)[:, :n] += w_box[:, :n] ** 2 + w_box[:, n:] ** 2
    Aeq, _ = rows(F)
    K = F.new_zeros(P, m + k + 1, m + k + 1)
    K[:, :m, :m] = G
    K[:, m:, :m] = Aeq
    K[:, :m, m:] = Aeq.transpose(1, 2)
    return K

"""Fused batched-SOCP solver: the whole geodesic IPM in one CUDA kernel.

Twin of ``conex_tpu/parallel/fused_socp.py``.  Each of S scenarios is

    max b[s]'y  s.t.  c[s, j] - A[s, j] y in Q^{n+1},  j = 0..nc-1,

solved with the divergence mu update, the dense LLT Schur complement and
coldstart or warmstart, exactly as the JAX package's Pallas kernel
(``_make_kernel``'s inner ``kernel``) does: the Schur assembly through
Q(w^1/2), the m x m Cholesky with its fail flag, the triangular solves and
refinement, the mu update, the Newton solve and the spectral-exp step, the
warmstart abort, the statistics and the stall detector, the masked merge
and the dual recovery.

``solve_socp_fused`` is the entry point.  A CUDA tensor goes to
``solve_socp_kernel``, the wrapper of the hand-written kernel in
``csrc/fused_socp.cu`` (float32 or float64), which runs under the plan
``socp_plan`` makes from the shape (lanes per scenario, scenarios per
block, shared memory or global scratch), or the call raises; a CPU
tensor goes to ``solve_socp_plain``, the kernel's body written in plain
PyTorch over a leading scenario axis.  ``solve_socp_kernel.launches``
counts the kernel's launches.

As in the JAX kernel, ``SolverConfig.mu_floor_drop_ratio`` and
``inv_sqrt_mu_cap_scaled`` are not read: the fused path has no
numerical-floor latch and no scaled-k cap, where the general path
(``solver/loop.py``) has both.  On an instance where the latch fires the
two paths differ, in the port as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..config import KKT_SOLVER_LLT, WARMSTART, SolverConfig
from ..solver.mu import SlackAgg, mu_from_divergence


class FusedSOCPResult(NamedTuple):
    """Mirror of solver.loop.SolveResult for the fused path (the two
    per-iteration series the reference exposes through
    CONEX_GetIterationStats, interfaces/conex.cc:259-285)."""

    y: torch.Tensor  # (S, m) primal solution (unscaled)
    solved: torch.Tensor  # (S,) bool
    primal_infeasible: torch.Tensor  # (S,) bool
    dual_infeasible: torch.Tensor  # (S,) bool
    num_iterations: torch.Tensor  # (S,) int32
    w: torch.Tensor  # (S, nc, n+1) final cone iterates / duals
    y_kkt: torch.Tensor  # (S, m) raw final KKT solution
    k: torch.Tensor  # (S,) final inv_sqrt_mu
    warmstart_aborted: torch.Tensor  # (S,) bool
    b_scaling: torch.Tensor  # (S,)
    c_scaling: torch.Tensor  # (S,)
    stats_k: torch.Tensor  # (S, T) sqrt_inv_mu per iteration
    stats_dinf: torch.Tensor  # (S, T) norm_inf_d per iteration
    fail: torch.Tensor  # (S,) bool
    mu_stalled: torch.Tensor  # (S,) bool


class RawResult(NamedTuple):
    """What the kernel (and solve_socp_plain) returns, scenario axis first;
    ``epilogue`` turns it into a FusedSOCPResult."""

    y: torch.Tensor  # (S, m)
    w: torch.Tensor  # (S, nc, n+1)
    k: torch.Tensor  # (S,)
    k_max: torch.Tensor
    b_sc: torch.Tensor
    c_sc: torch.Tensor
    by: torch.Tensor
    cx: torch.Tensor
    fail: torch.Tensor  # (S,) int32
    mir: torch.Tensor  # max iterations reached, int32
    stall: torch.Tensor  # int32
    num_iter: torch.Tensor  # int32
    aborted: torch.Tensor  # int32
    stats_k: torch.Tensor  # (S, T)
    stats_d: torch.Tensor  # (S, T)


def _check_config(config: SolverConfig):
    if config.enable_line_search:
        raise ValueError(
            "fused SOCP path requires divergence-mode mu updates "
            "(the reference SOC kernel has no line search either, "
            "constraint.h:24-28)"
        )
    if config.kkt_solver != KKT_SOLVER_LLT:
        raise ValueError("fused SOCP path factors with LLT only")


def _k_min_clamp(config: SolverConfig) -> float:
    return math.sqrt(1.0 / (1e-15 + config.maximum_mu))


def _init_centering(config: SolverConfig) -> int:
    if config.initialization_mode == WARMSTART:
        return config.initial_centering_steps_warmstart
    return config.initial_centering_steps_coldstart


# ---------------------------------------------------------------------------
# The plain version: the kernel's body over a leading scenario axis.
#
# Every sum is taken left to right from zero, in the kernel's order, and
# csrc/fused_socp.cu is built without FMA contraction, so in f64 the kernel
# and this version give the same bits.  Nothing less would hold them
# together: in a scenario whose k climbs to its cap, a change in the order
# of one sum grows about tenfold each iteration (1e-16 at the start, 6e-7
# after 15 iterations).  The price is launches: one small op per term.
# ---------------------------------------------------------------------------


def _sum(acc, terms):
    """acc + t0 + t1 + ..., left to right (acc is the zero to start from)."""
    for t in terms:
        acc = acc + t
    return acc


def _dot(x, y):
    """sum_r x[..., r] y[..., r] over the spin axis."""
    shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    zero = x.new_zeros(shape)
    return _sum(zero, (x[..., r] * y[..., r] for r in range(x.shape[-1])))


def _tail_sq(x):
    return _sum(x.new_zeros(x.shape[:-1]),
                (x[..., r] * x[..., r] for r in range(1, x.shape[-1])))


def _det(x):
    return x[..., 0] * x[..., 0] - _tail_sq(x)


def _spectral(x, fn):
    """fn(lam1) P1 + fn(lam2) P2, with qhat = 0 where |x1| = 0."""
    h = x[..., 0]
    nq = torch.sqrt(_tail_sq(x))
    f1, f2 = fn(h + nq), fn(h - nq)
    qhat = torch.where(nq[..., None] > 0,
                       x[..., 1:] / torch.where(nq == 0, 1.0, nq)[..., None], 0.0)
    tail = (0.5 * (f1 - f2))[..., None] * qhat
    return torch.cat([(0.5 * (f1 + f2))[..., None], tail], dim=-1)


def _qrep(x, y):
    """Q(x) y = 2 <x,y> x - det(x) R y."""
    two_dot = 2.0 * _dot(x, y)
    dx = _det(x)
    head = two_dot * x[..., 0] + dx * -y[..., 0]
    tail = two_dot[..., None] * x[..., 1:] + dx[..., None] * y[..., 1:]
    return torch.cat([head[..., None], tail], dim=-1)


def _identity_like(w):
    e = torch.zeros_like(w)
    e[..., 0] = 1.0
    return e


def _assemble(A, c, w):
    """SOC Schur-complement contributions summed over the nc cones of each
    scenario (soc_constraint.cc:272-303)."""
    S, nc, n1, m = A.shape
    wsqrt = _spectral(w, torch.sqrt)  # (S, nc, n1)
    WC = _qrep(wsqrt, c)  # Q(w^1/2) c
    zero = A.new_zeros((S, nc, m))
    dot = _sum(zero, (wsqrt[:, :, r, None] * A[:, :, r] for r in range(n1)))
    aw = _sum(zero, (A[:, :, r] * w[:, :, r, None] for r in range(n1)))
    # WA[:, j, :, v] = Q(w^1/2_j) A[:, j, :, v]
    RA = torch.cat([-A[:, :, :1], A[:, :, 1:]], dim=2)
    WA = (2.0 * dot)[:, :, None] * wsqrt[..., None] + _det(wsqrt)[..., None, None] * RA
    terms = [(j, r) for j in range(nc) for r in range(n1)]
    G = 2.0 * _sum(A.new_zeros((S, m, m)),
                   (WA[:, j, r, :, None] * WA[:, j, r, None, :] for j, r in terms))
    AW = 2.0 * _sum(A.new_zeros((S, m)), (aw[:, j] for j in range(nc)))
    AQc = 2.0 * _sum(A.new_zeros((S, m)), (WA[:, j, r] * WC[:, j, r, None] for j, r in terms))
    w_dot_c = 2.0 * _sum(A.new_zeros(S), (WC[:, j, 0] for j in range(nc)))
    c_dot_Qc = 2.0 * _sum(A.new_zeros(S), (WC[:, j, r] * WC[:, j, r] for j, r in terms))
    return wsqrt, G, AW, AQc, w_dot_c, c_dot_Qc


def _minus_slack(A, c, y, c_weight):
    """A y - k c per cone (soc_constraint.cc:193-197)."""
    S, nc, n1, m = A.shape
    Ay = _sum(A.new_zeros((S, nc, n1)), (A[..., v] * y[:, v, None, None] for v in range(m)))
    return Ay - c_weight[:, None, None] * c


def _chol(G):
    """L L^T = G column by column, and the per-scenario fail flag of the JAX
    kernel's ``_chol``: a pivot that is not > 0 or not finite fails, and the
    column goes on with a pivot of 1."""
    S, m, _ = G.shape
    L = torch.zeros_like(G)
    fail = torch.zeros(S, dtype=torch.bool, device=G.device)
    for j in range(m):
        acc = _sum(G.new_zeros((S, m)), (L[:, :, t] * L[:, j, t, None] for t in range(j)))
        col = G[:, :, j] - acc
        pj = col[:, j]
        fail = fail | ~(pj > 0) | ~torch.isfinite(pj)
        d = torch.sqrt(torch.where(pj > 0, pj, 1.0))
        L[:, j + 1:, j] = col[:, j + 1:] / d[:, None]
        L[:, j, j] = d
    return L, fail


def _chol_solve(L, r):
    """Solve L L^T x = r by forward and back substitution."""
    m = r.shape[-1]
    x = list(r.unbind(-1))
    for j in range(m):
        s = x[j]
        for t in range(j):
            s = s - L[:, j, t] * x[t]
        x[j] = s / L[:, j, j]
    for j in reversed(range(m)):
        s = x[j]
        for t in range(j + 1, m):
            s = s - L[:, t, j] * x[t]
        x[j] = s / L[:, j, j]
    return torch.stack(x, dim=-1)


def _solve_kkt(L, G, rhs, refine):
    x = _chol_solve(L, rhs)
    m = rhs.shape[-1]
    for _ in range(refine):
        Gx = _sum(torch.zeros_like(rhs), (G[:, :, u] * x[:, u, None] for u in range(m)))
        x = x + _chol_solve(L, rhs - Gx)
    return x


def _fold_cones(x, fn):
    """fn (torch.minimum or torch.maximum) folded over the cone axis."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = fn(acc, x[:, j])
    return acc


def _slack_agg(wsqrt, A, c, y, c_weight):
    """GetWeightedSlackEigenvalues aggregation (cone_program.cc:31-57)."""
    ws = _qrep(wsqrt, _minus_slack(A, c, y, c_weight))
    nq = torch.sqrt(_tail_sq(ws))
    ev1, ev2 = ws[..., 0] + nq, ws[..., 0] - nq  # (S, nc)
    lam_max_c = -torch.minimum(ev1, ev2)
    lam_min_c = -torch.maximum(ev1, ev2)
    zero = A.new_zeros(A.shape[0])
    cones = range(A.shape[1])
    return SlackAgg(
        lam_min=torch.clamp(_fold_cones(lam_min_c, torch.minimum), max=30000.0),
        lam_max=torch.clamp(_fold_cones(lam_max_c, torch.maximum), min=-30000.0),
        frob_sq=_sum(zero, (lam_max_c[:, j] * lam_max_c[:, j]
                            + lam_min_c[:, j] * lam_min_c[:, j] for j in cones)),
        trace=_sum(zero, (lam_max_c[:, j] + lam_min_c[:, j] for j in cones)),
    )


def solve_socp_plain(A, c, b, w0, k0, bsc0, csc0, config: SolverConfig) -> RawResult:
    """The fused kernel in plain PyTorch: A (S, nc, n+1, m), c and w0
    (S, nc, n+1), b (S, m), k0, bsc0 and csc0 (S,).

    Every scenario follows its own branch through per-scenario masks, as
    the lanes of the JAX kernel do; a finished scenario stays frozen.  The
    loop stops early when all scenarios are done (one host sync per pass),
    except under ``fixed_iterations``.
    """
    S, nc, n1, m = A.shape
    dtype, device = A.dtype, A.device
    T = config.max_iterations
    fc_steps = config.final_centering_steps
    warmstart = config.initialization_mode == WARMSTART
    init_centering = _init_centering(config)
    refine = config.iterative_refinement_iterations
    k_min_clamp = _k_min_clamp(config)
    rank = 2.0 * nc
    stall_on = config.mu_stall_iterations > 0 and not config.fixed_iterations

    def full(value, dt=dtype):
        return torch.full((S,), value, dtype=dt, device=device)

    false = full(False, torch.bool)
    izero = full(0, torch.int32)
    w, y, k = w0.clone(), torch.zeros((S, m), dtype=dtype, device=device), k0
    k_max, b_sc, c_sc = full(config.inv_sqrt_mu_max), bsc0, csc0
    kkt_err, centering = full(0.0), izero
    by, cx, d_inf = full(-1.0), full(1.0), full(0.0)
    done, fail, mir, aborted = false, false, ~false, false
    num_iter, stall = izero, izero
    stats_k = torch.zeros((S, T), dtype=dtype, device=device)
    stats_d = torch.zeros((S, T), dtype=dtype, device=device)

    for g in range(T):
        if not config.fixed_iterations and bool(done.all()):
            break
        active = ~done

        # --- break-before-assemble (cone_program.cc:331-336) ---
        final_c = (
            (k >= k_max) | (kkt_err > config.kkt_error_tolerance)
            | (g >= T - fc_steps)
        )
        stop_centering = final_c & (centering >= fc_steps)
        if config.fixed_iterations:
            stop_centering = false
        mark = active & stop_centering
        done = done | mark
        mir = torch.where(mark, g >= T - 1, mir)
        run = active & ~stop_centering

        # --- run_iteration (cone_program.cc:311-483) ---
        initial_centering = g < init_centering
        update_mu = (g == 0) | ~(initial_centering | final_c) | aborted

        wsqrt, G, AW, AQc, w_dot_c, c_dot_Qc = _assemble(A, c, w)

        if config.enable_rescaling and g < 1:
            if not warmstart:
                # warmstart keeps the caller's scalings (loop.py:318-330)
                b_sc_n = 1.0 / (1.0 + torch.sqrt(_dot(b, b)))
                c_sc_n = 1.0 / (1.0 + torch.sqrt(_dot(AQc, AQc)))
            else:
                b_sc_n, c_sc_n = b_sc, c_sc
            mu_target = (1.0 / (k_max * k_max)) * b_sc_n * c_sc_n
            k_max_n = 1.0 / torch.sqrt(mu_target)
        else:
            b_sc_n, c_sc_n, k_max_n = b_sc, c_sc, k_max

        L, fac_fail = _chol(G)
        AQc_s = AQc * c_sc_n[:, None]
        b_s = b * b_sc_n[:, None]

        # --- mu update (divergence mode, cone_program.cc:374-398) ---
        ydiv = _solve_kkt(L, G, AQc_s - b_s, refine)
        p = _slack_agg(wsqrt, A, c, ydiv, c_sc_n)
        temp = mu_from_divergence(p, rank, config.divergence_upper_bound)
        k_mu = torch.where(temp > 0, temp, k * 0.5)
        k_new = torch.where(update_mu, k_mu, k)
        centering_new = torch.where(
            update_mu, centering, centering + (0 if initial_centering else 1)
        )
        k_new = torch.minimum(torch.clamp(k_new, min=k_min_clamp), k_max_n)

        # --- Newton solve + step (cone_program.cc:409-436) ---
        y_new = _solve_kkt(L, G, k_new[:, None] * (b_s + AQc_s) - 2.0 * AW, refine)
        c_weight = k_new * c_sc_n
        d = _qrep(wsqrt, _minus_slack(A, c, y_new, c_weight))
        d = torch.cat([d[..., :1] + 1.0, d[..., 1:]], dim=-1)  # d += e
        nq = torch.sqrt(_tail_sq(d))
        norminf = _fold_cones(
            torch.maximum(torch.abs(d[..., 0] + nq), torch.abs(d[..., 0] - nq)),
            torch.maximum)
        normsq = 2.0 * _sum(torch.zeros_like(k), (_dot(d[:, j], d[:, j]) for j in range(nc)))
        step = torch.clamp(2.0 / (norminf * norminf), max=1.0)
        w_new = _qrep(wsqrt, _spectral(step[:, None, None] * d, torch.exp))

        # --- warmstart abort on a large first step (cone_program.cc:428-436)
        if warmstart and g == 0:
            ws_abort = norminf >= config.warmstart_abort_threshold
            w_new = torch.where(ws_abort[:, None, None], _identity_like(w_new), w_new)
        else:
            ws_abort = false

        # --- statistics (cone_program.cc:439-471) ---
        d_2sq = torch.abs(normsq)
        d_inf_new = torch.abs(norminf)
        by_new = _dot(b, y_new) / (k_new * c_sc_n)
        cx_new = (
            2.0 * w_dot_c + _dot(AQc, y_new) - k_new * c_dot_Qc * c_sc_n
        ) / (k_new * b_sc_n)
        mu = 1.0 / (k_new * k_new)
        s_dot_x = mu * (rank - d_2sq) / (b_sc_n * c_sc_n)
        kkt_err_new = torch.abs(cx_new - by_new - s_dot_x) / s_dot_x

        stop = (final_c | (k_new >= k_max_n)) & (
            d_inf_new <= config.final_centering_tolerance
        )
        if config.fixed_iterations:
            stop = false
        if stall_on:
            rel = torch.abs(k_new - k) / torch.clamp(torch.abs(k), min=1e-30)
            stalled_now = (
                update_mu & ~final_c & (g > 0) & (rel < config.mu_stall_tolerance)
            )
            stall_new = torch.where(stalled_now, stall + 1, izero)
            stop = stop | (stall_new >= config.mu_stall_iterations)
        else:
            stall_new = stall

        # --- merge: run scenarios take the iteration; a factor failure
        # aborts (or, at a first warmstart iteration, resets to identity and
        # continues: cone_program.cc:360-371); frozen scenarios keep state.
        ok = run & ~fac_fail
        ffail = run & fac_fail
        abort_f = ffail & (warmstart and g == 0)
        ffail = ffail & ~abort_f

        okv = ok[:, None, None]
        w = torch.where(okv, w_new, torch.where(abort_f[:, None, None], _identity_like(w), w))
        y = torch.where(ok[:, None], y_new, y)
        k = torch.where(ok, k_new, k)
        k_max = torch.where(run, k_max_n, k_max)
        b_sc = torch.where(run, b_sc_n, b_sc)
        c_sc = torch.where(run, c_sc_n, c_sc)
        kkt_err = torch.where(ok, kkt_err_new, kkt_err)
        centering = torch.where(ok, centering_new, centering)
        by = torch.where(ok, by_new, by)
        cx = torch.where(ok, cx_new, cx)
        d_inf = torch.where(ok, d_inf_new, d_inf)
        done = done | (ok & stop) | ffail
        fail = fail | ffail
        mir = mir & ~(ok & stop)
        num_iter = torch.where(ok, g + 1, num_iter).to(torch.int32)
        stall = torch.where(ok, stall_new, stall)
        # one-iteration flag: set on the aborting iteration, cleared by the
        # next completed iteration.
        aborted = (ok & ws_abort) | abort_f | (~(ok | ffail) & aborted)
        stats_k[:, g] = torch.where(ok, k, stats_k[:, g])
        stats_d[:, g] = torch.where(ok, d_inf, stats_d[:, g])

    if config.prepare_dual_variables:
        # Dual recovery (cone_program.cc:500-516): one extra assemble /
        # factor / solve and a first-order affine step.
        _, G, AW, _, _, _ = _assemble(A, c, w)
        L, fac_fail = _chol(G)
        y2 = _solve_kkt(L, G, k[:, None] * b * b_sc[:, None] - AW, refine)
        w_rec = w + _qrep(w, _minus_slack(A, c, y2, torch.zeros_like(k)))
        w = torch.where((fail | fac_fail)[:, None, None], w, w_rec)

    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return RawResult(y, w, k, k_max, b_sc, c_sc, by, cx, i32(fail), i32(mir),
                i32(stall), i32(num_iter), i32(aborted), stats_k, stats_d)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


# The dynamic shared memory one block may ask for on an H100 (227 KB of an
# SM's 228).
SHARED_BUDGET = 232_448
H100_SMS = 132
MAX_THREADS = 256  # csrc/fused_socp.cu's kMaxThreads (its launch bounds)
# Lanes per scenario the kernel's code takes (ALL_TEAMS) and the library
# holds (TEAMS); tools/kernel_costs.py k2 builds the others beside it.
ALL_TEAMS = (1, 2, 4, 8, 16, 32)
TEAMS = (8, 32)
# Lanes per scenario, by measurement on an H100 (tools/kernel_costs.py k2,
# PERF.md): 32 while a batch leaves each SM at most SMALL_PER_SM scenarios
# (the SMs are mostly idle and more lanes shorten the split stages), else 8
# (four scenarios share a warp's serial chains).
SMALL_PER_SM = 8


def default_team(S: int) -> int:
    return 32 if S <= SMALL_PER_SM * H100_SMS else 8


def _cdiv(a, b):
    return -(-a // b)


def working_elems(nc: int, n1: int, m: int) -> int:
    """Working elements of one scenario, in the kernel's carve order: w^1/2,
    WA, WC, d (nc n1 (3 + m)), ms (n1), G and L (2 m^2), AW, AQc, rhs, x,
    tmp (5 m)."""
    return nc * n1 * (3 + m) + n1 + 2 * m * m + 5 * m


def shared_elems(nc: int, n1: int, m: int) -> int:
    """One scenario's region of shared memory: A, c, b, w, y and the
    working arrays, padded to an odd count so that the teams of a warp fall
    on other banks."""
    cn = nc * n1
    return (cn * m + 2 * cn + 2 * m + working_elems(nc, n1, m)) | 1


@dataclass(frozen=True)
class SocpPlan:
    """How one launch of K2 covers S scenarios: ``team`` lanes per
    scenario, ``per_block`` scenarios per block (block b takes scenarios
    [b per_block, (b+1) per_block)), and the route: every scenario's working
    set in shared memory (``shared``), or in a global scratch buffer of
    ``scratch_shape``.  ``stride`` is the elements of one scenario's region."""

    S: int
    nc: int
    n1: int
    m: int
    itemsize: int
    T: int
    team: int
    shared: bool
    per_block: int
    stride: int

    @property
    def route(self):
        return "shared" if self.shared else "global"

    @property
    def blocks(self):
        return _cdiv(self.S, self.per_block)

    @property
    def threads(self):
        return self.per_block * self.team

    @property
    def shared_bytes(self):
        """Dynamic shared memory of one block."""
        return self.per_block * self.stride * self.itemsize if self.shared else 0

    @property
    def scratch_shape(self):
        return (0,) if self.shared else (self.S, self.stride)

    def scenarios(self, block):
        lo = block * self.per_block
        return range(lo, min(self.S, lo + self.per_block))

    def traffic_bytes(self, iterations: int) -> int:
        """Device-memory bytes of one solve whose scenarios take
        ``iterations`` Newton iterations together: the inputs read once and
        the outputs written once; on the global route also each working
        element written and read once per iteration (a floor: the code
        reads most of them more often)."""
        S, cn, m, T, it = self.S, self.nc * self.n1, self.m, self.T, self.itemsize
        io = it * S * (cn * m + 2 * cn + m + 3) + it * S * (m + cn + 6 + 2 * T) + 4 * 5 * S
        if self.shared:
            return io
        return io + 2 * it * working_elems(self.nc, self.n1, m) * iterations

    def as_ints(self):
        """The kernel's plan array."""
        return (self.team, self.per_block, int(self.shared), self.stride)

    def describe(self):
        return (f"route {self.route}, TEAM {self.team}, {self.per_block} scenarios "
                f"per block ({self.blocks} blocks of {self.threads} threads), "
                f"{self.shared_bytes} shared bytes per block")


def socp_plan(S, nc, n1, m, itemsize, T, team=None, route=None):
    """The plan of one launch.  The global route is taken exactly when one
    scenario's region exceeds SHARED_BUDGET; ``route`` forces one
    ("shared" raises where it does not fit).  ``team`` may be any of
    ALL_TEAMS; the library launches only TEAMS.  Blocks hold
    MAX_THREADS // team scenarios, fewer where shared memory or a small S
    (spread over the SMs) asks for it."""
    team = default_team(S) if team is None else team
    if team not in ALL_TEAMS:
        raise ValueError(f"team must be one of {ALL_TEAMS}, not {team}")
    fits = shared_elems(nc, n1, m) * itemsize <= SHARED_BUDGET
    if route is None:
        route = "shared" if fits else "global"
    if route not in ("shared", "global"):
        raise ValueError(f"route must be 'shared' or 'global', not {route!r}")
    shared = route == "shared"
    if shared and not fits:
        raise ValueError(f"one scenario of shape nc={nc}, n1={n1}, m={m} exceeds "
                         f"{SHARED_BUDGET} bytes of shared memory")
    stride = shared_elems(nc, n1, m) if shared else working_elems(nc, n1, m)
    per_block = MAX_THREADS // team
    if shared:
        per_block = min(per_block, SHARED_BUDGET // (stride * itemsize))
    per_block = max(1, min(per_block, _cdiv(S, H100_SMS)))
    return SocpPlan(S=S, nc=nc, n1=n1, m=m, itemsize=itemsize, T=T, team=team,
                    shared=shared, per_block=per_block, stride=stride)


def solve_socp_kernel(A, c, b, w0, k0, bsc0, csc0, config: SolverConfig,
                      plan: Optional[SocpPlan] = None) -> RawResult:
    """Launch the CUDA kernel on CUDA tensors (shapes as solve_socp_plain)
    under ``plan`` (``socp_plan``'s by default); raises on what it does not
    take."""
    args = (A, c, b, w0, k0, bsc0, csc0)
    if not all(x.is_cuda for x in args):
        raise ValueError("solve_socp_kernel takes CUDA tensors")
    if any(x.device != A.device for x in args):
        raise ValueError(f"tensors on different devices: {[str(x.device) for x in args]}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"solve_socp_kernel takes float32 or float64, not {A.dtype}")
    if any(x.dtype != A.dtype for x in args):
        raise TypeError(f"dtypes differ: {[x.dtype for x in args]}")
    if A.dim() != 4:
        raise ValueError(f"A must be (S, nc, n+1, m), got {tuple(A.shape)}")
    S, nc, n1, m = A.shape
    want = dict(c=(S, nc, n1), b=(S, m), w0=(S, nc, n1), k0=(S,), bsc0=(S,), csc0=(S,))
    for (name, shape), x in zip(want.items(), args[1:]):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if min(S, nc, n1, m) < 1 or config.max_iterations < 1:
        raise ValueError(f"empty shape {tuple(A.shape)} or max_iterations < 1")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("solve_socp_kernel takes contiguous tensors")
    T = config.max_iterations
    if plan is None:
        plan = socp_plan(S, nc, n1, m, A.element_size(), T)
    if (plan.S, plan.nc, plan.n1, plan.m, plan.itemsize, plan.T) != (
            S, nc, n1, m, A.element_size(), T):
        raise ValueError(f"plan for another call: {plan}")
    if S * max(nc * n1 * m, plan.stride, T) >= 2**31:
        raise ValueError(f"shape {tuple(A.shape)} exceeds the kernel's int indices")
    _check_config(config)

    from .._build import build

    lib = build().lib
    fn = lib.conex_socp_fused_f32 if A.dtype == torch.float32 else lib.conex_socp_fused_f64
    kw = dict(dtype=A.dtype, device=A.device)
    y = torch.empty((S, m), **kw)
    w = torch.empty((S, nc, n1), **kw)
    k, k_max, b_sc, c_sc, by, cx = (torch.empty((S,), **kw) for _ in range(6))
    ints = [torch.empty((S,), dtype=torch.int32, device=A.device) for _ in range(5)]
    stats_k = torch.empty((S, T), **kw)
    stats_d = torch.empty((S, T), **kw)
    scratch = torch.empty(plan.scratch_shape, **kw)
    plan_ints = (ctypes.c_int * 4)(*plan.as_ints())
    iparams = (ctypes.c_int * 9)(
        T, config.final_centering_steps, _init_centering(config),
        config.iterative_refinement_iterations,
        int(config.initialization_mode == WARMSTART),
        int(config.fixed_iterations), int(config.enable_rescaling),
        int(config.prepare_dual_variables), config.mu_stall_iterations,
    )
    dparams = (ctypes.c_double * 8)(
        config.kkt_error_tolerance, config.inv_sqrt_mu_max, _k_min_clamp(config),
        2.0 * nc, config.divergence_upper_bound, config.final_centering_tolerance,
        config.warmstart_abort_threshold, config.mu_stall_tolerance,
    )
    ptrs = [x.data_ptr() for x in (A, c, b, w0, k0, bsc0, csc0, y, w, k,
                                   k_max, b_sc, c_sc, by, cx, *ints, stats_k,
                                   stats_d, scratch)]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(*ptrs, S, nc, n1, m, ctypes.addressof(plan_ints),
                 ctypes.addressof(iparams), ctypes.addressof(dparams), stream)
    if err != 0:
        raise RuntimeError(f"fused SOCP kernel launch failed: cudaError {err} ({plan.describe()})")
    solve_socp_kernel.launches += 1
    return RawResult(y, w, k, k_max, b_sc, c_sc, by, cx, *ints, stats_k, stats_d)


solve_socp_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def solve_socp_fused(
    A,
    c,
    b,
    config: SolverConfig,
    init_w=None,
    init_k=None,
    init_b_scaling=None,
    init_c_scaling=None,
    block_size: int = 1024,
    interpret: Optional[bool] = None,
) -> FusedSOCPResult:
    """Solve S independent SOCP scenarios in one fused kernel.

    Each scenario s is  max b[s]'y  s.t.  c[s,j] - A[s,j] y in Q^{n+1}
    for nc Lorentz cones j.  The solve runs on A's device: the CUDA kernel
    for a CUDA tensor, ``solve_socp_plain`` for a CPU tensor.  An input that
    is not a tensor follows A, and an A that is not a tensor goes to the
    card; a caller who wants the CPU passes a CPU tensor A.

    Args:
      A: (S, nc, n+1, m) or (S, n+1, m) constraint operators (a tensor or
        an array).
      c: (S, nc, n+1) or (S, n+1) affine terms.
      b: (S, m) objectives.
      config: SolverConfig (divergence mu mode, LLT; coldstart or warmstart).
      init_w: optional (S, nc, n+1) initial iterates (defaults to identity);
        for warmstart pass the previous solve's ``w``.
      init_k: optional (S,) initial inv_sqrt_mu (defaults to 0); for
        warmstart pass the previous solve's ``k``.
      init_b_scaling: optional (S,) rescaling state carried across a
        warmstart (previous ``b_scaling``; defaults to 1).
      init_c_scaling: optional (S,) likewise for ``c_scaling``.
      block_size, interpret: accepted for the JAX signature; they have no
        effect here (``socp_plan`` sizes the kernel's teams and blocks, and
        the kernel has no interpreter mode).
    """
    del block_size, interpret
    _check_config(config)
    if not isinstance(A, torch.Tensor):
        A = torch.tensor(A, device="cuda")  # a copy: arrays may be read-only
    device, dtype = A.device, A.dtype

    def on_device(x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=dtype, device=device)
        if x.device != device:
            raise ValueError(f"tensor on {x.device}, A on {device}")
        return x.to(dtype).contiguous()

    c, b = on_device(c), on_device(b)
    if A.dim() == 3:
        A, c = A[:, None], c[:, None]
    A = A.contiguous()
    S, nc, n1, _ = A.shape
    if init_w is None:
        init_w = torch.zeros((S, nc, n1), dtype=dtype, device=device)
        init_w[:, :, 0] = 1.0
    if init_k is None:
        init_k = torch.zeros((S,), dtype=dtype, device=device)
    if init_b_scaling is None:
        init_b_scaling = torch.ones((S,), dtype=dtype, device=device)
    if init_c_scaling is None:
        init_c_scaling = torch.ones((S,), dtype=dtype, device=device)
    args = (A, c, b) + tuple(
        on_device(x) for x in (init_w, init_k, init_b_scaling, init_c_scaling)
    )

    if device.type == "cuda":
        raw = solve_socp_kernel(*args, config)
    elif device.type == "cpu":
        raw = solve_socp_plain(*args, config)
    else:
        raise ValueError(f"no fused SOCP kernel for device {device}")
    return epilogue(raw, config)


def epilogue(raw: RawResult, config: SolverConfig) -> FusedSOCPResult:
    """The host epilogue (cone_program.cc:485-532), elementwise: status
    flags and the unscaled y from what the kernel returns."""
    k = raw.k
    fail = raw.fail.bool()
    mu = 1.0 / (k * k)
    infeasible = mu > config.infeasibility_threshold
    if config.mu_stall_iterations > 0:
        mu_stalled = (raw.stall >= config.mu_stall_iterations) & (k < raw.k_max)
    else:
        mu_stalled = torch.zeros_like(fail)
    return FusedSOCPResult(
        y=torch.where((infeasible | fail)[:, None], raw.y,
                      raw.y / (k * raw.c_sc)[:, None]),
        solved=~infeasible & ~fail & ~mu_stalled & ~raw.mir.bool(),
        primal_infeasible=infeasible & (raw.cx * k <= -0.5),
        dual_infeasible=infeasible & (raw.by * k >= 0.5),
        num_iterations=raw.num_iter,
        w=raw.w,
        y_kkt=raw.y,
        k=k,
        warmstart_aborted=raw.aborted.bool(),
        b_scaling=raw.b_sc,
        c_scaling=raw.c_sc,
        stats_k=raw.stats_k,
        stats_dinf=raw.stats_d,
        fail=fail,
        mu_stalled=mu_stalled,
    )

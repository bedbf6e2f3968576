"""The geodesic interior-point iteration, batched over scenarios.

Twin of ``conex_tpu/solver/loop.py``.  The JAX package traces one program
and vmaps it over scenarios; here every tensor carries the scenario axis S
first and the loop runs S programs in lockstep.  The reference's
data-dependent branching (mu-update mode, centering state machine,
warmstart aborts, factorization-failure recovery) is carried as (S,)
boolean tensors and applied with per-scenario selects, so each scenario
follows its own branch exactly as under vmap.

The JAX ``while_loop`` becomes a Python loop of at most ``max_iterations``
passes.  It stops early only when every scenario is done (one host sync per
pass); under ``fixed_iterations`` it runs all passes without that sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..cones.base import local_vars, per_scenario, tree_select
from ..config import SCHUR_PRECISION_MODES, WARMSTART, SolverConfig, not_ported
from . import kkt
from .mu import SlackAgg, mu_from_divergence


class LoopState(NamedTuple):
    i: torch.Tensor  # (S,) int64 iteration counter
    ws: Tuple  # per-block cone iterates, each field (S, ...)
    y: torch.Tensor  # (S, m) KKT solution of the last iteration
    k: torch.Tensor  # (S,) inv_sqrt_mu
    k_max: torch.Tensor  # (S,) dynamic inv_sqrt_mu_max (updated by rescaling)
    b_scaling: torch.Tensor
    c_scaling: torch.Tensor
    kkt_error: torch.Tensor
    centering_steps: torch.Tensor
    warmstart_aborted: torch.Tensor
    by: torch.Tensor
    cx: torch.Tensor
    d_inf: torch.Tensor
    done: torch.Tensor
    fail: torch.Tensor
    max_iters_reached: torch.Tensor
    num_iter: torch.Tensor
    stall_count: torch.Tensor  # consecutive low-progress mu updates
    fc_latch: torch.Tensor  # numerical-floor final-centering latch
    stats_k: torch.Tensor  # (S, max_iterations) sqrt_inv_mu per iteration
    stats_dinf: torch.Tensor  # (S, max_iterations) norm_inf_d per iteration
    stats_d2: torch.Tensor  # (S, max_iterations) ||d||_2
    stats_by: torch.Tensor  # (S, max_iterations) scaled objective b'y
    stats_cx: torch.Tensor  # (S, max_iterations) scaled dual objective c'x
    stats_err: torch.Tensor  # (S, max_iterations) kkt_error


class SolveResult(NamedTuple):
    y: torch.Tensor  # (S, m) primal variable (scaled back)
    solved: torch.Tensor
    primal_infeasible: torch.Tensor
    dual_infeasible: torch.Tensor
    num_iterations: torch.Tensor
    ws: Tuple  # final cone iterates (warmstart state / dual variables)
    y_kkt: torch.Tensor  # (S, m) raw final KKT solution
    k: torch.Tensor
    b_scaling: torch.Tensor
    c_scaling: torch.Tensor
    stats_k: torch.Tensor
    stats_dinf: torch.Tensor
    stats_d2: torch.Tensor
    stats_by: torch.Tensor
    stats_cx: torch.Tensor
    stats_err: torch.Tensor
    fail: torch.Tensor
    mu_stalled: torch.Tensor


# ---------------------------------------------------------------------------
# Schur-complement assembly
# ---------------------------------------------------------------------------


def assemble(blocks, ws, m: int, dtype):
    """Assemble the (S, m, m) KKT matrices and residuals from the block
    contributions.

    reference: Assemble + AssembleSchurComplementResiduals
    (cone_program.cc:339-340, constraint_manager.h:107-124).  Dense blocks
    only: a block covers the first ``v`` variables.
    """
    S = blocks[0].scenarios
    device = blocks[0].A.device
    G = torch.zeros((S, m, m), dtype=dtype, device=device)
    AW = torch.zeros((S, m), dtype=dtype, device=device)
    AQc = torch.zeros((S, m), dtype=dtype, device=device)
    w_dot_c = torch.zeros((S,), dtype=dtype, device=device)
    c_dot_Qc = torch.zeros((S,), dtype=dtype, device=device)
    for blk, w in zip(blocks, ws):
        out = blk.schur(w)
        v = out.G.shape[-1]
        if v == m:
            G = G + out.G
            AW = AW + out.AW
            AQc = AQc + out.AQc
        else:
            G = G.clone()
            G[:, :v, :v] += out.G
            AW = AW.clone()
            AW[:, :v] += out.AW
            AQc = AQc.clone()
            AQc[:, :v] += out.AQc
        w_dot_c = w_dot_c + out.w_dot_c
        c_dot_Qc = c_dot_Qc + out.c_dot_Qc
    return G, AW, AQc, w_dot_c, c_dot_Qc


# ---------------------------------------------------------------------------
# Per-iteration cone sweeps
# ---------------------------------------------------------------------------


def _prepare_step_all(blocks, ws, y, c_weight, e_weight):
    """reference: PrepareStep sweep, cone_program.h:69-90."""
    caches = []
    norminf = torch.full_like(c_weight, -1.0)
    normsq = torch.zeros_like(c_weight)
    for blk, w in zip(blocks, ws):
        y_loc = local_vars(y, blk.vars_, blk.num_vars)
        cache, ninf, nsq = blk.prepare_step(w, y_loc, c_weight, e_weight)
        caches.append(cache)
        norminf = torch.maximum(norminf, ninf)
        normsq = normsq + nsq
    return tuple(caches), norminf, normsq


def _take_step_all(blocks, ws, caches, step_size):
    """reference: TakeStep sweep, cone_program.h:92-97."""
    return tuple(
        blk.take_step(w, cache, step_size)
        for blk, w, cache in zip(blocks, ws, caches)
    )


def _slack_stats_all(blocks, ws, y, c_weight):
    """reference: GetWeightedSlackEigenvalues agg, cone_program.cc:31-57.

    Initial lam bounds +/-30000 replicate the reference exactly
    (cone_program.cc:37-38).
    """
    agg = SlackAgg(
        lam_min=torch.full_like(c_weight, 30000.0),
        lam_max=torch.full_like(c_weight, -30000.0),
        frob_sq=torch.zeros_like(c_weight),
        trace=torch.zeros_like(c_weight),
    )
    for blk, w in zip(blocks, ws):
        y_loc = local_vars(y, blk.vars_, blk.num_vars)
        s = blk.slack_stats(w, y_loc, c_weight)
        agg = SlackAgg(
            lam_min=torch.minimum(agg.lam_min, s.lam_min),
            lam_max=torch.maximum(agg.lam_max, s.lam_max),
            frob_sq=agg.frob_sq + s.frob_sq,
            trace=agg.trace + s.trace,
        )
    return agg


def _identity_all(blocks, dtype):
    return tuple(blk.identity_state(dtype) for blk in blocks)


def _mu_line_search(blocks, ws, fac, config, AW, AQc_s, b_s_vec, c_scaling):
    """reference: ComputeMuFromLineSearch, cone_program.cc:118-160.  Per
    scenario: the largest admissible k of the segment from y0 to y1, or
    -1 where a block fails (a block without line search always does,
    reference constraint.h:24-28) or the intervals do not meet."""
    refine = config.iterative_refinement_iterations
    mode = config.kkt_solver
    y0 = kkt.solve(fac, -2.0 * AW, mode, refine)
    y1 = kkt.solve(fac, AQc_s + b_s_vec - 2.0 * AW, mode, refine)
    lower = torch.full_like(c_scaling, -float("inf"))
    upper = torch.full_like(c_scaling, float("inf"))
    fail = torch.zeros(c_scaling.shape, dtype=torch.bool, device=c_scaling.device)
    for blk, w in zip(blocks, ws):
        if not getattr(blk, "supports_line_search", False):
            fail = torch.ones_like(fail)
            continue
        lo, up, f = blk.line_search(
            w, local_vars(y0, blk.vars_, blk.num_vars),
            local_vars(y1, blk.vars_, blk.num_vars), 0.0, c_scaling,
            config.dinf_upper_bound,
        )
        lower = torch.maximum(lower, lo)
        upper = torch.minimum(upper, up)
        fail = fail | f
    fail = fail | (lower > upper)
    return torch.where(fail, torch.full_like(upper, -1.0), upper)


def _mu_divergence(blocks, ws, fac, config, AQc_s, b_s_vec, c_scaling, rank_k):
    """reference: ComputeMuFromDivergence, cone_program.cc:173-214."""
    ydiv = kkt.solve(
        fac, AQc_s - b_s_vec, config.kkt_solver,
        config.iterative_refinement_iterations,
    )
    p = _slack_stats_all(blocks, ws, ydiv, c_scaling)
    return mu_from_divergence(p, rank_k, config.divergence_upper_bound)


def _set_row(stats, i, value):
    """stats[s, i[s]] = value[s] for every scenario (rows of frozen
    scenarios are restored by the caller's select)."""
    idx = i.clamp(max=stats.shape[1] - 1)[:, None]
    return stats.scatter(1, idx, value[:, None].to(stats.dtype))


def _check_supported(blocks, eq_blocks, config: SolverConfig):
    if config.schur_precision not in SCHUR_PRECISION_MODES:
        raise ValueError(
            f"unknown schur_precision {config.schur_precision!r}; "
            f"valid: {SCHUR_PRECISION_MODES}"
        )
    if eq_blocks:
        raise not_ported("equality constraints", "10")
    if any(blk.vars_ is not None for blk in blocks):
        raise not_ported("sparse variable subsets", "13")


@contextlib.contextmanager
def _no_tf32():
    # A float32 product on the card must be a true float32 product, as on
    # the CPU: TF32 keeps about three decimal digits, too few for the f32
    # Schur complement to stay factorable.  The caller's two flags come
    # back on exit, by an exception too: a solve changes no global state.
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# The solve loop
# ---------------------------------------------------------------------------


def _solve_impl(blocks, eq_blocks, b, init_ws, init_scalars,
                config: SolverConfig):
    """Solve S same-structure programs: b (S, m), block tensors and
    init_ws fields (S, ...), init_scalars k / b_scaling / c_scaling (S,)."""
    _check_supported(blocks, eq_blocks, config)
    with _no_tf32() if b.is_cuda else contextlib.nullcontext():
        return _solve_loop(blocks, b, init_ws, init_scalars, config)


def _solve_loop(blocks, b, init_ws, init_scalars, config: SolverConfig):
    dtype = b.dtype
    device = b.device
    S, m = b.shape

    rank_k = float(sum(blk.rank() for blk in blocks))
    warmstart = config.initialization_mode == WARMSTART
    mode = config.kkt_solver
    refine = config.iterative_refinement_iterations
    island = kkt.island_dtype(config.kkt_island_dtype)
    T = config.max_iterations

    k_min_clamp = (1.0 / (1e-15 + config.maximum_mu)) ** 0.5

    init_centering_steps = (
        config.initial_centering_steps_warmstart
        if warmstart
        else config.initial_centering_steps_coldstart
    )

    # Reaching the scaled-k precision cap is reaching the achievable
    # target.  inf (the default) never triggers.
    k_cap = config.inv_sqrt_mu_cap_scaled

    def final_centering_of(s: LoopState):
        return (
            s.fc_latch
            | (s.k >= s.k_max)
            | (s.k >= k_cap)
            | (s.kkt_error > config.kkt_error_tolerance)
            | (s.i >= T - config.final_centering_steps)
        )

    def run_iteration(s: LoopState) -> LoopState:
        i = s.i
        initial_centering = i < init_centering_steps
        final_centering = final_centering_of(s)
        update_mu = (i == 0) | ~(initial_centering | final_centering) | s.warmstart_aborted

        # --- Assemble (cone_program.cc:338-341) ---
        G, AW, AQc, w_dot_c, c_dot_Qc = assemble(
            blocks, s.ws, m, dtype
        )

        # --- First-iteration rescaling (cone_program.cc:343-357) ---
        if config.enable_rescaling:
            do_rescale = i < 1
            if not warmstart:
                b_scaling = torch.where(
                    do_rescale,
                    1.0 / (1.0 + torch.linalg.vector_norm(b, dim=-1)),
                    s.b_scaling,
                )
                c_scaling = torch.where(
                    do_rescale,
                    1.0 / (1.0 + torch.linalg.vector_norm(AQc, dim=-1)),
                    s.c_scaling,
                )
            else:
                b_scaling, c_scaling = s.b_scaling, s.c_scaling
            mu_target = (1.0 / (s.k_max * s.k_max)) * b_scaling * c_scaling
            k_max = torch.where(do_rescale, 1.0 / torch.sqrt(mu_target), s.k_max)
        else:
            b_scaling, c_scaling, k_max = s.b_scaling, s.c_scaling, s.k_max

        # --- Factor (cone_program.cc:359-371) ---
        fac = kkt.factor(G, mode, island_dtype=island)

        # Both sides of the factor-fail branch are computed and merged with
        # per-scenario selects, as the JAX package does; values computed
        # from a failed factor are discarded by the selects.

        # --- Factor ok ---
        AQc_s = AQc * c_scaling[:, None]
        b_s_vec = b * b_scaling[:, None]

        # --- Mu update (cone_program.cc:374-403), branch-free ---
        if config.enable_line_search:
            temp = _mu_line_search(
                blocks, s.ws, fac, config, AW, AQc_s, b_s_vec, c_scaling
            )
            temp = torch.where(temp < 0, s.k, temp)
        else:
            temp = _mu_divergence(
                blocks, s.ws, fac, config, AQc_s, b_s_vec, c_scaling, rank_k
            )
        k_cand = torch.where(temp > 0, temp, s.k * 0.5)

        # --- Numerical-floor latch (see SolverConfig) ---
        if config.mu_floor_drop_ratio > 0 and not config.fixed_iterations:
            floor = (
                update_mu
                & ~final_centering
                & (k_cand < config.mu_floor_drop_ratio * s.k)
                & (s.k >= config.mu_floor_kmax_fraction * k_max)
            )
            k_cand = torch.where(floor, s.k, k_cand)
            fc_latch = s.fc_latch | floor
        else:
            fc_latch = s.fc_latch

        k = torch.where(update_mu, k_cand, s.k)
        centering_steps = torch.where(
            update_mu,
            s.centering_steps,
            s.centering_steps + (~initial_centering).long(),
        )

        # Clamp (cone_program.cc:405-407).
        k = torch.minimum(torch.clamp(k, min=k_min_clamp), k_max)
        if k_cap != float("inf"):
            # Precision guard on the scaled duality measure (see
            # SolverConfig.inv_sqrt_mu_cap_scaled).
            k = torch.clamp(k, max=k_cap)

        # --- Newton solve (cone_program.cc:409-413) ---
        y = kkt.solve(
            fac, k[:, None] * (b_s_vec + AQc_s) - 2.0 * AW, mode, refine
        )

        # --- PrepareStep (cone_program.cc:416-426) ---
        c_weight = k * c_scaling
        caches, norminf, normsq = _prepare_step_all(
            blocks, s.ws, y, c_weight, 1.0
        )
        step_size = torch.clamp(2.0 / (norminf * norminf), max=1.0)

        ws_new = _take_step_all(blocks, s.ws, caches, step_size)
        # --- Warmstart abort on large step (cone_program.cc:428-436) ---
        if warmstart:
            abort = (i == 0) & (norminf >= config.warmstart_abort_threshold)
            ws_new = tree_select(abort, _identity_all(blocks, dtype), ws_new)
        else:
            abort = torch.zeros_like(s.done)

        # --- Statistics (cone_program.cc:439-471) ---
        d_2sq = torch.abs(normsq)
        d_inf = torch.abs(norminf)
        by = torch.sum(b * y, dim=-1) / (k * c_scaling)
        cx = (
            2.0 * w_dot_c + torch.sum(AQc * y, dim=-1) - k * c_dot_Qc * c_scaling
        ) / (k * b_scaling)
        mu = 1.0 / (k * k)
        s_dot_x = mu * (rank_k - d_2sq) / (b_scaling * c_scaling)
        kkt_error = torch.abs(cx - by - s_dot_x) / s_dot_x

        # --- Termination (cone_program.cc:476-482) ---
        stop = (final_centering | (k >= k_max) | (k >= k_cap)) & (
            d_inf <= config.final_centering_tolerance
        )
        if config.fixed_iterations:
            stop = torch.zeros_like(stop)

        # --- Mu-stall detection (see SolverConfig) ---
        if config.mu_stall_iterations > 0 and not config.fixed_iterations:
            rel = torch.abs(k - s.k) / torch.clamp(torch.abs(s.k), min=1e-30)
            stalled_now = (
                update_mu
                & ~final_centering
                & (i > 0)
                & (rel < config.mu_stall_tolerance)
            )
            stall_count = torch.where(
                stalled_now, s.stall_count + 1, torch.zeros_like(s.stall_count)
            )
            stop = stop | (stall_count >= config.mu_stall_iterations)
        else:
            stall_count = s.stall_count

        sn = LoopState(
            i=i + 1,
            ws=ws_new,
            y=y,
            k=k,
            k_max=k_max,
            b_scaling=b_scaling,
            c_scaling=c_scaling,
            kkt_error=kkt_error,
            centering_steps=centering_steps,
            warmstart_aborted=abort,
            by=by,
            cx=cx,
            d_inf=d_inf,
            done=stop,
            fail=s.fail,
            max_iters_reached=s.max_iters_reached & ~stop,
            num_iter=i + 1,
            stall_count=stall_count,
            fc_latch=fc_latch,
            stats_k=_set_row(s.stats_k, i, k),
            stats_dinf=_set_row(s.stats_dinf, i, d_inf),
            stats_d2=_set_row(s.stats_d2, i, torch.sqrt(d_2sq)),
            stats_by=_set_row(s.stats_by, i, by),
            stats_cx=_set_row(s.stats_cx, i, cx),
            stats_err=_set_row(s.stats_err, i, kkt_error),
        )

        # --- Merge with the factor-fail path (cone_program.cc:360-371).
        # On failure (coldstart, or warmstart past the first iteration)
        # the run aborts: done/fail set, everything else kept.  On a
        # first-iteration warmstart failure the warmstart is aborted and
        # the iterates reset to identity.
        ffail = fac.fail
        if warmstart:
            abort_f = ffail & (i == 0)
            ws_fail = tree_select(abort_f, _identity_all(blocks, dtype), s.ws)
            aborted_f = abort_f
        else:
            abort_f = torch.zeros_like(ffail)
            ws_fail = s.ws
            aborted_f = s.warmstart_aborted
        s_fail = s._replace(
            i=i + 1,
            ws=ws_fail,
            warmstart_aborted=aborted_f,
            done=~abort_f,
            fail=~abort_f,
            b_scaling=b_scaling,
            c_scaling=c_scaling,
            k_max=k_max,
        )
        return tree_select(ffail, s_fail, sn)

    def body(s: LoopState) -> LoopState:
        # Break-before-assemble: final centering budget exhausted
        # (cone_program.cc:331-336).  The iteration is always computed; a
        # finished scenario (done, or centering budget spent) keeps its
        # state through the selects, as under vmap.
        stop_centering = final_centering_of(s) & (
            s.centering_steps >= config.final_centering_steps
        )
        if config.fixed_iterations:
            stop_centering = torch.zeros_like(stop_centering)

        sn = run_iteration(s)
        s_marked = s._replace(
            done=torch.ones_like(s.done),
            max_iters_reached=s.i >= T - 1,
        )
        merged = tree_select(s.done | stop_centering, s_marked, sn)
        # A scenario that was already done stays exactly as it was.
        return tree_select(s.done, s, merged)

    def scalars(key):
        return init_scalars[key].to(dtype=dtype, device=device).reshape(S)

    def zeros(dt=dtype):
        return torch.zeros((S,), dtype=dt, device=device)

    false = zeros(torch.bool)
    izero = zeros(torch.int64)
    s = LoopState(
        i=izero,
        ws=tuple(init_ws),
        y=torch.zeros((S, m), dtype=dtype, device=device),
        k=scalars("k"),
        k_max=torch.full((S,), config.inv_sqrt_mu_max, dtype=dtype, device=device),
        b_scaling=scalars("b_scaling"),
        c_scaling=scalars("c_scaling"),
        kkt_error=zeros(),
        centering_steps=izero,
        warmstart_aborted=false,
        by=zeros() - 1.0,
        cx=zeros() + 1.0,
        d_inf=zeros(),
        done=false,
        fail=false,
        max_iters_reached=torch.ones_like(false),
        num_iter=izero,
        stall_count=izero,
        fc_latch=false,
        **{
            f"stats_{name}": torch.zeros((S, T), dtype=dtype, device=device)
            for name in ("k", "dinf", "d2", "by", "cx", "err")
        },
    )

    # Every scenario that is not done has run exactly as many passes as
    # the loop has, so all of them stay below max_iterations inside it.
    for _ in range(T):
        if not config.fixed_iterations and bool(s.done.all()):
            break
        s = body(s)

    # --- Epilogue (cone_program.cc:485-532) ---
    mu = 1.0 / (s.k * s.k)
    infeasible = mu > config.infeasibility_threshold
    primal_infeasible = infeasible & (s.cx * s.k <= -0.5)
    dual_infeasible = infeasible & (s.by * s.k >= 0.5)
    if config.mu_stall_iterations > 0:
        mu_stalled = (s.stall_count >= config.mu_stall_iterations) & (
            s.k < s.k_max
        )
    else:
        mu_stalled = torch.zeros_like(s.done)
    solved = ~infeasible & ~s.fail & ~mu_stalled

    ws_final = s.ws
    if config.prepare_dual_variables:
        # Dual recovery: one extra assemble/factor/solve + affine step
        # (cone_program.cc:500-516).  A failed run keeps the loop's W.
        G, AW, AQc, _, _ = assemble(blocks, ws_final, m, dtype)
        fac = kkt.factor(G, mode, island_dtype=island)
        bres = s.k[:, None] * b * s.b_scaling[:, None] - AW
        y2 = kkt.solve(fac, bres, mode, refine)
        skip = s.fail | fac.fail
        ws_recovered = tuple(
            blk.affine_step(w, local_vars(y2, blk.vars_, blk.num_vars), 0.0)
            for blk, w in zip(blocks, ws_final)
        )
        ws_final = tree_select(skip, ws_final, ws_recovered)

    # Unscale (cone_program.cc:518-521): applied when mu is feasible,
    # even if the iteration limit later clears `solved`.
    y_out = torch.where(
        per_scenario(infeasible | s.fail, 2),
        s.y[:, :m],
        s.y[:, :m] / per_scenario(s.k * s.c_scaling, 2),
    )
    solved = solved & ~s.max_iters_reached

    return SolveResult(
        y=y_out,
        solved=solved,
        primal_infeasible=primal_infeasible,
        dual_infeasible=dual_infeasible,
        num_iterations=s.num_iter,
        ws=ws_final,
        y_kkt=s.y,
        k=s.k,
        b_scaling=s.b_scaling,
        c_scaling=s.c_scaling,
        stats_k=s.stats_k,
        stats_dinf=s.stats_dinf,
        stats_d2=s.stats_d2,
        stats_by=s.stats_by,
        stats_cx=s.stats_cx,
        stats_err=s.stats_err,
        fail=s.fail,
        mu_stalled=mu_stalled,
    )


def solve(blocks, eq_blocks, b, init_ws, init_scalars, config: SolverConfig):
    """One program (the twin of ``conex_tpu.solver.loop.solve_compiled``):
    block tensors, b (m,) and init state without the scenario axis.  Runs
    as a batch of one scenario and returns a SolveResult without it."""
    blocks1 = tuple(_add_scenario(blk) for blk in blocks)
    ws1 = tuple(_add_scenario(w) for w in init_ws)
    scalars1 = {key: torch.as_tensor(x)[None] for key, x in init_scalars.items()}
    res = _solve_impl(blocks1, eq_blocks, b[None], ws1, scalars1, config)
    return _strip_scenario(res)


def _add_scenario(tree):
    """A leading scenario axis of one on every tensor of a block dataclass,
    a state NamedTuple or a bare tensor; other fields stay as they are."""
    if isinstance(tree, torch.Tensor):
        return tree[None]
    if isinstance(tree, tuple):
        out = [_add_scenario(x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _add_scenario(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)
        })
    return tree


def _strip_scenario(tree):
    if isinstance(tree, tuple):
        out = [_strip_scenario(x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree[0]

"""The geodesic interior-point iteration, batched over scenarios.

Twin of ``conex_tpu/solver/loop.py``.  The JAX package traces one program
and vmaps it over scenarios; here every tensor carries the scenario axis S
first and the loop runs S programs in lockstep.  The reference's
data-dependent branching (mu-update mode, centering state machine,
warmstart aborts, factorization-failure recovery) is carried as (S,)
boolean tensors and applied with per-scenario selects, so each scenario
follows its own branch exactly as under vmap.

The JAX ``while_loop`` becomes a Python loop of at most ``max_iterations``
passes.  It stops early only when every scenario is done: after each pass
it reads the count of scenarios not done (one host sync per pass), which
``utils.profiling.counters`` adds up as the live share of the batch's
work.  Under ``fixed_iterations`` it runs all passes without that sync.
Each phase of a pass runs inside its profiler span (utils/profiling.py).

Cone sharding (parallel/sharded.py): with a process ``group`` each rank
holds a shard of the cone blocks, and every cross-cone aggregation (the
Schur sums, the norm maxima, the slack-eigenvalue extrema, the line-search
interval) is an all-reduce over the group (parallel/collectives.py), where
the JAX package reduces over ``axis_name``.  Everything after a reduction
is replicated, so every host decision of the loop (its early exit) reads
the same values on every rank and the ranks make the same collectives.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import torch

from ..cones.base import local_vars, per_scenario, tree_map, tree_select
from ..config import (KKT_SOLVER_LDLT, KKT_SOLVER_LLT, SCHUR_PRECISION_MODES,
                      WARMSTART, SolverConfig)
from ..parallel.collectives import pany, pmax, pmin, psum
from ..supernodal.compressed import (CompressedSupernodalStructure, empty_buffer,
                                     scatter_contribution)
from ..supernodal.dist_compressed import DistributedCompressedStructure
from ..utils.profiling import counters, entry, span, spanned
from . import kkt
from .mu import SlackAgg, mu_from_divergence


class LoopState(NamedTuple):
    i: torch.Tensor  # (S,) int64 iteration counter
    ws: Tuple  # per-block cone iterates, each field (S, ...)
    y: torch.Tensor  # (S, n_kkt) KKT solution of the last iteration
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
    y_kkt: torch.Tensor  # (S, n_kkt) raw final KKT solution (equality duals in the tail)
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


def _scatter_mat(G, vars_, Gi):
    """Add a block's (S, v, v) contribution onto its variables of G
    (S, N, N), in place: the first v, or ``vars_`` (JAX ``_scatter_mat``)."""
    if vars_ is None:
        v = Gi.shape[-1]
        G[:, :v, :v] += Gi
    else:
        ix = torch.tensor(vars_, device=G.device)
        G[:, ix[:, None], ix[None, :]] += Gi


def _scatter_vec(x, vars_, xi):
    """The same for an (S, v) contribution to x (S, N)."""
    x[:, slice(0, xi.shape[-1]) if vars_ is None else list(vars_)] += xi


@spanned("conex.assemble")
def assemble(blocks, eq_blocks, ws, n_kkt: int, m: int, dtype, structure=None,
             group=None):
    """Assemble the (S, n_kkt, n_kkt) KKT matrices and residuals from the
    block contributions; n_kkt = m + the equality rows.

    reference: Assemble + AssembleSchurComplementResiduals
    (cone_program.cc:339-340, constraint_manager.h:107-124,
    equality_constraint.cc:13-28).  A cone block covers the first ``v``
    variables or scatters onto its ``vars_``; an equality block adds
    [0 A^T; A 0] on its dual rows and b to the tail of AQc.

    With a CompressedSupernodalStructure the matrices are the (S, buf_size)
    block-compressed buffers (supernodal/compressed.py): each contribution
    scatters straight into the per-clique blocks through a host-made index
    map — the compressed counterpart of SupernodalAssembler
    (supernodal_assembler.cc:72-141) — and no dense (N, N) matrix is built.
    A DistributedCompressedStructure assembles into its ``base`` buffer.

    With a process ``group`` (cone sharding) each rank adds its own blocks
    and the equality rows, and one all-reduce of one flat buffer sums the
    five outputs over the group (the JAX psum over ``axis_name``).  The
    equality blocks are replicated, so their rows are counted once per rank,
    as in the JAX package (conex_tpu/solver/loop.py:160-183).
    """
    outs = []
    for blk, w in zip(blocks, ws):
        with span("conex.schur"):
            outs.append(blk.schur(w))
    S, device = outs[0].G.shape[0], outs[0].G.device
    if isinstance(structure, DistributedCompressedStructure):
        structure = structure.base
    compressed = (structure if isinstance(structure, CompressedSupernodalStructure)
                  else None)
    if compressed is not None:
        G = empty_buffer(compressed, dtype, S, device)
    else:
        G = torch.zeros((S, n_kkt, n_kkt), dtype=dtype, device=device)
    AW = torch.zeros((S, n_kkt), dtype=dtype, device=device)
    AQc = torch.zeros((S, n_kkt), dtype=dtype, device=device)
    w_dot_c = torch.zeros((S,), dtype=dtype, device=device)
    c_dot_Qc = torch.zeros((S,), dtype=dtype, device=device)
    for blk, out in zip(blocks, outs):
        if compressed is not None:
            v = blk.vars_ if blk.vars_ is not None else tuple(range(out.G.shape[-1]))
            scatter_contribution(G, compressed, v, v, out.G)
        else:
            _scatter_mat(G, blk.vars_, out.G)
        _scatter_vec(AW, blk.vars_, out.AW)
        _scatter_vec(AQc, blk.vars_, out.AQc)
        w_dot_c = w_dot_c + out.w_dot_c
        c_dot_Qc = c_dot_Qc + out.c_dot_Qc
    for eq in eq_blocks:
        off = m + eq.dual_offset
        rows = slice(off, off + eq.p)
        if compressed is not None:
            dual_rows = tuple(range(off, off + eq.p))
            cols = eq.vars_ if eq.vars_ is not None else tuple(range(eq.num_vars))
            scatter_contribution(G, compressed, dual_rows, cols, eq.A)
            scatter_contribution(G, compressed, cols, dual_rows, eq.A.transpose(1, 2))
        else:
            cols = (slice(0, eq.num_vars) if eq.vars_ is None
                    else torch.tensor(eq.vars_, device=device))
            G[:, rows, cols] += eq.A
            G[:, cols, rows] += eq.A.transpose(1, 2)
        AQc[:, rows] += eq.b
    if compressed is not None:
        # The dump slot collects padding and mirrored-orientation writes;
        # nothing downstream may read what it accumulated.
        G[:, compressed.dump] = 0.0
    return psum((G, AW, AQc, w_dot_c, c_dot_Qc), group)


# ---------------------------------------------------------------------------
# Per-iteration cone sweeps
# ---------------------------------------------------------------------------


@spanned("conex.prepare_step")
def _prepare_step_all(blocks, ws, y, c_weight, e_weight, group=None):
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
    return tuple(caches), pmax(norminf, group), psum((normsq,), group)[0]


@spanned("conex.take_step")
def _take_step_all(blocks, ws, caches, step_size):
    """reference: TakeStep sweep, cone_program.h:92-97."""
    return tuple(
        blk.take_step(w, cache, step_size)
        for blk, w, cache in zip(blocks, ws, caches)
    )


@spanned("conex.slack_stats")
def _slack_stats_all(blocks, ws, y, c_weight, group=None):
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
    frob_sq, trace = psum((agg.frob_sq, agg.trace), group)
    return SlackAgg(lam_min=pmin(agg.lam_min, group),
                    lam_max=pmax(agg.lam_max, group), frob_sq=frob_sq, trace=trace)


def _identity_all(blocks, dtype):
    return tuple(blk.identity_state(dtype) for blk in blocks)


def _mu_line_search(blocks, ws, fac, config, AW, AQc_s, b_s_vec, c_scaling,
                    structure=None, group=None):
    """reference: ComputeMuFromLineSearch, cone_program.cc:118-160.  Per
    scenario: the largest admissible k of the segment from y0 to y1, or
    -1 where a block fails (a block without line search always does,
    reference constraint.h:24-28) or the intervals do not meet."""
    refine = config.iterative_refinement_iterations
    mode = config.kkt_solver
    y0 = kkt.solve(fac, -2.0 * AW, mode, refine, structure, group)
    y1 = kkt.solve(fac, AQc_s + b_s_vec - 2.0 * AW, mode, refine, structure,
                   group)
    lower = torch.full_like(c_scaling, -float("inf"))
    upper = torch.full_like(c_scaling, float("inf"))
    fail = torch.zeros(c_scaling.shape, dtype=torch.bool, device=c_scaling.device)
    for blk, w in zip(blocks, ws):
        if not getattr(blk, "supports_line_search", False):
            fail = torch.ones_like(fail)
            continue
        with span("conex.line_search"):
            lo, up, f = blk.line_search(
                w, local_vars(y0, blk.vars_, blk.num_vars),
                local_vars(y1, blk.vars_, blk.num_vars), 0.0, c_scaling,
                config.dinf_upper_bound,
            )
        lower = torch.maximum(lower, lo)
        upper = torch.minimum(upper, up)
        fail = fail | f
    lower, upper = pmax(lower, group), pmin(upper, group)
    fail = pany(fail, group) | (lower > upper)
    return torch.where(fail, torch.full_like(upper, -1.0), upper)


def _mu_divergence(blocks, ws, fac, config, AQc_s, b_s_vec, c_scaling, rank_k,
                   structure=None, group=None):
    """reference: ComputeMuFromDivergence, cone_program.cc:173-214."""
    ydiv = kkt.solve(
        fac, AQc_s - b_s_vec, config.kkt_solver,
        config.iterative_refinement_iterations, structure, group,
    )
    p = _slack_stats_all(blocks, ws, ydiv, c_scaling, group)
    return mu_from_divergence(p, rank_k, config.divergence_upper_bound)


def _merge(pred, on_true, on_false):
    """tree_select of two loop states (or iterate tuples), in its span."""
    with span("conex.select"):
        return tree_select(pred, on_true, on_false)


def _set_row(stats, i, value):
    """stats[s, i[s]] = value[s] for every scenario (rows of frozen
    scenarios are restored by the caller's select)."""
    idx = i.clamp(max=stats.shape[1] - 1)[:, None]
    return stats.scatter(1, idx, value[:, None].to(stats.dtype))


def _check_supported(config: SolverConfig):
    if config.schur_precision not in SCHUR_PRECISION_MODES:
        raise ValueError(
            f"unknown schur_precision {config.schur_precision!r}; "
            f"valid: {SCHUR_PRECISION_MODES}"
        )


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


@entry()
def _solve_impl(blocks, eq_blocks, b, init_ws, init_scalars,
                config: SolverConfig, kkt_structure=None, group=None,
                rank_override=None):
    """Solve S same-structure programs: b (S, m), block tensors and
    init_ws fields (S, ...), init_scalars k / b_scaling / c_scaling (S,).
    ``kkt_structure``: an optional supernodal structure (supernodal/) that
    every KKT assembly, factor and solve of the loop runs on.

    ``group``: set when the cone blocks are sharded over a process group
    (parallel/sharded.py): each rank holds a shard of the blocks and every
    cross-cone aggregation is an all-reduce over the group.
    ``rank_override`` must then be the global rank sum of the blocks."""
    _check_supported(config)
    with span("conex.solve"), _no_tf32() if b.is_cuda else contextlib.nullcontext():
        return _solve_loop(blocks, eq_blocks, b, init_ws, init_scalars, config,
                           kkt_structure, group, rank_override)


def _solve_loop(blocks, eq_blocks, b, init_ws, init_scalars,
                config: SolverConfig, kkt_structure=None, group=None,
                rank_override=None):
    dtype = b.dtype
    device = b.device
    S, m = b.shape
    # The equality duals follow the m primals in the KKT vector; b_full is
    # b padded with zeros to n_kkt (conex_tpu/solver/loop.py:353-356).
    n_kkt = m + sum(eq.p for eq in eq_blocks)
    b_full = torch.zeros((S, n_kkt), dtype=dtype, device=device)
    b_full[:, :m] = b

    rank_k = float(sum(blk.rank() for blk in blocks))
    if rank_override is not None:
        rank_k = float(rank_override)
    # The reference computes the KKT error only without quadratic costs
    # (cone_program.cc:463-468).
    has_qcost = any(getattr(blk, "is_cost", False) for blk in blocks)
    warmstart = config.initialization_mode == WARMSTART
    mode = config.kkt_solver
    refine = config.iterative_refinement_iterations
    island = kkt.island_dtype(config.kkt_island_dtype)
    T = config.max_iterations
    if mode not in (KKT_SOLVER_LLT, KKT_SOLVER_LDLT):
        # QR needs the dense matrix (reference kkt_solver.cc:174-177).
        kkt_structure = None

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
            blocks, eq_blocks, s.ws, n_kkt, m, dtype, kkt_structure, group
        )

        # --- First-iteration rescaling (cone_program.cc:343-357) ---
        if config.enable_rescaling:
            do_rescale = i < 1
            if not warmstart:
                b_scaling = torch.where(
                    do_rescale,
                    1.0 / (1.0 + torch.linalg.vector_norm(b_full, dim=-1)),
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
        fac = kkt.factor(G, mode, kkt_structure, group, island_dtype=island)

        # Both sides of the factor-fail branch are computed and merged with
        # per-scenario selects, as the JAX package does; values computed
        # from a failed factor are discarded by the selects.

        # --- Factor ok ---
        AQc_s = AQc * c_scaling[:, None]
        b_s_vec = b_full * b_scaling[:, None]

        # --- Mu update (cone_program.cc:374-403), branch-free ---
        with span("conex.mu"):
            if config.enable_line_search:
                temp = _mu_line_search(
                    blocks, s.ws, fac, config, AW, AQc_s, b_s_vec, c_scaling,
                    kkt_structure, group,
                )
                temp = torch.where(temp < 0, s.k, temp)
            else:
                temp = _mu_divergence(
                    blocks, s.ws, fac, config, AQc_s, b_s_vec, c_scaling, rank_k,
                    kkt_structure, group,
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
            fac, k[:, None] * (b_s_vec + AQc_s) - 2.0 * AW, mode, refine,
            kkt_structure, group,
        )

        # --- PrepareStep (cone_program.cc:416-426) ---
        c_weight = k * c_scaling
        caches, norminf, normsq = _prepare_step_all(
            blocks, s.ws, y, c_weight, 1.0, group
        )
        step_size = torch.clamp(2.0 / (norminf * norminf), max=1.0)

        ws_new = _take_step_all(blocks, s.ws, caches, step_size)
        # --- Warmstart abort on large step (cone_program.cc:428-436) ---
        if warmstart:
            abort = (i == 0) & (norminf >= config.warmstart_abort_threshold)
            ws_new = _merge(abort, _identity_all(blocks, dtype), ws_new)
        else:
            abort = torch.zeros_like(s.done)

        # --- Statistics (cone_program.cc:439-471) ---
        d_2sq = torch.abs(normsq)
        d_inf = torch.abs(norminf)
        by = torch.sum(b_full * y, dim=-1) / (k * c_scaling)
        cx = (
            2.0 * w_dot_c + torch.sum(AQc * y, dim=-1) - k * c_dot_Qc * c_scaling
        ) / (k * b_scaling)
        mu = 1.0 / (k * k)
        s_dot_x = mu * (rank_k - d_2sq) / (b_scaling * c_scaling)
        if has_qcost:
            kkt_error = s.kkt_error
        else:
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
            ws_fail = _merge(abort_f, _identity_all(blocks, dtype), s.ws)
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
        return _merge(ffail, s_fail, sn)

    @spanned("conex.pass")
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
        merged = _merge(s.done | stop_centering, s_marked, sn)
        # A scenario that was already done stays exactly as it was.
        return _merge(s.done, s, merged)

    def scalars(key):
        return init_scalars[key].to(dtype=dtype, device=device).reshape(S)

    def zeros(dt=dtype):
        return torch.zeros((S,), dtype=dt, device=device)

    false = zeros(torch.bool)
    izero = zeros(torch.int64)
    s = LoopState(
        i=izero,
        ws=tuple(init_ws),
        y=torch.zeros((S, n_kkt), dtype=dtype, device=device),
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
    # Under a group, ``done`` comes from reduced and replicated values: the
    # same on every rank, which all leave the loop at the same pass.  No
    # scenario is done before the first pass; after each pass one read of
    # the count of those not done (under fixed_iterations none: every
    # scenario counts as live) decides whether another follows.
    live = S
    for _ in range(T):
        counters["loop.passes"] += 1
        counters["loop.scenario_passes"] += S
        counters["loop.live_scenario_passes"] += live
        s = body(s)
        if not config.fixed_iterations:
            counters["sync.loop.done"] += 1
            live = int((~s.done).sum())
            if live == 0:
                break
    return _epilogue(s, blocks, eq_blocks, b_full, n_kkt, m, dtype, config,
                     kkt_structure, group, island)


@spanned("conex.epilogue")
def _epilogue(s: LoopState, blocks, eq_blocks, b_full, n_kkt, m, dtype,
              config: SolverConfig, kkt_structure, group, island) -> SolveResult:
    # --- Epilogue (cone_program.cc:485-532) ---
    mode = config.kkt_solver
    refine = config.iterative_refinement_iterations
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
        G, AW, AQc, _, _ = assemble(blocks, eq_blocks, ws_final, n_kkt, m, dtype,
                                    kkt_structure, group)
        fac = kkt.factor(G, mode, kkt_structure, group, island_dtype=island)
        bres = s.k[:, None] * b_full * s.b_scaling[:, None] - AW
        y2 = kkt.solve(fac, bres, mode, refine, kkt_structure, group)
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
    eq1 = tuple(_add_scenario(eq) for eq in eq_blocks)
    ws1 = tuple(_add_scenario(w) for w in init_ws)
    scalars1 = {key: torch.as_tensor(x)[None] for key, x in init_scalars.items()}
    res = _solve_impl(blocks1, eq1, b[None], ws1, scalars1, config)
    return _strip_scenario(res)


def _add_scenario(tree):
    """A leading scenario axis of one on every tensor of a block dataclass,
    a state NamedTuple, a dict or a bare tensor; other fields stay as they
    are."""
    return tree_map(lambda x: x[None], tree)


def _strip_scenario(tree):
    return tree_map(lambda x: x[0], tree)

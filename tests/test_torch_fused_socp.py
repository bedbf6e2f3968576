"""The port's fused batched-SOCP path (parallel/fused_socp.py) against the
JAX package's ``solve_socp_fused``, in f64.

On the CPU the port runs ``solve_socp_plain`` (the kernel's body in plain
PyTorch) and the JAX package runs its Pallas kernel in interpret mode, as
tests/test_fused_socp.py runs it.  Every field of FusedSOCPResult is
compared.  Tolerances: iteration counts and every status flag exactly
equal; b_scaling and c_scaling rtol 1e-12 (closed forms of the first
iteration); k and stats_k rtol 1e-6, y and y_kkt within 1e-6 and w within
1e-5 of their 2-norm in every scenario, and stats_dinf rtol 1e-6 with an
absolute floor of 1e-4.  The two sum in other orders, and the difference
grows with the conditioning of G as k climbs: ~1e-9 on most scenarios and
up to ~1e-7 (1e-6 on the final iterate) on one that converges fast to a
large scaled k (see tests/test_torch_soc.py, which measures the same on
the general path).

The CUDA kernel itself is held against ``solve_socp_plain`` by the
``gpu`` test below and by chip_smoke.py phase 3b on the card.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from conex_tpu.config import WARMSTART as JWARMSTART, SolverConfig as JConfig
from conex_tpu.parallel.fused_socp import solve_socp_fused as jfused

import conex_tpu_torch as ct
from conex_tpu_torch import convert
from conex_tpu_torch.parallel import fused_socp
from conex_tpu_torch.parallel.fused_socp import FusedSOCPResult, solve_socp_fused
from conex_tpu_torch.utils.profiling import counters

from test_torch_soc import _close_per_scenario, random_socp


def _run_both(A, c, b, cfg, **init):
    """(JAX result, port result) of solve_socp_fused, both as numpy."""
    rj = jfused(A, c, b, JConfig(**cfg), **init)
    rt = solve_socp_fused(*map(convert.tensor, (A, c, b)), ct.SolverConfig(**cfg),
                          **{k: convert.tensor(v) for k, v in init.items()})
    return jax.tree.map(np.asarray, rj), convert.to_numpy(rt)


def _assert_same(rj, rt):
    assert rt._fields == rj._fields == FusedSOCPResult._fields
    for name in ("num_iterations", "solved", "primal_infeasible", "dual_infeasible",
                 "warmstart_aborted", "fail", "mu_stalled"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    np.testing.assert_allclose(rt.b_scaling, rj.b_scaling, rtol=1e-12)
    np.testing.assert_allclose(rt.c_scaling, rj.c_scaling, rtol=1e-12)
    np.testing.assert_allclose(rt.k, rj.k, rtol=1e-6)
    np.testing.assert_allclose(rt.stats_k, rj.stats_k, rtol=1e-6)
    np.testing.assert_allclose(rt.stats_dinf, rj.stats_dinf, rtol=1e-6, atol=1e-4)
    _close_per_scenario(rt.y, rj.y, 1e-6)
    _close_per_scenario(rt.y_kkt, rj.y_kkt, 1e-6)
    _close_per_scenario(rt.w, rj.w, 1e-5)


CFG = dict(max_iterations=30)


def test_fused_feasible_refinement_and_stall_match_jax():
    A, c, b = random_socp(np.random.default_rng(6), S=9, nc=1, n=4, m=3)
    rj, rt = _run_both(A, c, b, dict(CFG, iterative_refinement_iterations=1,
                                     mu_stall_iterations=4))
    assert rj.solved.all()
    _assert_same(rj, rt)


def test_fused_three_cones_dual_recovery_match_jax():
    A, c, b = random_socp(np.random.default_rng(8), S=9, nc=3, n=4, m=3)
    rj, rt = _run_both(A, c, b, dict(CFG, prepare_dual_variables=True))
    assert rj.solved.all()
    _assert_same(rj, rt)
    # The recovered dual x = 2 w / (k b_scaling) satisfies A'x = b.
    x = 2.0 * rt.w / (rt.k * rt.b_scaling)[:, None, None]
    r = np.einsum("scnv,scn->sv", A, x) - b
    assert np.abs(r).max() < 1e-4 * max(1.0, np.abs(b).max())


def test_fused_infeasible_and_factor_failure_match_jax():
    """Random objectives at 60 iterations (unbounded scenarios run out of
    iterations unsolved), and scenario 2 with an all-zero column of A,
    whose factorization fails at iteration 0."""
    A, c, b = random_socp(np.random.default_rng(3), S=8, nc=1, n=4, m=3,
                          feasible=False)
    A[2, :, :, 1] = 0.0
    rj, rt = _run_both(A, c, b, dict(CFG, max_iterations=60))
    assert rj.fail.tolist() == [False, False, True] + [False] * 5
    assert int(rj.num_iterations[2]) == 0 and not rj.solved.all()
    _assert_same(rj, rt)


def test_fused_fixed_iteration_mode_matches_jax():
    """benchmarks/bench_socp.py's configuration: no early exit, no final
    centering."""
    A, c, b = random_socp(np.random.default_rng(19), S=4, nc=1, n=20, m=10)
    rj, rt = _run_both(A, c, b, dict(max_iterations=14, final_centering_steps=0,
                                     inv_sqrt_mu_max=1e15, kkt_error_tolerance=1e45,
                                     fixed_iterations=True))
    assert (rt.num_iterations == 14).all() and not rt.fail.any()
    _assert_same(rj, rt)


def test_fused_warmstart_continuation_matches_jax():
    """Stop a coldstart solve after 6 fixed iterations and resume both
    packages from the JAX package's state (w, k, scalings)."""
    A, c, b = random_socp(np.random.default_rng(41), S=7, nc=2, n=4, m=3)
    cfg1 = dict(max_iterations=6, final_centering_steps=0, fixed_iterations=True)
    part_j, part_t = _run_both(A, c, b, cfg1)
    _assert_same(part_j, part_t)
    init = dict(init_w=part_j.w, init_k=part_j.k, init_b_scaling=part_j.b_scaling,
                init_c_scaling=part_j.c_scaling)
    rj, rt = _run_both(A, c, b, dict(CFG, initialization_mode=JWARMSTART), **init)
    assert rj.solved.all() and not rj.warmstart_aborted.any()
    _assert_same(rj, rt)


def test_fused_warmstart_abort_matches_jax():
    """A poisoned warmstart iterate (w0 = 1e6) aborts to the identity on its
    first step and still converges (cone_program.cc:428-436)."""
    A, c, b = random_socp(np.random.default_rng(43), S=5, nc=1, n=4, m=3)
    w_bad = np.zeros((5, 1, 5))
    w_bad[..., 0] = 1e6
    rj, rt = _run_both(A, c, b, dict(max_iterations=40, initialization_mode=JWARMSTART,
                                     warmstart_abort_threshold=2.0),
                       init_w=w_bad, init_k=np.ones(5))
    assert rj.solved.all() and (rj.stats_dinf[:, 0] >= 2.0).all()
    _assert_same(rj, rt)


def test_fused_3d_shorthand_matches_jax():
    """(S, n+1, m) single-cone shorthand, and S not a multiple of anything
    (the JAX package pads to 128 lanes; the port needs no padding)."""
    A, c, b = random_socp(np.random.default_rng(31), S=5, nc=1, n=3, m=2)
    rj, rt4 = _run_both(A, c, b, CFG)
    rt3 = convert.to_numpy(solve_socp_fused(
        *map(convert.tensor, (A[:, 0], c[:, 0], b)), ct.SolverConfig(**CFG),
        block_size=128, interpret=True))
    for f3, f4 in zip(rt3, rt4):
        np.testing.assert_array_equal(f3, f4)
    _assert_same(rj, rt4)


def test_fused_config_validation():
    A, c, b = map(convert.tensor, random_socp(np.random.default_rng(1), S=2, nc=1, n=3, m=2))
    with pytest.raises(ValueError, match="divergence-mode"):
        solve_socp_fused(A, c, b, ct.SolverConfig(enable_line_search=True))
    with pytest.raises(ValueError, match="LLT only"):
        solve_socp_fused(A, c, b, ct.SolverConfig(kkt_solver=ct.KKT_SOLVER_LDLT))


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    A, c, b = (convert.tensor(x) for x in random_socp(np.random.default_rng(2), 3, 1, 3, 2))
    before = counters["socp.calls"]
    out = solve_socp_fused(A, c, b, ct.SolverConfig(max_iterations=5))
    assert counters["socp.calls"] == before
    assert out.y.shape == (3, 2) and out.stats_k.shape == (3, 5)
    w0 = torch.zeros(3, 1, 4, dtype=torch.float64)
    ones = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_socp.solve_socp_kernel(A, c, b, w0, ones, ones, ones, ct.SolverConfig())
    with pytest.raises(ValueError, match="tensor on"):
        solve_socp_fused(A, c, torch.ones(3, 2, dtype=torch.float64, device="meta"),
                         ct.SolverConfig())


def test_arrays_go_to_the_card(monkeypatch):
    """Inputs that are not tensors go to the card, never to the CPU: with
    no card the call raises, and the plain version is not reached."""
    A, c, b = random_socp(np.random.default_rng(4), S=3, nc=1, n=3, m=2)
    cfg = ct.SolverConfig(max_iterations=5)
    if torch.cuda.is_available():
        assert solve_socp_fused(A, c, b, cfg).y.device.type == "cuda"
        return

    def no_cpu_solve(*args):
        raise AssertionError("array inputs reached the CPU solve")

    monkeypatch.setattr(fused_socp, "solve_socp_plain", no_cpu_solve)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        solve_socp_fused(A, c, b, cfg)


# The kernel against its plain version in f32, relative: the two round
# alike and measure equal to the bit on an H100, while a change of rounding
# (FMA contraction) moves a 30-iteration trajectory by a median 0.19; ten
# float32 ulps admit the first and nothing of the second.
F32_RTOL = 1e-6


# (S, nc, n1, m): the bench shape, phase 3b's small batches, chip_smoke's
# global-route batch (shared in f32, global in f64) and a large m.
PLAN_SHAPES = {"bench": (100_000, 1, 21, 10), "bench_small": (1_000, 1, 21, 10),
               "phase3b": (300, 3, 5, 3), "global_f64": (64, 4, 250, 16),
               "large_m": (7, 1, 21, 200)}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES.values(), ids=PLAN_SHAPES.keys())
def test_socp_plan_covers_fits_and_routes(shape, itemsize):
    """socp_plan: every scenario in exactly one block, TEAM divides 32,
    blocks within the launch bounds and the shared-memory budget, and the
    global route taken exactly where one scenario's working set exceeds
    the budget; the default TEAM is one the library holds."""
    S, nc, n1, m = shape
    T = 30
    one = fused_socp.shared_elems(nc, n1, m) * itemsize
    for team in (None,) + fused_socp.ALL_TEAMS:
        plan = fused_socp.socp_plan(S, nc, n1, m, itemsize, T, team=team)
        assert 32 % plan.team == 0
        assert plan.team == (fused_socp.default_team(S) if team is None else team)
        assert fused_socp.default_team(S) in fused_socp.TEAMS
        ranges = [plan.scenarios(blk) for blk in range(plan.blocks)]
        assert ranges[0].start == 0 and ranges[-1].stop == S
        assert all(len(r) > 0 for r in ranges)
        assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
        assert 1 <= plan.per_block and plan.threads <= fused_socp.MAX_THREADS
        assert plan.shared_bytes <= fused_socp.SHARED_BUDGET
        assert (plan.route == "global") == (one > fused_socp.SHARED_BUDGET)
        if plan.shared:
            assert plan.stride % 2 == 1
            assert plan.stride * itemsize * plan.per_block == plan.shared_bytes
            assert plan.scratch_shape == (0,)
        else:
            assert plan.shared_bytes == 0
            assert plan.scratch_shape == (S, fused_socp.working_elems(nc, n1, m))
        assert plan.traffic_bytes(T * S) > 0
    if one > fused_socp.SHARED_BUDGET:
        with pytest.raises(ValueError, match="exceeds"):
            fused_socp.socp_plan(S, nc, n1, m, itemsize, T, route="shared")
    with pytest.raises(ValueError, match="team"):
        fused_socp.socp_plan(S, nc, n1, m, itemsize, T, team=3)


def test_bench_plan_keeps_the_solve_in_shared_memory():
    """At the bench shape the plan's device-memory traffic is the inputs
    read once and the outputs written once (f32, S = 100,000: under
    0.2 GB), and the global route adds the working set per iteration."""
    shared = fused_socp.socp_plan(100_000, 1, 21, 10, 4, 30)
    glob = fused_socp.socp_plan(100_000, 1, 21, 10, 4, 30, route="global")
    assert shared.route == "shared" and glob.route == "global"
    assert shared.team == 8
    assert fused_socp.socp_plan(1_000, 1, 21, 10, 4, 30).team == 32
    io = 4 * 100_000 * (210 + 42 + 10 + 3) + 4 * 100_000 * (10 + 21 + 6 + 60) + 20 * 100_000
    assert shared.traffic_bytes(3_000_000) == io < 0.2e9
    assert glob.traffic_bytes(3_000_000) == io + 2 * 4 * fused_socp.working_elems(1, 21, 10) * 3_000_000


@pytest.mark.gpu
@pytest.mark.parametrize("route,team", [("default", None), ("shared", 8), ("shared", 32),
                                        ("global", 8), ("global", 32)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_matches_plain_on_card(dtype, route, team):
    """The CUDA kernel, through solve_socp_fused under its default plan
    and on both routes under the library's two TEAM sizes, against
    solve_socp_plain on the card, on the same inputs in the same dtype
    (chip_smoke.py phase 3b's rules): iteration counts and every status
    flag equal, and every floating field within 1e-8 relative in f64 and
    F32_RTOL in f32 (the two take every sum in the same order and measure
    equal to the bit).  In f32 also against the f64 plain version: the
    first two iterations within 1e-3 at the median."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, c, b = random_socp(np.random.default_rng(5), S=300, nc=3, n=4, m=3)
    cfg = ct.SolverConfig(max_iterations=30, prepare_dual_variables=True,
                          iterative_refinement_iterations=1)
    args64 = [convert.tensor(x, "cuda") for x in (A, c, b)]
    S, nc, n1, _ = A.shape
    w0 = torch.zeros((S, nc, n1), dtype=torch.float64, device="cuda")
    w0[..., 0] = 1.0
    zeros, ones = (torch.full((S,), v, dtype=torch.float64, device="cuda") for v in (0.0, 1.0))
    inits = (w0, zeros, ones, ones)

    def plain(dt):
        raw = fused_socp.solve_socp_plain(*(x.to(dt) for x in (*args64, *inits)), cfg)
        return convert.to_numpy(fused_socp.epilogue(raw, cfg))

    before = counters["socp.calls"]
    if route == "default":
        got = solve_socp_fused(*(x.to(dtype) for x in args64), cfg)
    else:
        inputs = [x.to(dtype) for x in (*args64, *inits)]
        plan = fused_socp.socp_plan(S, nc, n1, A.shape[3], inputs[0].element_size(),
                                    cfg.max_iterations, team=team, route=route)
        got = fused_socp.epilogue(fused_socp.solve_socp_kernel(*inputs, cfg, plan=plan),
                                  cfg)
    torch.cuda.synchronize()
    assert counters["socp.calls"] == before + 1
    got, want = convert.to_numpy(got), plain(dtype)
    for name in ("num_iterations", "solved", "fail", "primal_infeasible",
                 "dual_infeasible", "mu_stalled", "warmstart_aborted"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    rtol = 1e-8 if dtype == torch.float64 else F32_RTOL
    for name in ("k", "b_scaling", "c_scaling", "stats_k", "stats_dinf"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=rtol,
                                   atol=0, err_msg=name)
    for name in ("y", "y_kkt", "w"):
        _close_per_scenario(getattr(got, name), getattr(want, name), rtol)
    if dtype == torch.float32:
        oracle = plain(torch.float64)
        rel = np.abs(got.stats_k[:, :2] - oracle.stats_k[:, :2]) / np.abs(oracle.stats_k[:, :2])
        assert np.median(rel) <= 1e-3

"""The port's spans and counters (conex_tpu_torch/utils/profiling.py), on
the CPU.

Under torch.profiler a solve leaves one span per layer boundary, nested as
the layers are (``conex.call/<n>`` outermost, then ``conex.solve``,
``conex.pass`` and the phases of a pass); ``counters`` counts the solve
loop's passes, the scenario passes and the live ones of a batch, and each
host sync by its site; with no profiler running no span is opened at all.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import conex_tpu_torch as ct
from conex_tpu_torch.parallel.sharded import solve_scenarios
from conex_tpu_torch.utils import profiling
from conex_tpu_torch.utils.profiling import counters, span

# Each span's enclosing span, for the spans of one Program request.
PARENTS = {
    "conex.call": {None},
    "conex.program.add": {None},
    "conex.program.dual": {None},
    "conex.program.copy_out": {"conex.call"},
    "conex.solve": {"conex.call"},
    "conex.pass": {"conex.solve"},
    "conex.epilogue": {"conex.solve"},
    "conex.assemble": {"conex.pass", "conex.epilogue"},
    "conex.schur": {"conex.assemble"},
    "conex.factor": {"conex.pass", "conex.epilogue"},
    "conex.mu": {"conex.pass"},
    "conex.kkt_solve": {"conex.mu", "conex.pass", "conex.epilogue"},
    "conex.slack_stats": {"conex.mu"},
    "conex.line_search": {"conex.mu"},
    "conex.prepare_step": {"conex.pass"},
    "conex.take_step": {"conex.pass"},
    "conex.select": {"conex.pass"},
    "conex.lp.split": {"conex.solve"},
}


def _lmi(seed, m=3, n=6):
    rng = np.random.default_rng(seed)
    A = np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, n, n))])
    return A, np.eye(n) * 3.0


def _row(name):
    return "conex.call" if name.startswith("conex.call/") else name


def _traced(fn, tmp_path):
    """fn's result, the conex spans of its trace as (name, ts, end) in start
    order, and the counters' differences over the call."""
    before = counters.copy()
    with profiling.trace(tmp_path):
        out = fn()
    diff = {k: v - before.get(k, 0) for k, v in counters.items() if v != before.get(k, 0)}
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                   if str(e.get("name", "")).startswith("conex.") and "dur" in e
                   and not str(e.get("cat", "")).startswith("gpu"))
    return out, [(name, ts, ts - neg) for ts, neg, name in spans], diff


def _parents(spans):
    """(span name, enclosing span name or None) of each span."""
    out, stack = [], []
    for name, ts, end in spans:
        while stack and stack[-1][2] <= ts:
            stack.pop()
        out.append((_row(name), _row(stack[-1][0]) if stack else None))
        stack.append((name, ts, end))
    return out


def _request(line_search):
    if line_search:  # an LP: its cones take the line-search mu update
        A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
        prog = ct.Program(2, device="cpu")
        prog.add_linear_constraint(A, np.array([2.0, 3.0, 4.0]))
        b = np.array([1.0, 2.0])
    else:
        A, C = _lmi(0)
        prog = ct.Program(3, device="cpu")
        prog.add_lmi_constraint(A, C)
        b = np.ones(3)
    config = ct.SolverConfig(max_iterations=40, inv_sqrt_mu_max=1e4,
                             prepare_dual_variables=True, enable_line_search=line_search)
    res = prog.solve(b, config)
    prog.get_dual_variable(0)
    return res


@pytest.mark.parametrize("line_search", [False, True])
def test_a_request_leaves_each_span_nested_as_its_layers(line_search, tmp_path):
    res, spans, diff = _traced(lambda: _request(line_search), tmp_path)
    assert res.solved
    pairs = _parents(spans)
    names = {name for name, _ in pairs}
    mu_phase = "conex.line_search" if line_search else "conex.slack_stats"
    # The LP's rows are split once per solve (cones/lp.py); the SDP has none.
    own = {mu_phase, "conex.lp.split"} if line_search else {mu_phase}
    assert set(PARENTS) - {"conex.line_search", "conex.slack_stats", "conex.lp.split"} | own <= names
    for name, parent in pairs:
        assert parent in PARENTS[name], (name, parent)
    # One call, one entry span, named by its ordinal in ``calls``.
    calls = [name for name, _, _ in spans if name.startswith("conex.call/")]
    assert calls == [f"conex.call/{counters['calls']}"] and diff["calls"] == 1
    assert [name for name, _ in pairs].count("conex.pass") == diff["loop.passes"]
    assert res.num_iterations <= diff["loop.passes"] <= res.num_iterations + 1


def test_a_batch_counts_its_live_scenario_passes(tmp_path):
    """Three programs that stop at different passes: every pass computes
    all three, and a scenario is live until the pass that finishes it."""
    S = 3
    As, Cs, bs = [], [], []
    for seed in range(S):
        A, C = _lmi(seed + 1)
        As.append(A[None])
        Cs.append(C[None])
        bs.append(np.random.default_rng(seed).uniform(0.5, 1.5, 3))
    blk = ct.DenseLMICone(A=torch.tensor(np.stack(As)), C=torch.tensor(np.stack(Cs)))
    one = torch.ones(S, dtype=torch.float64)
    config = ct.SolverConfig(max_iterations=60, inv_sqrt_mu_max=1e4)
    res, spans, diff = _traced(lambda: solve_scenarios(
        (blk,), (), torch.tensor(np.stack(bs)), (blk.identity_state(torch.float64),),
        dict(k=0 * one, b_scaling=one, c_scaling=one), config), tmp_path)
    iters = res.num_iterations.tolist()
    assert len(set(iters)) > 1, iters
    passes = diff["loop.passes"]
    assert sum(name == "conex.pass" for name, _, _ in spans) == passes
    assert diff["loop.scenario_passes"] == S * passes
    assert sum(iters) <= diff["loop.live_scenario_passes"] <= sum(iters) + S
    assert diff["calls"] == 1 and sum(name.startswith("conex.call/") for name, _, _ in spans) == 1


def test_a_pass_selects_the_loop_state_once(tmp_path):
    """A coldstart pass of a one-block dense SDP selects its outcome once:
    the few fields in which done, marked and failed scenarios differ from
    the state they started the pass with, then the whole state, so at
    most 40 ``where`` kernels (three whole-state merges of the 30 tensors
    took 90), all inside ``conex.select`` spans that nest under
    ``conex.pass``."""
    A, C = _lmi(6)
    prog = ct.Program(3, device="cpu")
    prog.add_lmi_constraint(A, C)
    _, spans, diff = _traced(
        lambda: prog.solve(np.ones(3), ct.SolverConfig(max_iterations=1)), tmp_path)
    assert diff["loop.passes"] == 1
    selects = [(ts, end) for name, ts, end in spans if name == "conex.select"]
    assert selects
    assert {parent for name, parent in _parents(spans) if name == "conex.select"} == {
        "conex.pass"}
    (path,) = tmp_path.glob("*.json")
    wheres = [e["ts"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") == "aten::where" and "dur" in e]
    inside = sum(any(ts <= w <= end for ts, end in selects) for w in wheres)
    assert 0 < inside <= 40, inside


def test_the_divergence_update_syncs_once_a_pass_and_the_psd_block_twice():
    A, C = _lmi(4)
    prog = ct.Program(3, device="cpu")
    prog.add_lmi_constraint(A, C)
    before = counters.copy()
    res = prog.solve(np.ones(3), ct.SolverConfig(max_iterations=40, inv_sqrt_mu_max=1e4))
    diff = {k: v - before.get(k, 0) for k, v in counters.items()}
    passes = diff["loop.passes"]
    assert res.solved and passes >= res.num_iterations
    assert diff["sync.loop.done"] == passes
    assert diff["sync.cone.cold"] == 2 * passes
    assert diff["sync.front_end.copy_in"] == 1  # b; A and C went in at add time
    assert diff["sync.front_end.copy_out"] == len(res._raw) - 1 + len(res._raw.ws[0])


def test_fixed_iterations_count_no_sync_of_the_loop():
    A, C = _lmi(5)
    prog = ct.Program(3, device="cpu")
    prog.add_lmi_constraint(A, C)
    before = counters.copy()
    prog.solve(np.ones(3), ct.SolverConfig(max_iterations=4, fixed_iterations=True))
    diff = {k: v - before.get(k, 0) for k, v in counters.items()}
    assert diff["loop.passes"] == 4 and diff["sync.loop.done"] == 0
    assert diff["loop.live_scenario_passes"] == diff["loop.scenario_passes"] == 4


def test_with_no_profiler_a_solve_opens_no_span(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("conex.anything") is span("conex.other")
    res = _request(line_search=False)
    assert res.solved


def test_an_entry_inside_another_is_one_call():
    before = counters["calls"]
    with profiling.entry():
        with profiling.entry():
            pass
    assert counters["calls"] == before + 1


# The Lorentz-cone block's spans (cones/soc.py) and where each opens.
SOC_PARENTS = {
    "conex.soc.schur": {"conex.schur"},
    "conex.soc.step": {"conex.prepare_step", "conex.take_step", "conex.slack_stats",
                       "conex.epilogue"},
}


def _portfolio(name, S=2, **solver):
    """S programs of a portbench class at k = 2, n = 20 through
    solve_scenarios, under the configuration's solver settings and
    ``solver``: the tracking-error SOCP (an SOCCone of two cones, the box's
    LinearCone, the equality rows) or the portfolio QP."""
    from portbench import spec
    from portbench.workload import solver_config

    problem = spec.load_problem(name)
    config = dict(spec.load_config({"portfolio_te": "portfolio_te_k10",
                                    "osqp_portfolio": "osqp_portfolio_k10"}[name]), k=2, n=20)
    data = problem.make(config, 0, 0, S, torch.float64, "cpu")
    blocks, eq, b = problem.scenario_batch(data)
    ws, scalars = problem.scenario_start(blocks, b, torch.float64, "cpu")
    return solve_scenarios(blocks, eq, b, ws, scalars, solver_config(config).replace(**solver))


def test_a_solve_with_an_soc_block_opens_its_spans_and_counts_its_cones(tmp_path):
    """The Schur block inside conex.schur, the steps inside the phase that
    calls them (the dual recovery's affine step inside conex.epilogue);
    soc.cones counts the block's two cones once per solve,
    soc.schur.calls each Schur block, one a conex.soc.schur span."""
    res, spans, diff = _traced(
        lambda: _portfolio("portfolio_te", prepare_dual_variables=True), tmp_path)
    assert res.solved.all()
    pairs = _parents(spans)
    ldlt = {"conex.ldlt": {"conex.factor"}, "conex.ldlt.update": {"conex.ldlt"}}
    for name, parent in pairs:
        assert parent in {**PARENTS, **ldlt, **SOC_PARENTS}[name], (name, parent)
    opened = {name for name, _ in pairs}
    assert set(SOC_PARENTS) <= opened and "conex.slack_stats" in opened
    schur = [name for name, _ in pairs].count("conex.soc.schur")
    assert diff["soc.cones"] == 2 and diff["soc.schur.calls"] == schur
    # One Schur block a pass, and one more for the dual recovery.
    assert schur == diff["loop.passes"] + 1
    assert {parent for name, parent in pairs if name == "conex.soc.step"} == SOC_PARENTS[
        "conex.soc.step"]


@pytest.mark.parametrize("request_of", ["sdp", "lp", "osqp_portfolio"])
def test_a_solve_without_an_soc_block_opens_no_soc_span_and_counts_nothing_of_it(
        request_of, tmp_path):
    """The dense SDP, the LP request and the portfolio QP: no conex.soc.*
    span, no soc.* counter."""
    fn = {"sdp": lambda: _request(False), "lp": lambda: _request(True),
          "osqp_portfolio": lambda: _portfolio("osqp_portfolio")}[request_of]
    _, spans, diff = _traced(fn, tmp_path)
    assert not [name for name, _, _ in spans if name.startswith("conex.soc.")]
    assert not [key for key in diff if key.startswith("soc.")]
    assert diff["loop.passes"] > 0

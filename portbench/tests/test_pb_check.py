"""The correctness check at small shapes on the CPU, in every cell whose
configuration is of the dense_sdp class: a sound run passes each cell's
limits; the control (the port's float32 path) and a timed path broken
underneath fail them, each planted answer fault (faults.py) by the number
that is there to catch it."""

import time

import pytest
import torch

from portbench import faults, spec
from portbench.harness import run_cell

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]
         if spec.load_config(w["config"])["class"] == "dense_sdp"]
SEED = 3_000_000_029


def _small(cell_name):
    cell = spec.workload(BENCH, cell_name)
    config = spec.load_config(cell["config"])
    config.update(n=10, m=8 if config["m"] <= config["n"] else 12)
    traffic = spec.load_traffic(cell["traffic"])
    if traffic["driver"] == "scenarios":
        traffic.update(batch=16, pool=2)
    else:
        traffic.update(pool=4, chunk=2)
    return cell, config, traffic


def _run(cell_name, seconds=0.5, seed=SEED, pool=None, **kw):
    cell, config, traffic = _small(cell_name)
    traffic.update(pool=pool or traffic["pool"])
    return run_cell(BENCH, cell, seed, seconds, False, "cpu", time.perf_counter(),
                    config=config, traffic=traffic, **kw)[0]


def _failed(out):
    return {k for k, v in out["checks"].items() if not v["value"] <= v["limit"]}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(spec.load_limits(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(cell):
    assert not _run(cell, dtype="float32")["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from conex_tpu_torch.cones import psd

    monkeypatch.setattr(psd.DenseLMICone, "take_step", lambda self, state, cache, step: state)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    faults.plant("altered", monkeypatch.setattr)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_left_at_zero_is_not_correct_by_its_infeasibility(cell, monkeypatch):
    # Flagged solved with a gap of 0: only the infeasibility catches it.
    faults.plant("zero", monkeypatch.setattr)
    out = _run(cell)
    assert out["failed"] == 0 and _failed(out) == {"infeas"}


@pytest.mark.parametrize("cell", CELLS)
def test_one_program_in_16_altered_is_not_correct_by_the_unsolved_share(cell, monkeypatch):
    faults.plant("rows", monkeypatch.setattr)
    # A batch of 16 holds one altered program; one request at a time, a
    # whole cycle of 16 does.
    single = spec.load_traffic(spec.workload(BENCH, cell)["traffic"])["driver"] == "program"
    out = _run(cell, pool=faults.EVERY if single else None)
    assert out["failed"] >= 1 and _failed(out) == {"unsolved"}


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if spec.load_traffic(c.split(".")[1])["driver"] == "scenarios"])
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from conex_tpu_torch.cones.base import tree_map
    from conex_tpu_torch.parallel import sharded

    solve = sharded.solve_scenarios

    def half(blocks, eq_blocks, b, init_ws, init_scalars, config):
        # Solve the first half; the second half gets the first half's answers.
        h = b.shape[0] // 2
        cut = lambda tree: tree_map(lambda x: x[:h] if x.dim() else x, tree)
        res = solve(cut(blocks), cut(eq_blocks), b[:h], cut(init_ws),
                    {k: v[:h] for k, v in init_scalars.items()}, config)
        return tree_map(lambda x: torch.cat([x, x]) if x.dim() else x, res)

    monkeypatch.setattr(sharded, "solve_scenarios", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_solves_whole_cycles_of_the_same_programs(cell):
    _, _, traffic = _small(cell)
    per_cycle = traffic["pool"] * traffic.get("batch", 1)
    outs = [_run(cell, seed=seed) for seed in (SEED, 2**31 + 7)]
    for out in outs:
        assert out["attempted"] % per_cycle == 0 and out["attempted"] >= per_cycle
    assert outs[0]["checks"]["infeas"] == outs[1]["checks"]["infeas"]

"""The reader block_schur_ms: the device busy ms a pass charged to
conex.schur in one traced call."""

import pytest

from portbench import phases, spec


def _phases(rows, passes):
    return phases.Phases(window_s=1.0, busy_s=0.5, rows=rows, passes=passes)


@pytest.mark.parametrize("rows,passes,want", [
    ({"conex.schur": phases.Row(count=40, busy_s=0.3064), "conex.pass": phases.Row(count=40)},
     40, 7.66),
    ({"conex.schur": phases.Row(count=3, busy_s=0.0006)}, 3, 0.2),
    ({"conex.pass": phases.Row(count=40)}, 40, None),
    ({"conex.schur": phases.Row(count=1, busy_s=0.001)}, 0, None),
    ({}, 0, None),
], ids=["portfolio_parent", "small", "no_span", "no_passes", "nothing"])
def test_block_schur_ms_reads_the_span_busy_time_a_pass(monkeypatch, rows, passes, want):
    ph = _phases(rows, passes)
    monkeypatch.setattr(phases, "measure", lambda ctx: ph)
    got = spec.load_metric("block_schur_ms").read(None)
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


def test_the_metric_is_declared_for_the_portfolio_cell_alone():
    entry = {e["name"]: e for e in spec.load_benchmark()["per_layer"]}["block_schur_ms"]
    assert entry["workloads"] == ["osqp_portfolio_k10.qp_b64"]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"], entry["layer"]) == (
        "ms", "lower", "device_trace", "solved_per_s", "cone (cones/lp.py, cones/qcost.py)")

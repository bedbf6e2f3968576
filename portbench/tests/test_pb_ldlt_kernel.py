"""The reader ldlt_kernel_pct: the share of one call's LDLT column steps
that the port's panel kernel took, from the port's counters."""

import pytest
import torch

from portbench import phases, spec


@pytest.mark.parametrize("counted,want", [
    ({"kkt.ldlt.calls": 40, "kkt.ldlt.columns": 40840,
      "kkt.ldlt.kernel_columns": 40840, "kkt.ldlt.panel_launches": 320}, 100.0),
    ({"kkt.ldlt.calls": 2, "kkt.ldlt.columns": 400, "kkt.ldlt.kernel_columns": 100,
      "kkt.ldlt.panel_launches": 1}, 25.0),
    ({"kkt.ldlt.calls": 40, "kkt.ldlt.columns": 40840}, 0.0),
    ({"loop.passes": 39, "schur.calls": 39}, None),
    (None, None),
], ids=["kernel", "some", "plain_columns", "no_ldlt", "no_counters"])
def test_ldlt_kernel_pct_reads_kernel_columns_over_columns(monkeypatch, counted, want):
    ph = phases.Phases(rows={}, window_s=1.0, busy_s=0.0, passes=0, counters=counted)
    monkeypatch.setattr(phases, "measure", lambda ctx: ph)
    assert spec.load_metric("ldlt_kernel_pct").read(None) == want


def test_a_cpu_call_of_the_portfolio_cell_counts_plain_columns_only():
    """On the CPU the column steps run as the plain loop: the call counts
    every column of its factors of order n + 2k + 1 = 103 and no kernel
    column, so the metric would read 0."""
    bench = spec.load_benchmark()
    cell = spec.workload(bench, "osqp_portfolio_k10.qp_b64")
    config = dict(spec.load_config(cell["config"]), k=1, n=100)
    traffic = dict(spec.load_traffic(cell["traffic"]), batch=2)
    c = phases.run(config, traffic, "cpu", torch.float64).counters
    assert c["kkt.ldlt.calls"] > 0 and c["kkt.ldlt.columns"] == 103 * c["kkt.ldlt.calls"]
    assert "kkt.ldlt.kernel_columns" not in c and "kkt.ldlt.panel_launches" not in c


def test_the_metric_is_declared_for_the_portfolio_cell_alone():
    entry = {e["name"]: e for e in spec.load_benchmark()["per_layer"]}["ldlt_kernel_pct"]
    assert entry["workloads"] == ["osqp_portfolio_k10.qp_b64"]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "%", "higher", "program_counter", "solved_per_s")

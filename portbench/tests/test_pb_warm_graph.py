import pytest
import torch

from portbench import phases, spec


@pytest.mark.parametrize("counted,want", [
    ({"sym.warm.calls": 196, "sym.warm.replays": 196}, 100.0),
    ({"sym.warm.calls": 4, "sym.warm.captures": 1, "sym.warm.replays": 3}, 75.0),
    ({"sym.warm.calls": 8}, 0.0),
    ({"loop.passes": 98}, None),
    (None, None),
], ids=["all", "some", "none", "a_port_without_graphs", "no_counters"])
def test_warm_graph_pct_reads_replays_over_calls(monkeypatch, counted, want):
    ph = phases.Phases(rows={}, window_s=1.0, busy_s=0.0, passes=0, counters=counted)
    monkeypatch.setattr(phases, "measure", lambda ctx: ph)
    assert spec.load_metric("warm_graph_pct").read(None) == want


def test_a_cpu_call_counts_no_warm_estimate():
    """The warm estimates of a CPU call run eagerly and count nothing, so the
    metric reads nothing there."""
    cell = spec.workload(spec.load_benchmark(), "sdp_n100_m100.b256")
    config = spec.load_config(cell["config"])
    config.update(n=6, m=4)
    config["solver"]["max_iterations"] = 20
    traffic = dict(spec.load_traffic(cell["traffic"]), batch=3)
    c = phases.run(config, traffic, "cpu", torch.float64).counters
    assert c["loop.passes"] > 0
    assert not any(k.startswith("sym.warm.") for k in c)

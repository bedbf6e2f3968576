"""The readers soc_schur_ms and soc_idle_pct on a synthetic trace: two
passes, each with an SOCCone's Schur block inside conex.schur and its
step inside conex.prepare_step; and on traces without their spans."""

import pytest

from portbench import phases, spec
from portbench.trace import MARK

NAMES = ("soc_schur_ms", "soc_idle_pct")

# 200 us: conex.call/1 around conex.solve around two passes of 90 us
# starting at base = 1005 and 1095; in each, conex.schur holds
# conex.soc.schur and conex.prepare_step holds conex.soc.step, and three
# kernels run: the Schur block's (base + 8 to + 28), the step's (+ 48 to
# + 52) and the pass's own (+ 68 to + 78).
HOST = [(MARK, 1000.0, 200.0), ("conex.call/1", 1001.0, 195.0),
        ("conex.solve", 1002.0, 190.0)]
LAUNCHES, DEVICE = [], []
for p, base in ((0, 1005.0), (1, 1095.0)):
    HOST += [("conex.pass", base, 90.0),
             ("conex.schur", base + 1.0, 30.0), ("conex.soc.schur", base + 2.0, 28.0),
             ("conex.prepare_step", base + 40.0, 20.0), ("conex.soc.step", base + 41.0, 18.0)]
    c = 10 * p
    LAUNCHES += [(base + 3.0, c + 1), (base + 42.0, c + 2), (base + 65.0, c + 3)]
    DEVICE += [("kernel", base + 8.0, 20.0, c + 1), ("kernel", base + 48.0, 4.0, c + 2),
               ("kernel", base + 68.0, 10.0, c + 3)]


def _events(keep=lambda name: True):
    events = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
               "pid": 1, "tid": 1} for name, ts, dur in HOST if keep(name)]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 0.5, "pid": 1, "tid": 1, "args": {"correlation": c}}
               for ts, c in LAUNCHES]
    events += [{"ph": "X", "cat": cat, "name": f"op{c}", "ts": ts, "dur": dur, "pid": 0,
                "tid": 7, "args": {"correlation": c}} for cat, ts, dur, c in DEVICE]
    return events


def _read(monkeypatch, ph):
    monkeypatch.setattr(phases, "measure", lambda ctx: ph)
    return {name: spec.load_metric(name).read(None) for name in NAMES}


def test_both_readers_read_the_soc_spans_of_a_synthetic_trace(monkeypatch):
    ph = phases.analyze(_events())
    assert ph.passes == 2
    got = _read(monkeypatch, ph)
    # 20 us of the Schur block's kernel a pass.
    assert got["soc_schur_ms"] == pytest.approx(0.020, rel=1e-9)
    # Idle before the Schur kernels, 13 us from the window's start and 20
    # from the first pass's last kernel, and before the step's, 20 a pass:
    # 73 us of the window's 200.
    rows = ph.rows
    assert rows["conex.soc.schur"].idle_s == pytest.approx(33e-6)
    assert rows["conex.soc.step"].idle_s == pytest.approx(40e-6)
    assert rows["conex.pass"].idle_s == pytest.approx(32e-6)
    assert got["soc_idle_pct"] == pytest.approx(36.5, rel=1e-9)


def test_the_readers_read_nothing_from_a_trace_without_the_soc_spans(monkeypatch):
    """The parent's port: the same trace with no conex.soc.* span (their
    time and idle fall to conex.schur and conex.prepare_step)."""
    ph = phases.analyze(_events(lambda name: not name.startswith("conex.soc.")))
    assert ph.rows["conex.schur"].busy_s == pytest.approx(40e-6)
    assert _read(monkeypatch, ph) == dict.fromkeys(NAMES)


@pytest.mark.parametrize("rows,passes,want", [
    ({"conex.soc.schur": phases.Row(count=160, busy_s=1.28)}, 159, 1.28e3 / 159),
    ({"conex.soc.schur": phases.Row(count=1, busy_s=0.001)}, 0, None),
    ({}, 0, None),
], ids=["cell_scale", "no_passes", "nothing"])
def test_soc_schur_ms_is_the_span_busy_time_over_the_passes(monkeypatch, rows, passes, want):
    ph = phases.Phases(window_s=1.0, busy_s=0.5, rows=rows, passes=passes)
    got = _read(monkeypatch, ph)["soc_schur_ms"]
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


def test_the_metrics_are_declared_for_the_socp_cell_alone():
    entries = {e["name"]: e for e in spec.load_benchmark()["per_layer"]}
    for name, unit in (("soc_schur_ms", "ms"), ("soc_idle_pct", "%")):
        e = entries[name]
        assert e["workloads"] == ["portfolio_te_k10.socp_b64"]
        assert (e["unit"], e["better"], e["source"], e["moves"], e["layer"]) == (
            unit, "lower", "device_trace", "solved_per_s", "cone (cones/soc.py, algebra/spin.py)")

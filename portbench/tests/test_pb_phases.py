import pytest
import torch

from portbench import phases, spec
from portbench.trace import MARK

# A window of 100 us on the host: conex.call/7 around conex.solve, which
# holds one conex.pass with a conex.prepare_step inside; a launch outside
# every span; five device operations.
HOST = [
    (MARK, 1000.0, 100.0),
    ("conex.call/7", 1001.0, 90.0),
    ("conex.solve", 1005.0, 70.0),
    ("conex.pass", 1010.0, 50.0),
    ("conex.prepare_step", 1020.0, 20.0),
]
LAUNCHES = [  # (ts, correlation)
    (1002.0, 1),  # in conex.call only
    (1012.0, 2),  # in conex.pass, before the cone step
    (1025.0, 3),  # in conex.prepare_step
    (1045.0, 4),  # in conex.pass again, after it
    (1095.0, 5),  # after conex.call: no span
]
DEVICE = [  # (cat, ts, dur, correlation)
    ("kernel", 1003.0, 7.0, 1),     # idle 1000-1003 -> conex.call
    ("kernel", 1015.0, 5.0, 2),     # idle 1010-1015 -> conex.pass
    ("gpu_memcpy", 1030.0, 10.0, 3),  # idle 1020-1030 -> conex.prepare_step
    ("kernel", 1035.0, 20.0, 4),    # overlaps the copy: no idle
    ("kernel", 1096.0, 2.0, 5),     # idle 1055-1096 -> no span; tail 1098-1100
]


def _events():
    events = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
               "pid": 1, "tid": 1} for name, ts, dur in HOST]
    events += [{"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": ts - 0.5, "dur": 2.0,
                "pid": 1, "tid": 1} for ts, _ in LAUNCHES]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 0.5, "pid": 1, "tid": 1, "args": {"correlation": c}}
               for ts, c in LAUNCHES]
    events += [{"ph": "X", "cat": cat, "name": f"op{c}", "ts": ts, "dur": dur, "pid": 0,
                "tid": 7, "args": {"correlation": c}} for cat, ts, dur, c in DEVICE]
    events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "conex.pass",
                   "ts": 1011.0, "dur": 60.0, "pid": 0, "tid": 7})
    return events


def test_each_gap_goes_to_the_innermost_span_of_its_launch():
    ph = phases.analyze(_events())
    idle = {name: row.idle_s for name, row in ph.rows.items()}
    assert idle["conex.call"] == pytest.approx(3e-6)
    assert idle["conex.pass"] == pytest.approx(5e-6)
    assert idle["conex.prepare_step"] == pytest.approx(10e-6)
    assert idle["conex.solve"] == 0.0
    assert idle[phases.NO_SPAN] == pytest.approx(41e-6)
    assert idle[phases.END] == pytest.approx(2e-6)
    assert ph.rows["conex.pass"].launches == 2 and ph.rows["conex.prepare_step"].launches == 0
    assert ph.rows["conex.prepare_step"].busy_s == pytest.approx(10e-6)
    assert ph.passes == 1


def test_self_time_leaves_out_the_child_spans():
    rows = phases.analyze(_events()).rows
    assert rows["conex.call"].self_s == pytest.approx(20e-6)
    assert rows["conex.solve"].self_s == pytest.approx(20e-6)
    assert rows["conex.pass"].self_s == pytest.approx(30e-6)
    assert rows["conex.prepare_step"].self_s == pytest.approx(20e-6)
    assert all(row.count == 1 for name, row in rows.items() if name.startswith("conex."))


def test_the_idle_of_every_row_is_the_window_less_the_busy_time():
    ph = phases.analyze(_events())
    assert ph.window_s == pytest.approx(100e-6)
    assert ph.busy_s == pytest.approx(39e-6)
    assert sum(row.idle_s for row in ph.rows.values()) == pytest.approx(ph.window_s - ph.busy_s)
    assert ph.idle_pct(["conex.prepare_step", "conex.take_step"]) == pytest.approx(10.0)


def test_a_trace_without_the_solve_span_reads_nothing():
    events = [e for e in _events() if e["name"] != "conex.solve"]
    assert phases.analyze(events).idle_pct(["conex.pass"]) is None


def test_one_call_of_a_small_cell_on_the_cpu():
    """The readers' call at small shapes: the port's spans and counters are
    there, and the table is written (no device: all idle at the end)."""
    cell = spec.workload(spec.load_benchmark(), "sdp_n100_m100.b256")
    config = spec.load_config(cell["config"])
    config.update(n=6, m=4)
    config["solver"]["max_iterations"] = 20
    traffic = dict(spec.load_traffic(cell["traffic"]), batch=3)
    ph = phases.run(config, traffic, "cpu", torch.float64)
    c = ph.counters
    assert c["calls"] == 1 and c["loop.scenario_passes"] == 3 * c["loop.passes"]
    assert ph.passes == c["loop.passes"] == c["sync.loop.done"]
    assert 0 < c["loop.live_scenario_passes"] <= c["loop.scenario_passes"]
    assert {"conex.call", "conex.solve", "conex.pass", "conex.prepare_step",
            "conex.take_step", "conex.factor", "conex.mu"} <= set(ph.rows)
    lines = phases.table(ph)
    assert any("conex.pass" in line for line in lines) and "counters" in lines[-1]

import pytest

from portbench.trace import MARK, summarize


def _trace():
    # A window of 100 us on the host; three kernels and a copy on the
    # device, launched from two host operators.
    host = [
        {"ph": "X", "cat": "user_annotation", "name": MARK, "ts": 1000.0, "dur": 100.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1001.0, "dur": 30.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1040.0, "dur": 10.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "ts": 1060.0, "dur": 20.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 1062.0, "dur": 5.0, "pid": 1, "tid": 1},
    ]
    launches = [(1002.0, 1), (1020.0, 2), (1041.0, 3), (1063.0, 4)]
    host += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
              "dur": 1.0, "pid": 1, "tid": 1, "args": {"correlation": c}} for ts, c in launches]
    device = [
        ("kernel", "gemm", 990.0, 20.0, 1),      # starts before the window: 10 us inside
        ("kernel", "gemm", 1025.0, 5.0, 2),      # idle 1010-1025, launched in aten::mm
        ("gpu_memcpy", "Memcpy DtoD", 1045.0, 10.0, 3),  # idle 1030-1045 (aten::copy_)
        ("kernel", "mul_kernel", 1050.0, 20.0, 4),  # overlaps the copy; idle none
    ]
    dev = [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": c}} for cat, name, ts, dur, c in device]
    gpu_mark = {"ph": "X", "cat": "gpu_user_annotation", "name": MARK, "ts": 990.0, "dur": 200.0}
    return host + dev + [gpu_mark]


def test_idle_is_the_window_less_the_union_of_device_intervals():
    t = summarize(_trace())
    assert t.window_s == pytest.approx(100e-6)
    # busy: 1000-1010, 1025-1030, 1045-1070
    assert t.busy_s == pytest.approx(40e-6)
    assert t.kernels == 3
    idle = dict(t.idle_gaps)
    assert idle["aten::mm"] == pytest.approx(15e-6)
    assert idle["aten::copy_"] == pytest.approx(15e-6)
    assert idle["end of call"] == pytest.approx(30e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.device_ops[0] == ["mul_kernel", pytest.approx(20e-6)]
    assert dict(t.device_ops)["gemm"] == pytest.approx(15e-6)


def test_the_launching_operator_is_the_innermost_open_one():
    events = _trace()
    events.append({"ph": "X", "cat": "kernel", "name": "mul2", "ts": 1080.0, "dur": 5.0,
                   "pid": 0, "tid": 7, "args": {"correlation": 5}})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1064.0,
                   "dur": 1.0, "pid": 1, "tid": 1, "args": {"correlation": 5}})
    idle = dict(summarize(events).idle_gaps)
    assert idle["aten::mul"] == pytest.approx(10e-6)  # 1070-1080, inside aten::addmm


def test_a_trace_needs_exactly_one_window():
    events = [e for e in _trace() if not (e["name"] == MARK and e["cat"] == "user_annotation")]
    with pytest.raises(ValueError):
        summarize(events)

"""One whole call under torch.profiler, reduced to what the device did.

The call runs inside a ``portbench.call`` annotation, whose interval on
the host is the traced window.  From the trace's raw events (its Chrome
export, not ``key_averages()``):

- busy: the union of the device's kernel, copy and set intervals inside
  the window; idle is the rest of the window;
- kernels: the kernel events inside the window;
- device_ops: the ten device operations that took most time, by name;
- idle_gaps: the idle time between device operations, summed by what the
  host was doing: the innermost operator on the host that launched the
  operation after the gap (the window's tail is "end of call").
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass

MARK = "portbench.call"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list
    idle_gaps: list


def _top(totals: dict) -> list:
    return [[name, seconds] for name, seconds in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def _launchers(events, wanted: set) -> dict:
    """correlation id -> name of the innermost host operator that was open
    when the runtime call of that id was made."""
    calls = defaultdict(list)  # tid -> [(ts, correlation)]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in HOST_API and corr in wanted:
            calls[(e.get("pid"), e.get("tid"))].append((e["ts"], corr))
    ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and "dur" in e:
            ops[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], -e["dur"], e["ts"] + e["dur"], e["name"]))
    out = {}
    for thread, queries in calls.items():
        queries.sort()
        opened = sorted(ops.get(thread, ()))
        stack, k = [], 0
        for ts, corr in queries:
            while k < len(opened) and opened[k][0] <= ts:
                while stack and stack[-1][2] <= opened[k][0]:
                    stack.pop()
                stack.append(opened[k])
                k += 1
            while stack and stack[-1][2] < ts:
                stack.pop()
            out[corr] = stack[-1][3] if stack else "host (no operator)"
    return out


def summarize(events) -> Trace:
    """Reduce a Chrome-trace event list that holds one MARK interval."""
    marks = [e for e in events if e.get("name") == MARK and "dur" in e
             and not str(e.get("cat", "")).startswith("gpu")]
    if len(marks) != 1:
        raise ValueError(f"the trace holds {len(marks)} {MARK} intervals, not 1")
    start, end = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    device = []
    for e in events:
        if e.get("cat") in DEVICE and "dur" in e:
            lo, hi = max(e["ts"], start), min(e["ts"] + e["dur"], end)
            if hi > lo:
                device.append((lo, hi, e["name"], e.get("cat"),
                               e.get("args", {}).get("correlation")))
    device.sort()
    per_op = defaultdict(float)
    busy, gaps, reach = 0.0, [], start
    for lo, hi, name, _, corr in device:
        per_op[name] += (hi - lo) * 1e-6
        if lo > reach:
            gaps.append((lo - reach, corr))
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    labels = _launchers(events, {corr for _, corr in gaps})
    idle = defaultdict(float)
    for length, corr in gaps:
        idle[labels.get(corr, "host (no launch found)")] += length * 1e-6
    if end > reach:
        idle["end of call"] += (end - reach) * 1e-6
    return Trace(window_s=(end - start) * 1e-6, busy_s=busy * 1e-6,
                 kernels=sum(1 for d in device if d[3] == "kernel"),
                 device_ops=_top(per_op), idle_gaps=_top(idle))


def profile(fn):
    """(fn's result, Trace) of one call of ``fn``, which ends with a
    synchronize.  A small kernel runs first, outside the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        with torch.profiler.record_function(MARK):
            out = fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, summarize(events)

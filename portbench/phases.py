"""One call of the cell, traced with the port's spans and counted with its
counters: where the call's host time and the device's idle time go, by
phase of the solve.

The port opens a profiler span at each layer boundary (``conex.call/<n>``,
``conex.solve``, ``conex.pass``, ``conex.assemble``, ...: conex_tpu_torch/
utils/profiling.py) and keeps ``counters`` (passes, live scenarios, host
syncs).  ``measure(ctx)`` makes the cell's driver again, its ``scenarios``
pool cut to one batch, and runs its call 0 (batch 0, or request 0 of a
``program`` pool) once under torch.profiler inside ``trace.MARK``, the
device synchronized at its end; it keeps the counters' difference over the
call and reduces the trace:

- the window and busy time: ``trace.summarize``;
- per span name (``conex.call/<n>`` summed as ``conex.call``): the spans'
  count, their host self time (the span's length less its direct child
  spans'), the device time of the operations launched inside it (the
  innermost ``conex.`` span open at the launching runtime call), its kernel
  launches, and the idle time it is charged: each idle gap goes to the
  launcher of the operation that ends it, by the rule ``trace.py`` applies
  to ATen operators; a launch outside every span is charged to "no span",
  the window's tail to "end of call".  The idle of the rows adds up to the
  window less the busy time.

Done once per process and cell, shared by every reader.  A port without
the spans or counters leaves them empty, and the readers return None.
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

from . import drivers
from . import trace as tracing
from .workload import dtype_of

PREFIX = "conex."
CALL = "conex.call"
NO_SPAN = "no span"
END = "end of call"
NO_LAUNCH = "host (no operator)"  # trace._launchers' label for "outside"
LOOP_PASS = "conex.pass"


@dataclass
class Row:
    count: int = 0
    self_s: float = 0.0
    busy_s: float = 0.0
    idle_s: float = 0.0
    launches: int = 0


@dataclass
class Phases:
    window_s: float
    busy_s: float
    rows: dict  # span name (or NO_SPAN, END) -> Row
    counters: Optional[dict] = None  # the call's counter differences
    passes: int = 0  # conex.pass spans

    def idle_pct(self, names) -> Optional[float]:
        """The idle time charged to ``names`` as a share of the window, or
        None where the trace holds no span of the solve."""
        if "conex.solve" not in self.rows or self.window_s <= 0:
            return None
        return 100.0 * sum(self.rows[n].idle_s for n in names if n in self.rows) / self.window_s


def span_name(name: str) -> str:
    """A span's row: ``conex.call/<n>`` is ``conex.call``."""
    return CALL if name.startswith(CALL + "/") else name


def _spans(events, start, end):
    """The host's ``conex.`` spans inside the window."""
    return [e for e in events
            if str(e.get("name", "")).startswith(PREFIX) and "dur" in e
            and not str(e.get("cat", "")).startswith("gpu")
            and e["ts"] >= start and e["ts"] + e["dur"] <= end]


def _self_times(spans) -> list:
    """Each span's length less its direct child spans' (same thread)."""
    child = [0.0] * len(spans)
    by_thread = defaultdict(list)
    for i, e in enumerate(spans):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i]["ts"], -spans[i]["dur"]))
        stack = []
        for i in idx:
            ts = spans[i]["ts"]
            while stack and spans[stack[-1]]["ts"] + spans[stack[-1]]["dur"] <= ts:
                stack.pop()
            if stack:
                child[stack[-1]] += spans[i]["dur"]
            stack.append(i)
    return [e["dur"] - c for e, c in zip(spans, child)]


def analyze(events) -> Phases:
    """Reduce a Chrome-trace event list that holds one MARK interval."""
    t = tracing.summarize(events)
    mark = next(e for e in events if e.get("name") == tracing.MARK and "dur" in e
                and not str(e.get("cat", "")).startswith("gpu"))
    start, end = mark["ts"], mark["ts"] + mark["dur"]
    spans = _spans(events, start, end)
    rows = defaultdict(Row)
    for e, own in zip(spans, _self_times(spans)):
        row = rows[span_name(e["name"])]
        row.count += 1
        row.self_s += own * 1e-6

    device = []
    for e in events:
        if e.get("cat") in tracing.DEVICE and "dur" in e:
            lo, hi = max(e["ts"], start), min(e["ts"] + e["dur"], end)
            if hi > lo:
                device.append((lo, hi, e.get("cat"), e.get("args", {}).get("correlation")))
    device.sort(key=lambda d: (d[0], d[1]))
    # The innermost span open at each launch: trace.py's rule, with the
    # spans standing where it reads ATen operators.
    launch_events = [e for e in events if e.get("cat") in tracing.HOST_API]
    labels = tracing._launchers(
        launch_events + [dict(e, cat="cpu_op") for e in spans],
        {d[3] for d in device})

    def label(corr):
        name = labels.get(corr, NO_LAUNCH)
        return NO_SPAN if name == NO_LAUNCH else span_name(name)

    reach = start
    for lo, hi, cat, corr in device:
        row = rows[label(corr)]
        row.busy_s += (hi - lo) * 1e-6
        row.launches += cat == "kernel"
        if lo > reach:
            row.idle_s += (lo - reach) * 1e-6
        reach = max(reach, hi)
    if end > reach:
        rows[END].idle_s += (end - reach) * 1e-6
    return Phases(window_s=t.window_s, busy_s=t.busy_s, rows=dict(rows),
                  passes=rows[LOOP_PASS].count if LOOP_PASS in rows else 0)


def table(ph: Phases) -> list:
    """The per-span lines that ``measure`` writes with ``ctx.note``."""
    per = max(ph.passes, 1)
    lines = [f"phases: window {ph.window_s * 1e3:.3f} ms, busy {ph.busy_s * 1e3:.3f} ms, "
             f"{ph.passes} passes; per span: count, host self ms, device busy ms, idle ms, "
             "launches; then per pass"]
    for name, r in sorted(ph.rows.items(), key=lambda kv: -kv[1].idle_s):
        lines.append(
            f"phases: {name:24s} {r.count:6d} {r.self_s * 1e3:10.3f} {r.busy_s * 1e3:10.3f} "
            f"{r.idle_s * 1e3:10.3f} {r.launches:7d} | {r.count / per:7.2f} "
            f"{r.self_s * 1e3 / per:8.4f} {r.busy_s * 1e3 / per:8.4f} "
            f"{r.idle_s * 1e3 / per:8.4f} {r.launches / per:8.2f}")
    if ph.counters is not None:
        lines.append("phases: counters " + json.dumps(ph.counters, sort_keys=True))
    return lines


def _profile(fn, device):
    """(fn's result, the trace's events) of one call of ``fn`` inside
    MARK, ended by a synchronize; a small operation first, outside it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        torch.ones(1, device=device).add_(1.0)
        drivers.sync(device)
        with torch.profiler.record_function(tracing.MARK):
            out = fn()
            drivers.sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, events


def _counters():
    try:
        from conex_tpu_torch.utils.profiling import counters
    except ImportError:  # a port that keeps none
        return None
    return counters


def run(config, traffic, device, dtype) -> Phases:
    """Call 0 of the cell's driver, its ``scenarios`` pool cut to one
    batch, traced and counted."""
    import torch

    traffic = dict(traffic)
    if traffic["driver"] == "scenarios":
        traffic["pool"] = 1
    device = torch.device(device)
    driver = drivers.make(config, traffic, device, dtype)
    counters = _counters()
    before = dict(counters) if counters is not None else None
    out, events = _profile(lambda: driver.call(0), device)
    ph = analyze(events)
    if counters is not None:
        diff = {k: v - before.get(k, 0) for k, v in counters.items()}
        ph.counters = {k: v for k, v in diff.items() if v}
    del out, driver, events
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ph


_DONE = {}


def measure(ctx) -> Phases:
    """The cell's Phases, made at the first reader's call in the process."""
    name = ctx.cell["name"]
    if name not in _DONE:
        ph = run(ctx.config, ctx.traffic, ctx.device, dtype_of(ctx.dtype))
        for line in table(ph):
            ctx.note(line)
        _DONE[name] = ph
    return _DONE[name]

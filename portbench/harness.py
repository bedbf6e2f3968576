"""One run of one cell: set-up, the measured window, the readers, the check."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from . import check, drivers, spec
from . import trace as tracing
from .workload import dtype_of, solver_config


@dataclass
class Context:
    """What a metric's reader may read."""

    cell: dict
    config: dict
    traffic: dict
    device: torch.device
    dtype: str  # the solve's type: "float64" or "float32"
    kind: str  # the card's name
    setup_s: float
    window_s: float
    programs: drivers.Programs  # every program the window solved
    tolerance: float  # the relative gap a solved program keeps to
    solver: object  # the SolverConfig of the solves
    problem: object  # the configuration's class, problems/<class>.py
    final: drivers.Final  # the port's state at the end of the window
    trace: Optional[tracing.Trace] = None  # one more call, traced
    traced_iterations: int = 0  # the Newton iterations of that call

    def note(self, text: str) -> None:
        print(f"[{self.cell['name']}] {text}", file=sys.stderr, flush=True)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, *, dtype: Optional[str] = None,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None, problems: Path = spec.PROBLEMS):
    """Run ``cell`` once: its result line as a dict, and every number the
    check computed (with the readings it does not compare).

    ``t_start`` is when the process started its set-up.  ``dtype``,
    ``config``, ``traffic`` and ``limits`` replace what the cell's files
    say (the control, and the tests' small shapes); the configuration's
    class is found in ``problems``."""
    config = config or spec.load_config(cell["config"])
    traffic = traffic or spec.load_traffic(cell["traffic"])
    limits = spec.load_limits(cell["name"]) if limits is None else limits
    problem = spec.problem_of(config, problems)
    dtype = dtype or config["dtype"]
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        from conex_tpu_torch import _build

        _build.build()  # the kernel library; only a checkout's first run compiles
        torch.cuda.reset_peak_memory_stats(device)

    driver = drivers.make(config, traffic, device, dtype_of(dtype), cell["chips"], problem)
    driver.call(0)  # every shape the window uses
    setup_s = time.perf_counter() - t_start

    # The window lasts at least ``seconds`` and ends on a whole cycle of the
    # mix's pool, so that every run solves the same programs as often.
    recs, ends = [], []
    t0 = time.perf_counter()
    while True:
        recs.append(driver.call(len(recs)))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds and len(recs) % driver.cycle == 0:
            break
    window_s = ends[-1]
    walls = sorted(b - a for a, b in zip([0.0] + ends, ends))
    print(f"[{cell['name']}] {len(walls)} calls in {window_s!r} s: shortest "
          f"{walls[0]!r}, median {walls[len(walls) // 2]!r}, longest {walls[-1]!r} s",
          file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    programs = driver.account(recs)
    final = driver.final(recs[-1])
    answers = driver.answers(recs)
    sample = problem.sample(seed, final, traffic["check"])
    ctx = Context(cell=cell, config=config, traffic=traffic, device=device,
                  dtype=dtype, kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                  setup_s=setup_s, window_s=window_s, programs=programs,
                  tolerance=config["accuracy"]["relative_gap"],
                  solver=solver_config(config), problem=problem, final=final)
    if trace:
        out, ctx.trace = tracing.profile(lambda: driver.call(len(recs)))
        ctx.traced_iterations = driver.iterations(out)
        del out
    metrics = {}
    for entry in spec.metrics_of(bench, cell["name"], trace):
        value = spec.load_metric(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}

    # The reference runs once the port's state is freed.
    chunk_size = driver.chunk_size
    ctx.final = None
    del driver, recs, final
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.judge(problem, config, traffic, chunk_size, answers, sample, device)
    solved = int(programs.solved(config["accuracy"]["relative_gap"]).sum())
    result = {
        "correct": check.verdict(numbers, limits),
        "attempted": programs.iterations.size,
        "failed": programs.iterations.size - solved,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": ctx.kind, "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = {k: {"value": numbers[k], "limit": limits.get(k)}
                        for k in problem.NUMBERS}
    return result, numbers

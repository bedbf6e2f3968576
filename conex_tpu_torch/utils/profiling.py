"""Spans and counters of a solve, per-phase timing and trace capture.

The port's own instruments:

- ``span(name)``: a profiler span (``torch.profiler.record_function``)
  while a ``torch.profiler`` runs, and a shared null context otherwise, so
  that a span costs one flag check when nobody traces (about 0.6 us on a
  CPU core, against about 13 us for ``record_function`` itself).  Spans land
  in the same trace as the card's kernels, on its clock; each launch is
  tied to the innermost span open on the launching thread.
- ``entry()`` (a context manager or decorator): the span of a call into
  the port, ``conex.call/<n>`` with n the ``calls`` counter; only the
  outermost entry of a call opens one, and every span of the call nests
  inside it.
- ``counters``: one ``collections.Counter`` that always counts: ``calls``;
  ``loop.passes``, ``loop.scenario_passes`` (S per pass) and
  ``loop.live_scenario_passes`` (the scenarios not done at the start of a
  pass); one ``sync.<site>`` per host read of device data (or host copy to
  it that waits for the card); ``schur.calls`` and ``socp.calls``, the
  calls of the kernels K1 and K2; ``sym.warm.calls``,
  ``sym.warm.captures`` and ``sym.warm.replays``, the warm eigenvalue
  estimates on the card and the CUDA graphs captured and replayed for
  them (algebra/sym.py); ``kkt.ldlt.calls`` and ``kkt.ldlt.columns``, the
  clamped LDLT factors and the columns their scalar steps take on either
  device, ``kkt.ldlt.kernel_columns`` and ``kkt.ldlt.panel_launches``,
  the columns csrc/ldlt.cu's kernel took on the card and its launches
  (solver/kkt.py); ``lp.rows`` and ``lp.bound_rows``, a LinearCone's rows
  at each split of its bound rows and those that took the bound path
  (cones/lp.py, with its host read ``sync.cone.lp_split``); ``soc.cones``,
  the Lorentz cones of each solve's SOCCone blocks, per scenario
  (solver/loop.py), and ``soc.schur.calls``, the calls of SOCCone.schur
  (cones/soc.py).

The spans, by layer: ``conex.call/<n>``, ``conex.program.add``,
``conex.program.copy_out``, ``conex.program.dual`` (front end);
``conex.solve``, ``conex.pass``, ``conex.mu``, ``conex.select``,
``conex.epilogue`` (solve loop); ``conex.assemble``, ``conex.schur``,
``conex.factor``, ``conex.ldlt`` (the clamped LDLT, inside
``conex.factor``), ``conex.ldlt.update`` (a panel's solve and trailing
update, inside ``conex.ldlt``), ``conex.kkt_solve`` (KKT);
``conex.prepare_step``, ``conex.take_step``, ``conex.slack_stats``,
``conex.line_search``, ``conex.lp.split`` (a LinearCone's bound rows held
apart, once per solve, inside ``conex.solve``), ``conex.soc.schur`` (an
SOCCone's Schur block, inside ``conex.schur``) and ``conex.soc.step`` (its
prepare_step, take_step, slack_stats and affine_step, inside the phase that
calls them) (cone).

Twin of ``conex_tpu/utils/profiling.py`` besides: the counterpart of the
reference's compile-time macro timers (CONEX_ENABLE_TIMER,
debug_macros.h:18-47, at cone_program.cc:338/359/412/421 for
Assemble/Factor/Solve/Update).  ``phase_timings`` runs each phase of one
Newton iteration on its own, each timed call ended by a synchronize of the
card (where the program's tensors live on one), and ``trace`` wraps the
torch profiler, which stands where the JAX package has ``jax.profiler``:
a trace it writes holds the spans above.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

counters: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()
_local = threading.local()


def span(name: str):
    """A context manager: the profiler span ``name`` while a profiler
    runs, else a shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the function's body runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def entry():
    """The outermost entry of a call into the port counts the call in
    ``calls`` and runs inside the span ``conex.call/<n>``; an entry inside
    another adds nothing."""
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    try:
        if depth:
            yield
        else:
            counters["calls"] += 1
            with span(f"conex.call/{counters['calls']}"):
                yield
    finally:
        _local.depth = depth


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch profiler trace of the block into ``log_dir``: one
    Chrome-trace JSON file (``*.pt.trace.json``) written by
    ``torch.profiler.tensorboard_trace_handler``; TensorBoard is not needed
    to write it.  The card's activity is traced where there is a card, and
    the port's spans with it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        yield


def _time(fn, device, reps: int = 10) -> float:
    """Seconds per call of ``fn``, after one warm call; the calls end with
    a synchronize of the card when ``device`` is one."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def phase_timings(prog, config=None, reps: int = 10) -> Dict[str, float]:
    """Wall time (seconds) of the Assemble / Factor / Solve / Update phases
    of one Newton iteration of ``prog`` (a ``Program``) at the identity
    iterate, on the Program's device.

    The phases match the reference's timer call sites
    (cone_program.cc:338-421).
    """
    from ..config import SolverConfig
    from ..solver import kkt
    from ..solver.loop import _no_tf32, _prepare_step_all, _take_step_all, assemble

    if config is None:
        config = SolverConfig()
    blocks = tuple(prog._blocks)
    eq_blocks = tuple(prog._eq_blocks)
    structure = prog._kkt_structure()
    dtype, device = prog.dtype, prog.device
    n_kkt = prog.num_vars + prog._dual_size
    mode = config.kkt_solver
    refine = config.iterative_refinement_iterations
    ws = tuple(blk.identity_state(dtype) for blk in blocks)
    one = torch.ones((1,), dtype=dtype, device=device)

    def do_assemble():
        return assemble(blocks, eq_blocks, ws, n_kkt, prog.num_vars, dtype, structure)

    def do_factor():
        return kkt.factor(G, mode, structure)

    def do_solve():
        return kkt.solve(fac, rhs, mode, refine, structure)

    def do_update():
        caches, ninf, _ = _prepare_step_all(blocks, ws, y, one, 1.0)
        step = torch.clamp(2.0 / (ninf * ninf), max=1.0)
        return _take_step_all(blocks, ws, caches, step)

    with _no_tf32() if device.type == "cuda" else contextlib.nullcontext():
        G, AW, AQc, _, _ = do_assemble()
        fac = do_factor()
        rhs = AQc - AW
        y = do_solve()
        return {
            "assemble": _time(do_assemble, device, reps),
            "factor": _time(do_factor, device, reps),
            "solve": _time(do_solve, device, reps),
            "update": _time(do_update, device, reps),
        }

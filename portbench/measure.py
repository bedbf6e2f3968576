"""Timers for the per-layer readers."""

from __future__ import annotations

import math
import statistics
import time

import torch

from .drivers import sync

# A host-clock reading is off by about half a millisecond, so each timed
# block of repeats spans at least this long.
MIN_BLOCK_S = 0.25
BLOCKS = 5


def host_ms(fn, device) -> float:
    """Median over BLOCKS blocks of the host wall per call of ``fn``, each
    call ended by a synchronize, each block at least MIN_BLOCK_S long."""
    def run(reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            sync(device)
        return time.perf_counter() - t0

    run(1)
    reps = max(1, math.ceil(MIN_BLOCK_S / max(run(1), 1e-6)))
    return statistics.median(run(reps) / reps for _ in range(BLOCKS)) * 1e3


def cuda_ms(fn, device) -> float:
    """Median over BLOCKS blocks of the device time per call of ``fn``,
    between CUDA events around back-to-back calls, each block at least
    MIN_BLOCK_S long."""
    def run(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / reps

    run(1)
    reps = max(1, math.ceil(MIN_BLOCK_S * 1e3 / max(run(1), 1e-6)))
    return statistics.median(run(reps) for _ in range(BLOCKS))

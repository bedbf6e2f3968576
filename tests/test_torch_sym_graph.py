"""The graphed warm eigenvalue estimate of algebra/sym.py, on the CPU.

On a CUDA card ``extreme_eigenvalues_warm`` replays one captured CUDA graph
per key; on a CPU tensor it is the eager body, to the bit, and counts
nothing.  The key, the inputs a graph takes and the bounded cache are plain
Python and are held here; the replay itself is held to the eager body on
the card by chip_smoke.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from conex_tpu_torch.algebra import sym
from conex_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

WARM_COUNTERS = ("sym.warm.calls", "sym.warm.captures", "sym.warm.replays")


def _warm_inputs(shape, n, dtype, seed=0):
    """WS = W S (a real spectrum), cold seeds and estimates of a nearby
    matrix, as the solve loop hands them to the warm estimator."""
    rng = np.random.default_rng(seed)

    def ws():
        X = rng.uniform(-1, 1, shape + (n, n))
        W = X @ np.swapaxes(X, -1, -2) / n + 0.2 * np.eye(n)
        S = rng.uniform(-1, 1, shape + (n, n))
        return torch.as_tensor(W @ (0.5 * (S + np.swapaxes(S, -1, -2))), dtype=dtype)

    M0 = ws()
    _, _, seeds, lam = sym.extreme_eigenvalues_seeded(M0)
    return (M0 + 0.05 * ws(), *seeds, lam)


@contextlib.contextmanager
def _flags(**changes):
    """Set the global matmul settings, and put them back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        if "precision" in changes:
            torch.set_float32_matmul_precision(changes["precision"])
        if "matmul_tf32" in changes:
            torch.backends.cuda.matmul.allow_tf32 = changes["matmul_tf32"]
        if "cudnn_tf32" in changes:
            torch.backends.cudnn.allow_tf32 = changes["cudnn_tf32"]
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]


def _aligned(shape, dtype):
    """A tensor whose data starts on the boundary the graphs ask for."""
    numel = int(np.prod(shape))
    item = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(numel + sym._ALIGNMENT // item, dtype=dtype)
    off = (-buf.data_ptr() % sym._ALIGNMENT) // item
    return buf[off:off + numel].view(shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,n,steps", [((3, 2), 6, 16), ((1, 1), 8, 16), ((2, 1), 17, 24)])
def test_warm_on_cpu_is_the_eager_body_to_the_bit(dtype, shape, n, steps):
    inputs = _warm_inputs(shape, n, dtype)
    before = {k: counters[k] for k in WARM_COUNTERS}
    cached = len(sym._graphs)
    lo, hi, seeds, lam = sym.extreme_eigenvalues_warm(*inputs, num_steps=steps)
    elo, ehi, eseeds, elam = sym._warm_eager(*inputs, steps)
    for got, want in zip((lo, hi, *seeds, lam), (elo, ehi, *eseeds, elam)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert {k: counters[k] for k in WARM_COUNTERS} == before
    assert len(sym._graphs) == cached


def test_graph_key_is_equal_for_inputs_of_one_kind():
    a = _warm_inputs((2, 1), 6, torch.float64, seed=0)
    b = _warm_inputs((2, 1), 6, torch.float64, seed=1)
    assert sym._graph_key(a, 16, 7) == sym._graph_key(b, 16, 7)
    assert hash(sym._graph_key(a, 16, 7)) == hash(sym._graph_key(b, 16, 7))


@pytest.mark.parametrize("change", ["shape", "order", "dtype", "num_steps", "stream"])
def test_graph_key_differs_by_input_and_call(change):
    base = _warm_inputs((2, 1), 6, torch.float64)
    inputs, steps, stream = base, 16, 7
    if change == "shape":
        inputs = _warm_inputs((3, 1), 6, torch.float64)
    elif change == "order":
        inputs = _warm_inputs((2, 1), 7, torch.float64)
    elif change == "dtype":
        inputs = _warm_inputs((2, 1), 6, torch.float32)
    elif change == "num_steps":
        steps = 17
    else:
        stream = 8
    assert sym._graph_key(inputs, steps, stream) != sym._graph_key(base, 16, 7)


@pytest.mark.parametrize("flags", [dict(matmul_tf32=True), dict(cudnn_tf32=False),
                                   dict(precision="high"), dict(precision="medium")],
                         ids=["matmul_tf32", "cudnn_tf32", "precision_high", "precision_medium"])
def test_graph_key_differs_by_each_matmul_setting(flags):
    inputs = _warm_inputs((2, 1), 6, torch.float64)
    with _flags(matmul_tf32=False, cudnn_tf32=True, precision="highest"):
        base = sym._graph_key(inputs, 16)
        with _flags(**flags):
            changed = sym._graph_key(inputs, 16)
        assert sym._graph_key(inputs, 16) == base
    assert changed != base


def test_graph_key_reads_the_settings_a_solve_sets():
    from conex_tpu_torch.solver.loop import _no_tf32

    inputs = _warm_inputs((2, 1), 6, torch.float64)
    with _flags(matmul_tf32=True, cudnn_tf32=True):
        outside = sym._graph_key(inputs, 16)
        with _no_tf32():
            inside = sym._graph_key(inputs, 16)
    assert inside != outside


def test_graph_cache_evicts_the_oldest():
    cache = sym._GraphCache(3)
    for key in "abc":
        cache.put(key, key.upper())
    cache.put("d", "D")
    assert len(cache) == 3 and "a" not in cache and cache.get("b") == "B"
    # b was used last: c is now the oldest.
    cache.put("e", "E")
    assert "c" not in cache and [k for k in "bde" if k in cache] == list("bde")
    assert cache.get("c") is None and len(cache) == 3


def test_graph_cache_holds_its_bound():
    assert isinstance(sym.GRAPH_CAPACITY, int) and sym.GRAPH_CAPACITY >= 1
    assert sym._graphs.capacity == sym.GRAPH_CAPACITY
    cache = sym._GraphCache(sym.GRAPH_CAPACITY)
    for i in range(3 * sym.GRAPH_CAPACITY):
        cache.put(i, i)
        assert len(cache) == min(i + 1, sym.GRAPH_CAPACITY)
    assert all(i in cache for i in range(2 * sym.GRAPH_CAPACITY, 3 * sym.GRAPH_CAPACITY))


@pytest.mark.parametrize("fault", ["transposed", "offset", "grad"])
def test_inputs_a_graph_cannot_reproduce_run_eager(fault):
    n = 6
    inputs = [_aligned((2, 1, n, n), torch.float64)] + [
        _aligned((2, 1, n), torch.float64) for _ in range(4)] + [
        _aligned((2, 1, 2), torch.float64)]
    assert all(x.data_ptr() % sym._ALIGNMENT == 0 and x.is_contiguous() for x in inputs)
    if fault == "transposed":
        inputs[0] = inputs[0].transpose(-2, -1)
    elif fault == "offset":
        buf = torch.zeros(2 * n + 1, dtype=torch.float64)
        inputs[1] = buf[1:].view(2, 1, n)
    else:
        inputs[5] = inputs[5].requires_grad_()
    assert not sym._graphable(tuple(inputs))


class _FakeGraph:
    """Stands for _WarmGraph on the CPU: the eager body, counted."""

    made = 0

    def __init__(self, inputs, num_steps):
        type(self).made += 1
        self.num_steps = num_steps

    def replay(self, inputs):
        return sym._warm_eager(*inputs, self.num_steps)


def test_threads_share_the_cache_without_a_lost_capture(monkeypatch):
    """Ranks of parallel/launch.py run as threads of one process: many
    threads replaying a few keys capture each key once and count every
    replay."""
    import sys
    import threading

    monkeypatch.setattr(sym, "_WarmGraph", _FakeGraph)
    monkeypatch.setattr(sym, "_graphs", sym._GraphCache(sym.GRAPH_CAPACITY))
    monkeypatch.setattr(_FakeGraph, "made", 0)
    inputs = _warm_inputs((2, 1), 6, torch.float64)
    want = sym._warm_eager(*inputs, 16)
    keys = [("stress", i) for i in range(3)]
    before = {k: counters[k] for k in WARM_COUNTERS}
    threads_n, reps = 12, 20
    errors = []

    def work(t):
        try:
            for r in range(reps):
                out = sym._replay(keys[(t + r) % len(keys)], inputs, 16)
                if not torch.equal(out[3], want[3]):
                    errors.append((t, r))
        except Exception as err:  # reported by the assertion below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    moved = {k: counters[k] - before[k] for k in WARM_COUNTERS}
    assert _FakeGraph.made == len(keys) == moved["sym.warm.captures"]
    assert moved["sym.warm.replays"] == threads_n * reps and moved["sym.warm.calls"] == 0

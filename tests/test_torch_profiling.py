"""The port's phase timers and trace capture (conex_tpu_torch/utils/
profiling.py): the twin of tests/test_profiling.py, on the CPU.

``phase_timings`` returns the same four phases as the JAX package's, each
a positive wall time; ``trace`` writes a Chrome-trace JSON file that holds
the traced block's operations.
"""

import json

import numpy as np
import torch

torch.set_num_threads(1)

from conex_tpu import Program as JProgram
from conex_tpu.utils.profiling import phase_timings as jphase_timings

import conex_tpu_torch as ct
from conex_tpu_torch.utils.profiling import phase_timings, trace


def _lmi(seed=0, m=4, n=10):
    rng = np.random.default_rng(seed)
    return np.stack([0.5 * (M + M.T) for M in rng.uniform(-1, 1, (m, n, n))]), np.eye(n) * 3.0


def test_phase_timings_smoke():
    A, C = _lmi()
    prog = ct.Program(4, device="cpu")
    prog.add_lmi_constraint(A, C)
    t = phase_timings(prog, reps=2)
    jprog = JProgram(4)
    jprog.add_lmi_constraint(A, C)
    assert set(t) == set(jphase_timings(jprog, reps=1)) == {
        "assemble", "factor", "solve", "update"}
    assert all(v > 0 for v in t.values())


def test_phase_timings_of_a_sparse_program_with_equality_rows():
    """The supernodal LDLT path: variable subsets and an equality row."""
    A, C = _lmi(1, m=2, n=4)
    prog = ct.Program(3, device="cpu")
    prog.add_lmi_constraint(A, C, variables=[0, 1])
    prog.add_lmi_constraint(A, C, variables=[1, 2])
    prog.add_equality_constraint(np.ones((1, 3)), np.array([0.5]))
    assert prog._kkt_structure() is not None
    t = phase_timings(prog, ct.SolverConfig(kkt_solver=ct.KKT_SOLVER_LDLT,
                                            iterative_refinement_iterations=1), reps=1)
    assert set(t) == {"assemble", "factor", "solve", "update"}
    assert all(v > 0 for v in t.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    A, C = _lmi()
    prog = ct.Program(4, device="cpu")
    prog.add_lmi_constraint(A, C)
    with trace(tmp_path):
        res = prog.solve(np.ones(4), ct.SolverConfig(max_iterations=3))
    assert res.num_iterations == 3
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::") for name in names)

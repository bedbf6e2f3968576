"""The two ways a traffic mix drives the port, by its ``driver`` key.

``scenarios``: a closed loop of one caller that solves a batch of
``batch`` programs per call through ``conex_tpu_torch.solve_scenarios``,
cycling a device pool of ``pool`` distinct batches.

``program``: a closed loop of one caller that solves one program per
request through the front end, ``conex_tpu_torch.Program``
(``add_lmi_constraint``, ``solve``, ``get_dual_variable``), as the
Python, C and MATLAB interfaces do, cycling a host pool of ``pool`` numpy
programs (made on the device in chunks of ``chunk``).

The pool is the mix's fixed set (workload.py), solved in the same order
by every run; ``cycle`` is the number of calls that go once through it.
A call returns once its answer is complete: the batched solve ends with a
synchronize, the front end returns numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference.sdp import relative_gap
from .workload import make_chunk, solver_config


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Programs:
    """Every program the window solved, in call order."""

    iterations: np.ndarray
    solver_solved: np.ndarray  # the solver's flag
    gap: np.ndarray  # relative duality gap of its answer

    def solved(self, tolerance: float) -> np.ndarray:
        return self.solver_solved & (self.gap <= tolerance)


@dataclass
class Answers:
    """What one call returned, for the check: the chunk and the index in
    it of the first program it solved (the rest follow it), their y and
    dual X, the solver's flags."""

    chunk: int
    start: int
    y: torch.Tensor
    X: torch.Tensor
    solved: torch.Tensor


@dataclass
class Final:
    """The port's state at the end of a call: its blocks, cone iterates
    and the KKT solution, k and c_scaling of the last iteration, and the
    chunk and index of the program in its first scenario row (the rest
    follow it)."""

    blocks: tuple
    ws: tuple
    y: torch.Tensor
    k: torch.Tensor
    c_scaling: torch.Tensor
    chunk: int
    start: int


class ScenarioDriver:
    def __init__(self, config, traffic, device, dtype):
        from conex_tpu_torch import DenseLMICone

        self.n, self.m = config["n"], config["m"]
        self.batch, self.cycle = traffic["batch"], traffic["pool"]
        self.chunk_size = self.batch
        self.device, self.dtype = torch.device(device), dtype
        self.solver = solver_config(config)
        self.blocks, self.b = [], []
        for c in range(self.cycle):
            A, C, b = make_chunk(traffic["programs_seed"], c, self.batch, self.n, self.m,
                                 dtype, self.device)
            self.blocks.append(DenseLMICone(A=A[:, None], C=C[:, None]))
            self.b.append(b)

    def call(self, i):
        from conex_tpu_torch.parallel import sharded

        c = i % len(self.blocks)
        blk = self.blocks[c]
        kw = dict(dtype=self.dtype, device=self.device)
        scalars = dict(k=torch.zeros(self.batch, **kw),
                       b_scaling=torch.ones(self.batch, **kw),
                       c_scaling=torch.ones(self.batch, **kw))
        res = sharded.solve_scenarios((blk,), (), self.b[c],
                                      (blk.identity_state(self.dtype),),
                                      scalars, self.solver)
        sync(self.device)
        return c, res

    @staticmethod
    def _dual(res):
        """X = W / (k b_scaling), as Program.get_dual_variable returns it."""
        return res.ws[0].w[:, 0] / (res.k * res.b_scaling)[:, None, None]

    def account(self, recs) -> Programs:
        gaps = [relative_gap(self.blocks[c].C[:, 0], self._dual(res), self.b[c], res.y)
                for c, res in recs]
        cat = lambda xs: torch.cat([x.cpu() for x in xs]).numpy()
        return Programs(iterations=cat([res.num_iterations for _, res in recs]),
                        solver_solved=cat([res.solved for _, res in recs]),
                        gap=cat(gaps))

    def answers(self, recs) -> list:
        return [Answers(c, 0, res.y, self._dual(res), res.solved) for c, res in recs]

    def final(self, rec) -> Final:
        c, res = rec
        return Final(blocks=(self.blocks[c],), ws=res.ws, y=res.y_kkt, k=res.k,
                     c_scaling=res.c_scaling, chunk=c, start=0)

    def iterations(self, rec) -> int:
        """Newton iterations of the call: the batch runs in lockstep."""
        return int(rec[1].num_iterations.max())


class ProgramDriver:
    def __init__(self, config, traffic, device, dtype):
        self.n, self.m = config["n"], config["m"]
        size, self.chunk_size = traffic["pool"], traffic["chunk"]
        if size % self.chunk_size:
            raise ValueError("the pool must be a whole number of chunks")
        self.device, self.dtype = torch.device(device), dtype
        self.solver = solver_config(config)
        self.cycle = size
        self.A, self.C, self.b = [], [], []
        for c in range(size // self.chunk_size):
            parts = make_chunk(traffic["programs_seed"], c, self.chunk_size, self.n,
                               self.m, dtype, self.device)
            for store, part in zip((self.A, self.C, self.b), parts):
                store.append(part.cpu().numpy())
        self.last = None

    def call(self, i):
        from conex_tpu_torch import Program

        c, r = divmod(i % self.cycle, self.chunk_size)
        prog = Program(self.m, dtype=self.dtype, device=self.device)
        prog.add_lmi_constraint(self.A[c][r], self.C[c][r])
        res = prog.solve(self.b[c][r], self.solver)
        X = prog.get_dual_variable(0)
        self.last = prog
        return (c, r), res, X

    def account(self, recs) -> Programs:
        gaps = [float(relative_gap(*(torch.as_tensor(t) for t in
                                     (self.C[c][r], X, self.b[c][r], res.y))))
                for (c, r), res, X in recs]
        return Programs(
            iterations=np.array([res.num_iterations for _, res, _ in recs]),
            solver_solved=np.array([res.solved for _, res, _ in recs], dtype=bool),
            gap=np.array(gaps))

    def answers(self, recs) -> list:
        t = lambda a: torch.as_tensor(np.asarray(a))[None]
        return [Answers(c, r, t(res.y), t(X), torch.tensor([res.solved]))
                for (c, r), res, X in recs]

    def final(self, rec) -> Final:
        """The state of the last request's Program: its blocks, iterates and
        scalings, which the front end keeps for a warm start."""
        prog = self.last
        raw = prog._last_result
        kw = dict(dtype=self.dtype, device=self.device)
        return Final(blocks=tuple(prog._blocks), ws=prog._ws,
                     y=torch.as_tensor(raw.y_kkt, **kw)[None],
                     k=torch.as_tensor(raw.k, **kw).reshape(1),
                     c_scaling=prog._scalings[1], chunk=rec[0][0], start=rec[0][1])

    def iterations(self, rec) -> int:
        return int(rec[1].num_iterations)


DRIVERS = {"scenarios": ScenarioDriver, "program": ProgramDriver}


def make(config, traffic, device, dtype):
    return DRIVERS[traffic["driver"]](config, traffic, device, dtype)

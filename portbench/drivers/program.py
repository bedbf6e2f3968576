"""``program``: a closed loop of one caller that solves one program per
request through the front end, ``conex_tpu_torch.Program``, as the Python,
C and MATLAB interfaces do, cycling a host pool of ``pool`` numpy programs
(made on the device in chunks of ``chunk``).  A request returns numpy.

The problem class builds each request's ``Program`` and gives its b
(``program``), and reads its dual variables after the solve
(``program_dual``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.drivers import Answers, Final, Programs, one_chip
from portbench.workload import solver_config


class Driver:
    def __init__(self, problem, config, traffic, device, dtype, chips):
        one_chip("program", chips)
        self.problem = problem
        size, self.chunk_size = traffic["pool"], traffic["chunk"]
        if size % self.chunk_size:
            raise ValueError("the pool must be a whole number of chunks")
        self.device, self.dtype = torch.device(device), dtype
        self.solver = solver_config(config)
        self.cycle = size
        self.pool = [tuple(part.cpu().numpy() for part in
                           problem.make(config, traffic["programs_seed"], c, self.chunk_size,
                                        dtype, self.device))
                     for c in range(size // self.chunk_size)]
        self.last = None

    def _data(self, c, r):
        """Program r of chunk c, each of its arrays without the program axis."""
        return tuple(part[r] for part in self.pool[c])

    def call(self, i):
        c, r = divmod(i % self.cycle, self.chunk_size)
        prog, b = self.problem.program(self._data(c, r), self.dtype, self.device)
        res = prog.solve(b, self.solver)
        dual = self.problem.program_dual(prog)
        self.last = prog
        return (c, r), res, dual

    def account(self, recs) -> Programs:
        t = torch.as_tensor
        gaps = [float(self.problem.gap(tuple(t(a) for a in self._data(c, r)), t(dual),
                                       t(res.y)))
                for (c, r), res, dual in recs]
        return Programs(
            iterations=np.array([res.num_iterations for _, res, _ in recs]),
            solver_solved=np.array([res.solved for _, res, _ in recs], dtype=bool),
            gap=np.array(gaps))

    def answers(self, recs) -> list:
        t = lambda a: torch.as_tensor(np.asarray(a))[None]
        return [Answers(c, r, t(res.y), t(dual), torch.tensor([res.solved]))
                for (c, r), res, dual in recs]

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

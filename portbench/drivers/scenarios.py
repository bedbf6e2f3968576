"""``scenarios``: a closed loop of one caller that solves a batch of
``batch`` programs per call through ``conex_tpu_torch.solve_scenarios``,
cycling a device pool of ``pool`` distinct batches, one generator chunk
each.  The batched solve ends with a synchronize.

The problem class gives each batch's blocks, equality blocks and b
(``scenario_batch``), the initial states and scalars of a call
(``scenario_start``) and the dual variables of its answer
(``scenario_dual``).
"""

from __future__ import annotations

import torch

from portbench.drivers import Answers, Final, Programs, one_chip, sync
from portbench.workload import solver_config


class Driver:
    def __init__(self, problem, config, traffic, device, dtype, chips):
        one_chip("scenarios", chips)
        self.problem = problem
        self.batch, self.cycle = traffic["batch"], traffic["pool"]
        self.chunk_size = self.batch
        self.device, self.dtype = torch.device(device), dtype
        self.solver = solver_config(config)
        self.data, self.inputs = [], []
        for c in range(self.cycle):
            data = problem.make(config, traffic["programs_seed"], c, self.batch, dtype,
                                self.device)
            self.data.append(data)
            self.inputs.append(problem.scenario_batch(data))

    def call(self, i):
        from conex_tpu_torch.parallel import sharded

        c = i % self.cycle
        blocks, eq_blocks, b = self.inputs[c]
        init_ws, scalars = self.problem.scenario_start(blocks, b, self.dtype, self.device)
        res = sharded.solve_scenarios(blocks, eq_blocks, b, init_ws, scalars, self.solver)
        sync(self.device)
        return c, res

    def account(self, recs) -> Programs:
        gaps = [self.problem.gap(self.data[c], self.problem.scenario_dual(res), res.y)
                for c, res in recs]
        cat = lambda xs: torch.cat([x.cpu() for x in xs]).numpy()
        return Programs(iterations=cat([res.num_iterations for _, res in recs]),
                        solver_solved=cat([res.solved for _, res in recs]),
                        gap=cat(gaps))

    def answers(self, recs) -> list:
        return [Answers(c, 0, res.y, self.problem.scenario_dual(res), res.solved)
                for c, res in recs]

    def final(self, rec) -> Final:
        c, res = rec
        return Final(blocks=self.inputs[c][0], ws=res.ws, y=res.y_kkt, k=res.k,
                     c_scaling=res.c_scaling, chunk=c, start=0)

    def iterations(self, rec) -> int:
        """Newton iterations of the call: the batch runs in lockstep."""
        return int(rec[1].num_iterations.max())

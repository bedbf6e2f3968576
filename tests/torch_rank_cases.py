"""The rank side of tests/test_torch_parallel.py and test_torch_distributed.py.

Those tests spawn a gloo group of R processes on the CPU
(``conex_tpu_torch.parallel.launch.run_ranks``: spawn start method, a
``FileStore`` rendezvous, one thread per rank, a bounded wait).  The
ranks import this module, which imports no jax, so that they start
without it.  Each function below runs in every rank, runs all of its
module's cases on numpy inputs made by the test module, and returns their
results as numpy arrays; the test module holds them against the JAX
package in its own process.
"""

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from conex_tpu_torch import (DenseLMICone, EqualityBlock, LinearCone, SOCCone,
                             SolverConfig)
from conex_tpu_torch.config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from conex_tpu_torch.cones.psd import make_psd_state
from conex_tpu_torch.convert import to_numpy
from conex_tpu_torch.parallel import collectives
from conex_tpu_torch.parallel.sharded import (solve_cone_sharded, solve_scenarios,
                                              solve_scenarios_cone_sharded)
from conex_tpu_torch.solver import kkt
from conex_tpu_torch.supernodal import compressed
from conex_tpu_torch.supernodal.dist_compressed import DistributedCompressedStructure
from conex_tpu_torch.supernodal.distributed import DistributedSupernodalStructure

STRUCTURES = {"distributed": DistributedSupernodalStructure,
              "dist_compressed": DistributedCompressedStructure}


def _t(x):
    return torch.as_tensor(np.array(x, order="C"))


def _psd_states(n, *batch):
    return (make_psd_state(torch.eye(n, dtype=torch.float64).expand(*batch, n, n)
                           .contiguous()),)


def scalars(*shape):
    return dict(k=torch.zeros(shape, dtype=torch.float64),
                b_scaling=torch.ones(shape, dtype=torch.float64),
                c_scaling=torch.ones(shape, dtype=torch.float64))


def _result(res):
    r = to_numpy(res)
    return dict(y=r.y, w=r.ws[0].w if hasattr(r.ws[0], "w") else r.ws[0],
                solved=r.solved, num_iterations=r.num_iterations,
                stats_k=r.stats_k, fail=r.fail)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_cases(rank, world, data):
    tp = init_device_mesh("cpu", (world,), mesh_dim_names=("tp",))
    dp = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
    grid = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("dp", "tp"))
    out = {"coordinates": [(mesh.get_local_rank(axis), dist.get_rank(mesh.get_group(axis)))
                           for mesh, axis in ((tp, "tp"), (grid, "dp"), (grid, "tp"))]}

    A, C, b = data["cone"]
    blk = DenseLMICone(A=_t(A), C=_t(C))
    out["cone"] = _result(solve_cone_sharded(
        (blk,), (), _t(b), _psd_states(C.shape[-1], C.shape[0]), scalars(),
        SolverConfig(max_iterations=30), tp))

    A, C, b, Aeq, beq = data["cone_eq"]
    blk = DenseLMICone(A=_t(A), C=_t(C))
    eq = EqualityBlock(A=_t(Aeq), b=_t(beq))
    out["cone_eq"] = _result(solve_cone_sharded(
        (blk,), (eq,), _t(b), _psd_states(C.shape[-1], C.shape[0]), scalars(),
        SolverConfig(max_iterations=60, kkt_solver=KKT_SOLVER_LDLT), tp))

    # The line-search mu update and the dual recovery under the group: an
    # LP whose rows are sharded.
    A, c, b = data["lp"]
    out["lp"] = _result(solve_cone_sharded(
        (LinearCone(A=_t(A), c=_t(c)),), (), _t(b),
        (torch.ones(c.shape, dtype=torch.float64),), scalars(),
        SolverConfig(max_iterations=40, enable_line_search=True,
                     prepare_dual_variables=True), tp))

    A, C, b = data["scenarios"]
    S, B, n = C.shape[:3]
    out["scenarios"] = _result(solve_scenarios(
        (DenseLMICone(A=_t(A), C=_t(C)),), (), _t(b), _psd_states(n, S, B),
        scalars(S), SolverConfig(max_iterations=30), mesh=dp))

    A, C, b = data["grid"]
    S, B, n = C.shape[:3]
    out["grid"] = _result(solve_scenarios_cone_sharded(
        (DenseLMICone(A=_t(A), C=_t(C)),), (), _t(b), _psd_states(n, S, B),
        scalars(S), SolverConfig(max_iterations=25), grid, total_rank=B * n))

    # A cone axis that does not divide over the ranks raises before any
    # collective, on every rank alike.
    A, C, b = data["indivisible"]
    try:
        solve_cone_sharded((DenseLMICone(A=_t(A), C=_t(C)),), (), _t(b),
                           _psd_states(C.shape[-1], C.shape[0]), scalars(),
                           SolverConfig(max_iterations=2), tp)
        out["indivisible"] = None
    except ValueError as err:
        out["indivisible"] = str(err)

    # The reductions: one flat buffer per dtype, and the max, min and any.
    x = torch.tensor([1.0 + rank, -float(rank)], dtype=torch.float64)
    i = torch.tensor([rank], dtype=torch.int64)
    s, si = collectives.psum((x, i), tp.get_group("tp"))
    out["reductions"] = dict(
        sum=s.numpy(), isum=si.numpy(),
        max=collectives.pmax(x, tp.get_group("tp")).numpy(),
        min=collectives.pmin(x, tp.get_group("tp")).numpy(),
        any=collectives.pany(torch.tensor([rank == 1, False]), tp.get_group("tp")).numpy())
    return out


def failing_rank(rank, world):
    """Rank 1 raises while rank 0 would run for an hour."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(3600)


def hung_rank(rank, world):
    """Rank 1 never reaches the collective that rank 0 waits in."""
    if rank == 1:
        time.sleep(3600)
    dist.barrier()


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------


def _chain(kind, cliques, n, G, b, mode, world, group):
    """Factor and solve G x = b on the distributed structure ``kind``: by
    the module's own functions, and through solver/kkt.py with one step of
    refinement."""
    struct = STRUCTURES[kind].from_cliques(cliques, n, world)
    Gt = _t(G)[None]
    if kind == "dist_compressed":
        Gt = compressed.compress_dense(Gt, struct.base)
        from conex_tpu_torch.supernodal import dist_compressed as module
    else:
        from conex_tpu_torch.supernodal import distributed as module
    factor = module.factor_llt if mode == KKT_SOLVER_LLT else module.factor_ldlt
    solve = module.solve_llt if mode == KKT_SOLVER_LLT else module.solve_ldlt
    fac, fail = factor(Gt, struct, group)
    x = solve(fac, struct, _t(b)[None], group)
    f = kkt.factor(Gt, mode, struct, group)
    x_kkt = kkt.solve(f, _t(b)[None], mode, 1, struct, group)
    return dict(x=x[0].numpy(), fail=bool(fail[0]), x_kkt=x_kkt[0].numpy(),
                fail_kkt=bool(f.fail[0]))


def distributed_cases(rank, world, data):
    tp = init_device_mesh("cpu", (world,), mesh_dim_names=("tp",))
    group = tp.get_group("tp")
    out = {}
    for name, (cliques, n, G, b, mode) in data["chains"].items():
        for kind in STRUCTURES:
            out[name, kind] = _chain(kind, cliques, n, G, b, mode, world, group)
    if "soc_chain" in data:
        As, cs, vars_, b, cliques = data["soc_chain"]
        blocks = tuple(SOCCone(A=_t(A), c=_t(c), vars_=v) for A, c, v in zip(As, cs, vars_))
        ws = []
        for A in As:
            e = torch.zeros(A.shape[:2], dtype=torch.float64)
            e[:, 0] = 1.0
            ws.append(e)
        for kind in STRUCTURES:
            struct = STRUCTURES[kind].from_cliques(cliques, len(b), world)
            out["soc_chain", kind] = _result(solve_cone_sharded(
                blocks, (), _t(b), tuple(ws), scalars(), SolverConfig(max_iterations=40),
                tp, kkt_structure=struct))
    return out

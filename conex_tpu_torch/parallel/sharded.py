"""Multi-device execution: scenario batching (DP) and cone sharding (TP).

Twin of ``conex_tpu/parallel/sharded.py``.

* **Scenario batching (DP)** — many independent cone programs with the same
  structure solve as one batch (the port's loop carries the scenario axis);
  sharding the scenario axis over a mesh axis splits them across ranks with
  no collective inside the solve.
* **Cone sharding (TP)** — one large program whose cone blocks are
  partitioned across ranks.  Each rank assembles the Schur contributions of
  its local cones; the global G/AW/AQc are summed by one all-reduce per
  iteration (the additive structure of the reference's
  cone_program.cc:68-76), and the scalar aggregations (norm maxima,
  slack-eigenvalue extrema) ride along as max/min all-reduces.  The KKT
  factorization is replicated on every rank, or shared out by a
  distributed supernodal structure (supernodal/distributed.py,
  dist_compressed.py).

Both compose: a 2D mesh ("dp", "tp") shards scenarios x cones.

The caller owns the process group and the mesh: it calls
``torch.distributed.init_process_group`` with the backend of its choice and
builds a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``; the entry points take that mesh and an axis name, as
the JAX package's take ``Mesh`` and ``axis``.  Every rank passes the same
global tensors (the JAX caller passes global arrays) and slices its own
shard along the sharded axes (the twin of ``in_specs``): shard i of an axis
of size R goes to the rank whose coordinate on the mesh axis is i.  Every
rank gets the whole result back: y and the statistics replicated, the
block states ``ws`` reassembled as global tensors by an owner-masked sum
all-reduce (the twin of ``out_specs``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..cones.base import tree_map
from ..config import SolverConfig
from ..solver.kkt import indefinite_mode
from ..solver.loop import _add_scenario, _solve_impl, _strip_scenario
from ..utils.profiling import entry
from .collectives import psum


def _axis(mesh, axis: str):
    """(group, this rank's coordinate, size) of the mesh axis ``axis``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    if not dist.is_initialized():
        raise TypeError("torch.distributed is not initialized: the caller "
                        "creates the process group before the mesh")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: {names})")
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(names.index(axis))


def _shard(tree, dim: int, index: int, size: int, what: str):
    """Every tensor of ``tree`` cut to its shard ``index`` of ``size``
    along ``dim``, as a contiguous copy (the kernels take dense tensors)."""
    def cut(x):
        n = x.shape[dim]
        if n % size:
            raise ValueError(f"the {what} axis of a tensor of shape "
                             f"{tuple(x.shape)} ({n}) does not divide over "
                             f"{size} ranks")
        k = n // size
        return x.narrow(dim, index * k, k).contiguous()

    return tree_map(cut, tree)


def _unshard(tree, dim: int, index: int, size: int, group):
    """The global tensors whose shard ``index`` along ``dim`` is this
    rank's ``tree``: each rank writes its shard into zeros and one sum
    all-reduce per dtype adds them up (booleans travel as int32)."""
    placed = []

    def place(x):
        part = x.to(torch.int32) if x.dtype == torch.bool else x
        shape = list(part.shape)
        k = shape[dim]
        shape[dim] = k * size
        full = part.new_zeros(shape)
        full.narrow(dim, index * k, k).copy_(part)
        placed.append(full)
        return x

    tree_map(place, tree)
    summed = iter(psum(placed, group))
    return tree_map(lambda x: next(summed).to(x.dtype), tree)


@entry()
def solve_scenarios(blocks, eq_blocks, b, init_ws, init_scalars,
                    config: SolverConfig, mesh=None, axis: str = "dp"):
    """Solve a batch of same-structure programs, batched over the leading
    scenario axis of every tensor (block data, b, initial state, scalars).

    With ``mesh`` given, the scenario axis is sharded over the mesh axis
    ``axis``: each rank solves its S / R scenarios with no collective
    inside the loop, and the results are reassembled on every rank after
    it.  Without, the solve runs on the tensors' device.  Equality blocks
    solve with KKT_SOLVER_LDLT where ``config`` asks for LLT, as in
    ``Program.solve``; so do the other entries below."""
    config = indefinite_mode(config, eq_blocks)
    if mesh is None:
        return _solve_impl(blocks, eq_blocks, b, init_ws, init_scalars, config)
    group, index, size = _axis(mesh, axis)
    local = _shard((blocks, eq_blocks, b, init_ws, init_scalars), 0, index,
                   size, "scenario")
    res = _solve_impl(*local, config)
    return _unshard(res, 0, index, size, group)


@entry()
def solve_cone_sharded(blocks, eq_blocks, b, init_ws, init_scalars,
                       config: SolverConfig, mesh, axis: str = "tp",
                       kkt_structure=None):
    """Solve one program with its cone-block *batch* axes sharded over the
    mesh axis ``axis``.  The tensors are one program's, without the
    scenario axis (as ``solver.loop.solve`` takes them): every block must
    be a batched block whose leading cone axis divides by the axis size;
    equality blocks, b and the scalars are replicated.

    Returns the same SolveResult on every rank, its block iterates ``ws``
    reassembled along the cone axes.

    ``kkt_structure``: an optional supernodal structure; a
    DistributedSupernodalStructure or DistributedCompressedStructure
    partitioned over the axis size also shares out the KKT clique-tree
    factorization (subtree elimination per rank and one separator
    all-reduce; supernodal/distributed.py)."""
    config = indefinite_mode(config, eq_blocks)
    group, index, size = _axis(mesh, axis)
    blocks = _add_scenario(tuple(blocks))
    init_ws = _add_scenario(tuple(init_ws))
    total_rank = float(sum(blk.rank() for blk in blocks))
    res = _solve_impl(
        _shard(blocks, 1, index, size, "cone"), _add_scenario(tuple(eq_blocks)),
        b[None], _shard(init_ws, 1, index, size, "cone"),
        {key: torch.as_tensor(x).reshape(1) for key, x in init_scalars.items()},
        config, kkt_structure, group, total_rank,
    )
    res = res._replace(ws=_unshard(res.ws, 1, index, size, group))
    return _strip_scenario(res)


@entry()
def solve_scenarios_cone_sharded(
    blocks, eq_blocks, b, init_ws, init_scalars, config: SolverConfig,
    mesh, total_rank: float, dp_axis: str = "dp", tp_axis: str = "tp",
):
    """2D: the scenario axis over ``dp_axis``, the cone-batch axes over
    ``tp_axis``.

    Layouts: b is (S, m); every cone-block tensor and init state is
    (S, B, ...) with S the scenario count and B the cone batch.  Equality
    blocks carry (S, ...) data, replicated over tp.  ``total_rank`` is the
    global cone rank of ONE program.  The dp groups may stop at different
    iterations, so the loop reduces over tp only; the results are
    reassembled over dp (and the states over tp) after it."""
    config = indefinite_mode(config, eq_blocks)
    dp_group, dp_index, dp_size = _axis(mesh, dp_axis)
    tp_group, tp_index, tp_size = _axis(mesh, tp_axis)

    def scenarios(tree):
        return _shard(tree, 0, dp_index, dp_size, "scenario")

    def cones(tree):
        return _shard(scenarios(tree), 1, tp_index, tp_size, "cone")

    res = _solve_impl(
        cones(tuple(blocks)), scenarios(tuple(eq_blocks)), scenarios(b),
        cones(tuple(init_ws)), scenarios(init_scalars), config,
        group=tp_group, rank_override=float(total_rank),
    )
    ws = _unshard(_unshard(res.ws, 1, tp_index, tp_size, tp_group), 0,
                  dp_index, dp_size, dp_group)
    return _unshard(res._replace(ws=()), 0, dp_index, dp_size, dp_group)._replace(ws=ws)

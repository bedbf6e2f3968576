"""Reductions over a process group: the twins of ``jax.lax.psum``, ``pmax``,
``pmin`` and ``axis_index``.

The JAX package reduces over a named mesh axis inside ``shard_map``; the
port reduces over the ``torch.distributed`` group of that axis
(``DeviceMesh.get_group(axis)``).  ``group=None`` means one device: every
function returns its input unchanged and makes no collective.

Only ``all_reduce`` is used, which every backend supports (gloo reduces
CUDA tensors too; NCCL allows one rank per device).  The backend is the
caller's choice: nothing here picks or switches one.  Every rank of the
group must make the same calls in the same order on tensors of the same
shapes, or the group deadlocks.

Each all-reduce runs inside the profiler span ``ALL_REDUCE_SPAN``
(``utils.profiling.span``), so that a ``torch.profiler`` trace shows the
host time spent in collectives (chip_smoke.py phase 4h reads it).  With no
profiler running the span is one flag check, about 0.6 us on a CPU core,
where an unguarded profiler span costs about 13 us.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import span

ReduceOp = dist.ReduceOp
ALL_REDUCE_SPAN = "conex_tpu_torch.all_reduce"


def axis_index(group) -> int:
    """This rank's coordinate along the group's mesh axis (0 alone)."""
    return 0 if group is None else dist.get_rank(group)


def axis_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(tensors, op, group):
    """All-reduce a tuple of tensors with ``op``: the tensors of one dtype
    and device travel as one flat buffer, so a tuple of one type is one
    collective.  Returns new tensors of the inputs' shapes."""
    tensors = tuple(tensors)
    if group is None:
        return tensors
    out = list(tensors)
    runs = {}
    for i, t in enumerate(tensors):
        runs.setdefault((t.dtype, t.device), []).append(i)
    for idx in runs.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        with span(ALL_REDUCE_SPAN):
            dist.all_reduce(flat, op=op, group=group)
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(tensors[i].shape)
    return tuple(out)


def psum(tensors, group):
    """The sum over the group of each tensor of the tuple."""
    return _all_reduce(tensors, ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce((x,), ReduceOp.MAX, group)[0]


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce((x,), ReduceOp.MIN, group)[0]


def pany(flag: torch.Tensor, group) -> torch.Tensor:
    """True where any rank's boolean ``flag`` is: reduced as an int32 sum,
    as the JAX package reduces its fail flags."""
    if group is None:
        return flag
    return psum((flag.to(torch.int32),), group)[0] > 0

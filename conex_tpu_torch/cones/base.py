"""Common types for cone blocks.

Twin of ``conex_tpu/cones/base.py``.  Every tensor carries a leading
scenario axis S: a solve of S independent same-structure programs is one
batch of tensor operations, where the JAX package vmaps one program.  A
block's per-scenario scalars are (S,) tensors.

Interface of a cone block (``w`` is the block's iterate, a NamedTuple of
(S, ...) tensors; ``y`` the local segment (S, v) of the KKT solution):

  identity_state(dtype)          -> w            (reference: SetIdentity)
  rank()                         -> int          (reference: Rank)
  schur(w)                       -> SchurOut     (ConstructSchurComplementSystem)
  prepare_step(w, y, cw, ew)     -> (cache, norminf, normsq)   (PrepareStep)
  take_step(w, cache, step_size) -> w            (TakeStep)
  affine_step(w, y, e_weight)    -> w            (PrepareStep with affine=True)
  slack_stats(w, y, c_weight)    -> SlackStats   (GetWeightedSlackEigenvalues)
  dual_variable(w)               -> tensor       (get_dual_variable)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch


class SchurOut(NamedTuple):
    """One block's contribution to the Schur-complement system.

    Mirrors WorkspaceSchurComplement (reference conex/newton_step.h:51-107),
    restricted to the block's local variables.  A block whose G is
    diagonal may hand over that diagonal, a 2-D G of shape (S, v), which
    the assembly adds onto the diagonal of the block's variables (a
    LinearCone whose rows are all bound rows, cones/lp.py).
    """

    G: torch.Tensor  # (S, v, v) local Schur complement block, or (S, v) its diagonal
    AW: torch.Tensor  # (S, v)
    AQc: torch.Tensor  # (S, v)
    w_dot_c: torch.Tensor  # (S,) <w, c>
    c_dot_Qc: torch.Tensor  # (S,) <c, Q(w) c>


class SlackStats(NamedTuple):
    """Eigenvalue statistics of the weighted slack Q(w^1/2) s, per scenario.

    Mirrors WeightedSlackEigenvalues (reference conex/newton_step.h:11-18).
    """

    lam_min: torch.Tensor
    lam_max: torch.Tensor
    frob_sq: torch.Tensor
    trace: torch.Tensor


class StepCache(NamedTuple):
    """Newton direction data cached between prepare_step and take_step."""

    d: torch.Tensor


def local_vars(y: torch.Tensor, vars_: Optional[Tuple[int, ...]], v: int):
    """Gather the local variable segment of the KKT vectors y (S, N).

    Reference: Vars() (conex/cone_program.h:59-67).  None means the first
    ``v`` entries (the dense fast path, a view).
    """
    if vars_ is None:
        return y[:, :v]
    return y[:, list(vars_)]


def per_scenario(x, ndim):
    """View an (S,) tensor (or a Python number) so it broadcasts against
    (S, ...) tensors of ``ndim`` dimensions."""
    if isinstance(x, torch.Tensor):
        return x.reshape((-1,) + (1,) * (ndim - 1))
    return x


def tree_select(mask, a, b):
    """Per-scenario select over matching (nested) tuples of (S, ...)
    tensors: ``a`` where ``mask`` (S,) is True, else ``b``.  A leaf or
    subtree that is one object on both sides is returned as it is."""
    if a is b:
        return a
    if isinstance(a, tuple):
        out = [tree_select(mask, x, y) for x, y in zip(a, b)]
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    return torch.where(per_scenario(mask, a.dim()), a, b)


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a (nested) tuple, NamedTuple, dict
    or block dataclass (its tensor fields); everything else stays as it
    is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        out = [tree_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, dict):
        return {key: tree_map(fn, x) for key, x in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)
        })
    return tree

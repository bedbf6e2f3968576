"""Carry problem data and solver state between numpy and the port.

The JAX package's data and state convert to numpy with ``np.asarray``
(cone tensors ``LinearCone.A/c``, ``DenseLMICone.A/C``, ``SOCCone.A/c``,
``HermitianCone.A/C``, ``QuadraticCone.A/c/Q``, ``QuadraticCost.Q`` and
``EqualityBlock.A/b``, ``PSDState`` and ``HermState`` fields or an
octonion cone's bare iterate, the init scalars); these helpers turn such numpy arrays into the
port's tensors on a given device, and a port ``SolveResult`` or
``FusedSOCPResult`` back into numpy (``to_numpy``).  The field names and
layouts are the JAX package's, with the scenario axis first.
"""

from __future__ import annotations

import numpy as np
import torch

from .cones.equality import EqualityBlock
from .cones.hermitian import HermitianCone, HermState
from .cones.lp import LinearCone
from .cones.psd import DenseLMICone, PSDState
from .cones.qcost import QuadraticCost
from .cones.quadratic import QuadraticCone
from .cones.soc import SOCCone
from .utils.profiling import counters


def tensor(x, device=None) -> torch.Tensor:
    """A numpy array (or array-like) as a contiguous tensor of its dtype."""
    return torch.as_tensor(np.array(x, order="C"), device=device)


def linear_cone(A, c, device=None, vars_=None) -> LinearCone:
    """LinearCone from A (S, n, v) and c (S, n)."""
    return LinearCone(A=tensor(A, device), c=tensor(c, device), vars_=vars_)


def lmi_cone(A, C, device=None) -> DenseLMICone:
    """DenseLMICone from A (S, B, v, n, n) and C (S, B, n, n)."""
    return DenseLMICone(A=tensor(A, device), C=tensor(C, device))


def hermitian_cone(A, C, device=None, vars_=None) -> HermitianCone:
    """HermitianCone from A (S, B, v, d, n, n) and C (S, B, d, n, n)."""
    return HermitianCone(A=tensor(A, device), C=tensor(C, device), vars_=vars_)


def soc_cone(A, c, device=None) -> SOCCone:
    """SOCCone from A (S, B, n+1, v) and c (S, B, n+1)."""
    return SOCCone(A=tensor(A, device), c=tensor(c, device))


def quadratic_cone(A, c, Q=None, device=None, vars_=None) -> QuadraticCone:
    """QuadraticCone from A (S, B, n+1, v), c (S, B, n+1) and Q
    (S, B, n, n) or None; A_gram is computed here, as ``build`` does."""
    return QuadraticCone.build(tensor(A, device), tensor(c, device),
                               None if Q is None else tensor(Q, device), vars_)


def quadratic_cost(Q, device=None, vars_=None) -> QuadraticCost:
    """QuadraticCost from Q (S, v, v)."""
    return QuadraticCost(Q=tensor(Q, device), vars_=vars_)


def equality_block(A, b, device=None, vars_=None, dual_offset=0) -> EqualityBlock:
    """EqualityBlock from A (S, p, v) and b (S, p)."""
    return EqualityBlock(A=tensor(A, device), b=tensor(b, device), vars_=vars_,
                         dual_offset=dual_offset)


def psd_state(state, device=None) -> PSDState:
    """PSDState from any sequence of its six fields (w, vhi, uhi, vlo, ulo,
    lam) as arrays, such as a JAX ``PSDState`` mapped through np.asarray."""
    return PSDState(*(tensor(x, device) for x in state))


def herm_state(state, device=None):
    """A Hermitian cone's state: a HermState from any sequence of its six
    fields (w, vhi, uhi, vlo, ulo, lam) as arrays, such as a JAX
    ``HermState`` mapped through np.asarray, or the bare (S, B, 8, n, n)
    iterate of an octonion cone."""
    if isinstance(state, (tuple, list)):
        return HermState(*(tensor(x, device) for x in state))
    return tensor(state, device)


def scalars(init_scalars, device=None) -> dict:
    """The solve's init scalars (k, b_scaling, c_scaling) as tensors."""
    return {key: tensor(x, device) for key, x in init_scalars.items()}


def to_numpy(tree, site=None):
    """Every tensor in a (nested) tuple or NamedTuple, such as a port
    SolveResult, as a numpy array.  With ``site``, each tensor copied
    counts once in ``utils.profiling.counters[site]``: a copy of a card's
    tensor waits for the card."""
    if isinstance(tree, tuple):
        out = [to_numpy(x, site) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, torch.Tensor):
        if site is not None:
            counters[site] += 1
        return tree.detach().cpu().numpy()
    return tree

"""Carry problem data and solver state between numpy and the port.

The JAX package's data and state convert to numpy with ``np.asarray``
(cone tensors ``LinearCone.A/c``, ``DenseLMICone.A/C`` and
``SOCCone.A/c``, ``PSDState``
fields, the init scalars); these helpers turn such numpy arrays into the
port's tensors on a given device, and a port ``SolveResult`` or
``FusedSOCPResult`` back into numpy (``to_numpy``).  The field names and
layouts are the JAX package's, with the scenario axis first.
"""

from __future__ import annotations

import numpy as np
import torch

from .cones.lp import LinearCone
from .cones.psd import DenseLMICone, PSDState
from .cones.soc import SOCCone


def tensor(x, device=None) -> torch.Tensor:
    """A numpy array (or array-like) as a contiguous tensor of its dtype."""
    return torch.as_tensor(np.array(x, order="C"), device=device)


def linear_cone(A, c, device=None) -> LinearCone:
    """LinearCone from A (S, n, v) and c (S, n)."""
    return LinearCone(A=tensor(A, device), c=tensor(c, device))


def lmi_cone(A, C, device=None) -> DenseLMICone:
    """DenseLMICone from A (S, B, v, n, n) and C (S, B, n, n)."""
    return DenseLMICone(A=tensor(A, device), C=tensor(C, device))


def soc_cone(A, c, device=None) -> SOCCone:
    """SOCCone from A (S, B, n+1, v) and c (S, B, n+1)."""
    return SOCCone(A=tensor(A, device), c=tensor(c, device))


def psd_state(state, device=None) -> PSDState:
    """PSDState from any sequence of its six fields (w, vhi, uhi, vlo, ulo,
    lam) as arrays, such as a JAX ``PSDState`` mapped through np.asarray."""
    return PSDState(*(tensor(x, device) for x in state))


def scalars(init_scalars, device=None) -> dict:
    """The solve's init scalars (k, b_scaling, c_scaling) as tensors."""
    return {key: tensor(x, device) for key, x in init_scalars.items()}


def to_numpy(tree):
    """Every tensor in a (nested) tuple or NamedTuple, such as a port
    SolveResult, as a numpy array."""
    if isinstance(tree, tuple):
        out = [to_numpy(x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree

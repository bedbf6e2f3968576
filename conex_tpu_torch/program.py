"""Host-side Program: a conic program of SOC and LMI constraints.

Twin of the SOC and LMI subset of ``conex_tpu/program.py``: collect
Lorentz-cone and dense LMI constraints, then solve coldstart or warmstart
and read back the dual variables.  The other adders come with their cones
(ROADMAP.md queue 1).  A Program runs on one device, given as ``device=``:
the card (``"cuda"``) unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from .config import COLDSTART, WARMSTART, SolverConfig, not_ported
from .cones.psd import DenseLMICone
from .cones.soc import SOCCone
from .convert import to_numpy
from .solver.loop import SolveResult, _solve_impl, _strip_scenario


@dataclasses.dataclass
class Result:
    """Solve outcome; mirrors ConexStatus (cone_program.h:40-45) + solution."""

    solved: bool
    y: np.ndarray
    num_iterations: int
    primal_infeasible: bool
    dual_infeasible: bool
    stats_inv_sqrt_mu: np.ndarray
    stats_norminf_d: np.ndarray
    mu_stalled: bool = False
    _raw: SolveResult = dataclasses.field(repr=False, default=None)


class Program:
    """A conic program: maximize b'y  s.t.  c_j - A_j y in Q (Lorentz
    cones) and C - sum_i y_i A_i PSD (LMIs)."""

    def __init__(self, num_vars: int, dtype=torch.float64, device="cuda"):
        self.num_vars = int(num_vars)
        self.dtype = dtype
        self.device = torch.device(device)
        self._blocks: List[Union[SOCCone, DenseLMICone]] = []
        self._ws = None  # warmstart state (final cone iterates)
        self._scalings = None  # (b_scaling, c_scaling) from last solve
        self._last_result: Optional[SolveResult] = None

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            device=self.device, dtype=self.dtype
        )

    def _check_variables(self, variables, v):
        """Only the first v variables are supported: a sparse subset needs
        the supernodal KKT path, not ported yet."""
        if v > self.num_vars:
            raise ValueError("constraint has more variables than the program")
        if variables is not None:
            t = tuple(int(x) for x in variables)
            if len(set(t)) != len(t):
                raise ValueError("duplicate variables in constraint")
            if t != tuple(range(v)):
                raise not_ported("sparse variable subsets", "13")

    def add_soc_constraint(self, A, c, variables=None):
        """c - A y in the Lorentz cone (reference SOCConstraint).

        A: (n+1, v), c: (n+1,) for a single cone; or batched
        A: (B, n+1, v), c: (B, n+1) for B same-shape cones over the same
        variables.
        """
        A = np.asarray(A, dtype=np.float64)
        c = np.asarray(c, dtype=np.float64)
        if A.ndim == 2:
            A = A[None]
            c = c[None]
        if A.ndim != 3 or A.shape[:2] != c.shape:
            raise ValueError("A and c batch/cone dimensions must match")
        self._check_variables(variables, A.shape[2])
        self._blocks.append(
            SOCCone(A=self._tensor(A)[None], c=self._tensor(c)[None])
        )
        return len(self._blocks) - 1

    def add_lmi_constraint(self, A, C, variables=None):
        """C - sum_i y_i A_i PSD (reference DenseLMIConstraint).

        A: (v, n, n) stack of symmetric matrices, C: (n, n) for a single
        LMI; or batched A: (B, v, n, n), C: (B, n, n) for B same-shape LMIs
        over the same variables.  ``variables`` other than the first v
        (a sparse subset) needs the supernodal KKT path, not ported yet.
        """
        A = np.asarray(A, dtype=np.float64)
        C = np.asarray(C, dtype=np.float64)
        if A.ndim == 3:
            A = A[None]
            C = C[None]
        if A.ndim != 4 or A.shape[2] != A.shape[3] or A.shape[0] != C.shape[0] or C.shape[1:] != A.shape[2:]:
            raise ValueError("LMI shapes must be A:(B,v,n,n), C:(B,n,n)")
        if not np.allclose(A, np.swapaxes(A, 2, 3)) or not np.allclose(
            C, np.swapaxes(C, 1, 2)
        ):
            raise ValueError("LMI matrices must be symmetric")
        self._check_variables(variables, A.shape[1])
        self._blocks.append(
            DenseLMICone(A=self._tensor(A)[None], C=self._tensor(C)[None])
        )
        return len(self._blocks) - 1

    def solve(self, b, config: Optional[SolverConfig] = None) -> Result:
        """Maximize b'y over the constraints.  reference: Solve(b, prog, ...)."""
        if config is None:
            config = SolverConfig()
        b = self._tensor(np.asarray(b, dtype=np.float64).reshape(-1))
        if b.shape[0] != self.num_vars:
            raise ValueError("objective dimension mismatch")
        if not self._blocks:
            raise ValueError("empty program: add at least one cone constraint")

        if config.initialization_mode == WARMSTART and self._ws is None:
            config = config.replace(initialization_mode=COLDSTART)
        # The solve runs as a batch of one scenario: block tensors, states
        # and scalings all carry a leading axis of one.
        if config.initialization_mode == WARMSTART:
            init_ws = self._ws
            b_scaling, c_scaling = self._scalings
        else:
            init_ws = tuple(blk.identity_state(self.dtype) for blk in self._blocks)
            b_scaling = c_scaling = torch.ones((1,), dtype=self.dtype, device=self.device)
        init_scalars = dict(
            k=torch.zeros((1,), dtype=self.dtype, device=self.device),
            b_scaling=b_scaling,
            c_scaling=c_scaling,
        )

        res = _solve_impl(
            tuple(self._blocks), (), b[None], init_ws, init_scalars, config
        )

        self._ws = res.ws
        self._scalings = (res.b_scaling, res.c_scaling)
        raw = to_numpy(_strip_scenario(res))
        self._last_result = raw
        n_iter = int(raw.num_iterations)
        return Result(
            solved=bool(raw.solved),
            y=raw.y,
            num_iterations=n_iter,
            primal_infeasible=bool(raw.primal_infeasible),
            dual_infeasible=bool(raw.dual_infeasible),
            stats_inv_sqrt_mu=raw.stats_k[:n_iter],
            stats_norminf_d=raw.stats_dinf[:n_iter],
            mu_stalled=bool(raw.mu_stalled),
            _raw=raw,
        )

    def get_dual_variable(self, i: int) -> np.ndarray:
        """Dual (primal-cone) variable of constraint i.

        reference: Program::GetDualVariable (cone_program.h:120-134) — the
        cone iterate divided by (inv_sqrt_mu * b_scaling).  Requires the last
        solve to have used prepare_dual_variables=True for exact duals.
        """
        raw = self._last_result
        if raw is None:
            raise RuntimeError("no solve yet")
        blk = self._blocks[i]
        w = np.asarray(blk.dual_variable(raw.ws[i])) * getattr(
            blk, "dual_scale", 1.0
        )
        if not bool(raw.primal_infeasible):
            w = w / (float(raw.k) * float(raw.b_scaling))
        if w.ndim >= 2 and w.shape[0] == 1:
            w = w[0]  # single-cone batch: return the cone element itself
        return w

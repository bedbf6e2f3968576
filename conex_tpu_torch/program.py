"""Host-side Program: a conic program of LP, SOC and LMI constraints.

Twin of the LP, SOC and LMI subset of ``conex_tpu/program.py``: collect
linear, Lorentz-cone and dense LMI constraints, update their data in
place, solve coldstart or warmstart, read back the dual variables, and
save or load the warmstart state.  The other adders come with their cones
(ROADMAP.md queue 1).  A Program runs on one device, given as ``device=``:
the card (``"cuda"``) unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from .config import COLDSTART, WARMSTART, SolverConfig, not_ported
from .cones.lp import LinearCone
from .cones.psd import DenseLMICone, PSDState
from .cones.soc import SOCCone
from .convert import to_numpy
from .solver.loop import SolveResult, _solve_impl, _strip_scenario, assemble


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

    def report(self) -> str:
        """Per-iteration metric table, mirroring the reference's REPORT
        output under CONEX_VERBOSE (cone_program.cc:460-468)."""
        raw = self._raw
        n = self.num_iterations
        lines = ["  i         mu        d_2      d_inf         by         cx   kkt_err"]
        mu = 1.0 / np.asarray(raw.stats_k)[:n] ** 2
        for i in range(n):
            lines.append(
                f"{i:3d} {mu[i]:10.2e} {float(raw.stats_d2[i]):10.2e} "
                f"{float(raw.stats_dinf[i]):10.2e} {float(raw.stats_by[i]):10.2e} "
                f"{float(raw.stats_cx[i]):10.2e} {float(raw.stats_err[i]):9.2e}"
            )
        return "\n".join(lines)


class Program:
    """A conic program: maximize b'y  s.t.  c - A y >= 0 (linear),
    c_j - A_j y in Q (Lorentz cones) and C - sum_i y_i A_i PSD (LMIs)."""

    def __init__(self, num_vars: int, dtype=torch.float64, device="cuda"):
        self.num_vars = int(num_vars)
        self.dtype = dtype
        self.device = torch.device(device)
        self._blocks: List[Union[LinearCone, SOCCone, DenseLMICone]] = []
        self._ws = None  # warmstart state (final cone iterates)
        self._scalings = None  # (b_scaling, c_scaling) from last solve
        self._last_result: Optional[SolveResult] = None

    def _tensor(self, x):
        """A copy of x on the Program's device in its type: no tensor of
        the Program shares memory with a caller's array."""
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                            device=self.device)

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

    def add_linear_constraint(self, A, c, variables=None):
        """c - A y >= 0 elementwise (reference LinearConstraint).

        A: (n, v), c: (n,).  ``variables`` other than the first v (a sparse
        subset) needs the supernodal KKT path, not ported yet.
        """
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        if A.shape[0] != c.shape[0]:
            raise ValueError("A rows must match c length")
        self._check_variables(variables, A.shape[1])
        self._blocks.append(
            LinearCone(A=self._tensor(A)[None], c=self._tensor(c)[None])
        )
        return len(self._blocks) - 1

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

    # -- incremental updates ----------------------------------------------

    def _with_entries(self, x, entries):
        """A copy of tensor x with x[index] = value for each (index, value):
        a tensor a caller may hold is never written."""
        x = x.clone()
        for index, value in entries:
            x[index] = value
        return x

    def update_linear_operator(self, i, value, variable, row, col=0,
                               hyper_complex_dim=0):
        """Update one entry of constraint i's linear operator (the block's
        tensor is rebuilt; its structure, and so warmstart state, stays).

        reference: Program::UpdateLinearOperatorOfConstraint
        (cone_program.h:147-159) with per-cone semantics of
        UpdateLinearOperator (linear_constraint.cc:207-216,
        soc_constraint.cc:314-324).  The JAX index gains the scenario
        axis: A[0, row, variable] (LP), A[0, 0, row, variable] (SOC, the
        first cone of the block), A[0, 0, variable, row, col] and its
        mirror (LMI).
        """
        blk = self._blocks[i]
        v = float(value)
        if isinstance(blk, LinearCone):
            if hyper_complex_dim != 0 or col != 0:
                raise ValueError("linear constraints are real vector valued")
            A = self._with_entries(blk.A, [((0, row, variable), v)])
        elif isinstance(blk, SOCCone):
            if hyper_complex_dim != 0 or col != 0:
                raise ValueError("SOC constraints are real vector valued")
            A = self._with_entries(blk.A, [((0, 0, row, variable), v)])
        elif isinstance(blk, DenseLMICone):
            if hyper_complex_dim != 0:
                raise ValueError("use a Hermitian constraint for d > 1")
            A = self._with_entries(blk.A, [((0, 0, variable, row, col), v),
                                           ((0, 0, variable, col, row), v)])
        else:
            raise ValueError("constraint does not support operator updates")
        self._blocks[i] = dataclasses.replace(blk, A=A)

    def update_affine_term(self, i, value, row, col=0, hyper_complex_dim=0):
        """Update one entry of constraint i's affine term.

        reference: Program::UpdateAffineTermOfConstraint
        (cone_program.h:161-172).
        """
        blk = self._blocks[i]
        v = float(value)
        if isinstance(blk, LinearCone):
            blk = dataclasses.replace(
                blk, c=self._with_entries(blk.c, [((0, row), v)]))
        elif isinstance(blk, SOCCone):
            blk = dataclasses.replace(
                blk, c=self._with_entries(blk.c, [((0, 0, row), v)]))
        elif isinstance(blk, DenseLMICone):
            blk = dataclasses.replace(blk, C=self._with_entries(
                blk.C, [((0, 0, row, col), v), ((0, 0, col, row), v)]))
        else:
            raise ValueError("constraint does not support affine updates")
        self._blocks[i] = blk

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

    # -- checkpoint / resume ----------------------------------------------

    def save_state(self) -> dict:
        """Serializable warmstart checkpoint: the cone iterates + scalings,
        as plain numpy arrays in the JAX package's layout (no scenario
        axis), storable with np.savez."""
        if self._ws is None:
            raise RuntimeError("no state yet: solve first")
        return dict(
            ws=to_numpy(_strip_scenario(tuple(self._ws))),
            b_scaling=float(self._scalings[0][0]),
            c_scaling=float(self._scalings[1][0]),
        )

    def load_state(self, state: dict) -> None:
        """Restore a checkpoint produced by save_state (the port's or the
        JAX package's); the next solve with initialization_mode=WARMSTART
        resumes from it exactly (reference test_warmstart.cc:47-79)."""
        ws = []
        for blk, w in zip(self._blocks, tuple(state["ws"])):
            if isinstance(blk, DenseLMICone):
                ws.append(PSDState(*(self._tensor(x)[None] for x in w)))
            else:
                ws.append(self._tensor(w)[None])
        self._ws = tuple(ws)
        self._scalings = tuple(
            self._tensor(np.reshape(state[key], (1,)))
            for key in ("b_scaling", "c_scaling")
        )

    def get_feasible_objective(self) -> np.ndarray:
        """b = 0.5 * A(w) at w = identity: a feasible objective generator.

        reference: GetFeasibleObjective (cone_program.cc:535-545).
        """
        blocks = tuple(self._blocks)
        ws = tuple(blk.identity_state(self.dtype) for blk in blocks)
        _, AW, _, _, _ = assemble(blocks, ws, self.num_vars, self.dtype)
        return 0.5 * to_numpy(AW[0])

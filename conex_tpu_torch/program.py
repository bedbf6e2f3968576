"""Host-side Program: a conic program with equality constraints and
quadratic costs.

Twin of ``conex_tpu/program.py``: collect linear, Lorentz-cone,
Q-weighted quadratic-cone, dense LMI and Hermitian LMI constraints,
quadratic costs and their epigraphs, and affine equalities, each over the
first v variables or any subset (``variables=``); update cone data in
place, solve coldstart or warmstart, read back the dual variables (cones
and equalities), and save or load the warmstart state.  A program with a
subset other than the first v solves on the supernodal KKT path: the
clique tree of its blocks' variable sets, factored per clique (the
unrolled structure) or, above ``SCAN_CLIQUE_THRESHOLD`` cliques, on the
block-compressed buffer.  A Program runs on one device, given as
``device=``: the card (``"cuda"``) unless the caller asks for ``"cpu"``.

Every ``add_*`` runs in the span ``conex.program.add``, the reads of the
duals in ``conex.program.dual``, and ``solve`` is an entry of the port
(``conex.call/<n>``) whose copy of the result to numpy runs in
``conex.program.copy_out`` (utils/profiling.py).  Each copy of a host
array to the Program's device counts in ``sync.front_end.copy_in``, each
tensor of the result copied back in ``sync.front_end.copy_out``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from .config import COLDSTART, WARMSTART, SolverConfig
from .cones.equality import EqualityBlock
from .cones.hermitian import HermitianCone, HermState
from .cones.lp import LinearCone
from .cones.psd import DenseLMICone, PSDState
from .cones.qcost import QuadraticCost
from .cones.quadratic import QuadraticCone, epigraph_cone_data
from .cones.soc import SOCCone
from .convert import to_numpy
from .solver.kkt import indefinite_mode
from .solver.loop import SolveResult, _solve_impl, _strip_scenario, assemble
from .supernodal.compressed import CompressedSupernodalStructure
from .supernodal.solver import SupernodalStructure
from .utils.profiling import counters, entry, span, spanned

# Above this many cliques the solve uses the block-compressed supernodal
# path (supernodal/compressed.py: the flat padded per-clique factor buffer)
# instead of one step per clique at its own size.  Read at each solve, so
# that a caller may set it on the module.
SCAN_CLIQUE_THRESHOLD = 24


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
    """A conic program: maximize b'y (- 1/2 y'Q y)  s.t.  c - A y in K,
    A_eq y = b_eq; K a product of linear, (Q-weighted) Lorentz, LMI and
    Hermitian LMI cones."""

    def __init__(self, num_vars: int, dtype=torch.float64, device="cuda"):
        self.num_vars = int(num_vars)
        self.dtype = dtype
        self.device = torch.device(device)
        self._blocks: List[Union[LinearCone, SOCCone, QuadraticCone,
                                 DenseLMICone, HermitianCone,
                                 QuadraticCost]] = []
        self._eq_blocks: List[EqualityBlock] = []
        self._dual_size = 0
        self._has_quadratic_cost = False
        self._ws = None  # warmstart state (final cone iterates)
        self._scalings = None  # (b_scaling, c_scaling) from last solve
        self._last_result: Optional[SolveResult] = None

    def _tensor(self, x):
        """A copy of x on the Program's device in its type: no tensor of
        the Program shares memory with a caller's array."""
        counters["sync.front_end.copy_in"] += 1
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                            device=self.device)

    def _check_variables(self, variables, v):
        """The block's ``vars_``: None for the first v variables (the dense
        fast path), else the tuple of its variables (JAX
        ``_as_tuple_or_none``)."""
        if v > self.num_vars:
            raise ValueError("constraint has more variables than the program")
        if variables is None:
            return None
        t = tuple(int(x) for x in variables)
        if len(set(t)) != len(t):
            raise ValueError("duplicate variables in constraint")
        return None if t == tuple(range(v)) else t

    @spanned("conex.program.add")
    def add_linear_constraint(self, A, c, variables=None):
        """c - A y >= 0 elementwise (reference LinearConstraint).

        A: (n, v), c: (n,); ``variables``: the v variables it covers
        (default the first v).
        """
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        if A.shape[0] != c.shape[0]:
            raise ValueError("A rows must match c length")
        vars_ = self._check_variables(variables, A.shape[1])
        self._blocks.append(
            LinearCone(A=self._tensor(A)[None], c=self._tensor(c)[None], vars_=vars_)
        )
        return len(self._blocks) - 1

    @spanned("conex.program.add")
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
        vars_ = self._check_variables(variables, A.shape[2])
        self._blocks.append(
            SOCCone(A=self._tensor(A)[None], c=self._tensor(c)[None], vars_=vars_)
        )
        return len(self._blocks) - 1

    @spanned("conex.program.add")
    def add_lmi_constraint(self, A, C, variables=None):
        """C - sum_i y_i A_i PSD (reference DenseLMIConstraint).

        A: (v, n, n) stack of symmetric matrices, C: (n, n) for a single
        LMI; or batched A: (B, v, n, n), C: (B, n, n) for B same-shape LMIs
        over the same variables.
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
        vars_ = self._check_variables(variables, A.shape[1])
        self._blocks.append(
            DenseLMICone(A=self._tensor(A)[None], C=self._tensor(C)[None], vars_=vars_)
        )
        return len(self._blocks) - 1

    @spanned("conex.program.add")
    def add_hermitian_constraint(self, A, C, variables=None):
        """C - sum_i y_i A_i PSD in a hypercomplex Hermitian algebra.

        reference: HermitianPsdConstraint<T> (hermitian_psd.h).  Formats:
        - complex dtype A: (v, n, n), C: (n, n) -> complex algebra (d = 2)
        - real stacked A: (v, d, n, n), C: (d, n, n), d in {1, 2, 4, 8}
        - batched real stacked A: (B, v, d, n, n), C: (B, d, n, n)
        Component 0 must be symmetric, components >= 1 skew-symmetric.
        Octonions (d = 8) require n <= 3 (the Albert algebra).
        """
        A = np.asarray(A)
        C = np.asarray(C)
        if np.iscomplexobj(A):
            A = np.stack([A.real, A.imag], axis=-3)
            C = np.stack([np.asarray(C).real, np.asarray(C).imag], axis=-3)
        A = A.astype(np.float64)
        C = C.astype(np.float64)
        if A.ndim == 4:
            A = A[None]
            C = C[None]
        if A.ndim != 5 or C.ndim != 4 or A.shape[2:] != C.shape[1:] or A.shape[0] != C.shape[0]:
            raise ValueError(
                "Hermitian LMI shapes must be A:(B,v,d,n,n), C:(B,d,n,n)"
            )
        d = A.shape[2]
        if d not in (1, 2, 4, 8):
            raise ValueError("algebra dimension must be 1, 2, 4, or 8")
        if d == 8 and A.shape[-1] > 3:
            raise ValueError("octonion Hermitian cones require order <= 3")
        for M in (A.reshape(-1, d, *A.shape[-2:]), C.reshape(-1, d, *C.shape[-2:])):
            if not np.allclose(M[:, 0], np.swapaxes(M[:, 0], -1, -2)):
                raise ValueError("component 0 must be symmetric")
            if d > 1 and not np.allclose(
                M[:, 1:], -np.swapaxes(M[:, 1:], -1, -2)
            ):
                raise ValueError("components >= 1 must be skew-symmetric")
        vars_ = self._check_variables(variables, A.shape[1])
        self._blocks.append(
            HermitianCone(A=self._tensor(A)[None], C=self._tensor(C)[None], vars_=vars_)
        )
        return len(self._blocks) - 1

    @spanned("conex.program.add")
    def add_quadratic_cone_constraint(self, A, c, Q=None, variables=None):
        """c - A y in the Q-weighted Lorentz cone (reference
        QuadraticConstraint): slack (s0, s1) with s0 >= sqrt(s1' Q s1).

        A: (n+1, v), c: (n+1,), Q: (n, n) PSD or None (identity); or the
        batched forms with a leading B axis.
        """
        A = np.asarray(A, dtype=np.float64)
        c = np.asarray(c, dtype=np.float64)
        if A.ndim == 2:
            A = A[None]
            c = c[None]
            if Q is not None:
                Q = np.asarray(Q, dtype=np.float64)[None]
        if A.ndim != 3 or A.shape[:2] != c.shape:
            raise ValueError("A and c batch/cone dimensions must match")
        if Q is not None:
            Q = np.asarray(Q, dtype=np.float64)
            if Q.shape != (A.shape[0], A.shape[1] - 1, A.shape[1] - 1):
                raise ValueError("Q must be (B, n, n) matching A")
        vars_ = self._check_variables(variables, A.shape[2])
        self._blocks.append(QuadraticCone.build(
            self._tensor(A)[None], self._tensor(c)[None],
            None if Q is None else self._tensor(Q)[None], vars_=vars_,
        ))
        return len(self._blocks) - 1

    @spanned("conex.program.add")
    def add_quadratic_cost_epigraph(self, Qi, variables, epigraph_variable):
        """t >= 1/2 x'Qi x through a Q-weighted Lorentz cone, with x the
        ``variables`` and t the ``epigraph_variable``; add -1 * t to the
        objective to minimize the cost.

        reference: AddQuadraticCostEpigraph
        (quadratic_cone_constraint.h:91-118).  x = y[0:nv], t = y[nv] is
        the dense fast path; any other placement is a sparse subset.
        """
        Qi = np.atleast_2d(np.asarray(Qi, dtype=np.float64))
        variables = list(variables)
        if len(variables) != Qi.shape[0]:
            raise ValueError("Qi order must match number of variables")
        Q, A, b = epigraph_cone_data(torch.tensor(Qi, dtype=torch.float64))
        return self.add_quadratic_cone_constraint(
            A.numpy(), b.numpy(), Q=Q.numpy(),
            variables=variables + [int(epigraph_variable)],
        )

    @spanned("conex.program.add")
    def add_quadratic_cost(self, Q, variables=None):
        """Adds -1/2 y'Q y to the (maximized) objective.

        reference: Program::AddQuadraticCost (cone_program.cc:554-570).
        Requires enable_line_search and no rescaling at solve time
        (reference guard cone_program.cc:237-240, checked in solve()).
        """
        Q = np.atleast_2d(np.asarray(Q, dtype=np.float64))
        if Q.shape[0] != Q.shape[1] or not np.allclose(Q, Q.T):
            raise ValueError("quadratic cost must be square symmetric")
        vars_ = self._check_variables(variables, Q.shape[0])
        self._has_quadratic_cost = True
        self._blocks.append(QuadraticCost(Q=self._tensor(Q)[None], vars_=vars_))
        return len(self._blocks) - 1

    @spanned("conex.program.add")
    def add_equality_constraint(self, A, b, variables=None):
        """A y = b (reference EqualityConstraints); returns the index that
        get_equality_dual takes."""
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        vars_ = self._check_variables(variables, A.shape[1])
        self._eq_blocks.append(EqualityBlock(
            A=self._tensor(A)[None], b=self._tensor(b)[None], vars_=vars_,
            dual_offset=self._dual_size,
        ))
        self._dual_size += A.shape[0]
        return len(self._eq_blocks) - 1

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
        soc_constraint.cc:314-324, hermitian_psd.cc:248-283).  The JAX
        index gains the scenario axis: A[0, row, variable] (LP),
        A[0, 0, row, variable] (SOC, the first cone of the block),
        A[0, 0, variable, row, col] and its mirror (LMI),
        A[0, 0, variable, d, row, col] and its mirror, negated for d > 0
        (Hermitian).
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
        elif isinstance(blk, HermitianCone):
            d = hyper_complex_dim
            if value != 0 and row == col and d > 0:
                raise ValueError("imaginary diagonal must be zero")
            A = self._with_entries(blk.A, [
                ((0, 0, variable, d, row, col), v),
                ((0, 0, variable, d, col, row), v if d == 0 else -v)])
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
        elif isinstance(blk, HermitianCone):
            d = hyper_complex_dim
            blk = dataclasses.replace(blk, C=self._with_entries(
                blk.C, [((0, 0, d, row, col), v),
                        ((0, 0, d, col, row), v if d == 0 else -v)]))
        else:
            raise ValueError("constraint does not support affine updates")
        self._blocks[i] = blk

    def _kkt_structure(self):
        """Supernodal clique-tree structure when the program is sparse.

        Cliques are per-block variable sets, with equality dual indices
        appended to their constraint's clique (reference
        constraint_manager.h:71-86).  Dense programs (every block on the
        first v variables) use the dense factorization.  reference:
        kkt_solver.cc 104-116 (GetData on cliques + dual vars); valid_leaf
        weighting forces dual-bearing cliques inward
        (clique_ordering.cc:99-107).
        """
        if not any(blk.vars_ is not None for blk in self._blocks) and not any(
            eq.vars_ is not None for eq in self._eq_blocks
        ):
            return None
        cliques = []
        valid_leaf = []
        for blk in self._blocks:
            cliques.append(list(blk.vars_) if blk.vars_ is not None
                           else list(range(blk.num_vars)))
            valid_leaf.append(1)
        for eq in self._eq_blocks:
            c = list(eq.vars_) if eq.vars_ is not None else list(range(eq.num_vars))
            cliques.append(c + [self.num_vars + eq.dual_offset + i
                                for i in range(eq.p)])
            valid_leaf.append(0)
        struct = SupernodalStructure.from_cliques(
            cliques, self.num_vars + self._dual_size, valid_leaf=valid_leaf
        )
        # Many-clique programs: the block-compressed buffer, O(sum of block
        # sizes) memory instead of O(N^2), assembled by scattering each
        # cone contribution straight into the per-clique blocks.  The
        # unrolled structure stays for few-clique programs, where
        # per-clique shapes beat the padding.
        if len(struct.blocks) > SCAN_CLIQUE_THRESHOLD:
            return CompressedSupernodalStructure.from_structure(struct)
        return struct

    def _default_config(self, config: Optional[SolverConfig]) -> SolverConfig:
        return indefinite_mode(SolverConfig() if config is None else config,
                               self._eq_blocks)

    @entry()
    def solve(self, b, config: Optional[SolverConfig] = None) -> Result:
        """Maximize b'y over the constraints.  reference: Solve(b, prog, ...)."""
        config = self._default_config(config)
        if self._has_quadratic_cost and not (
            config.enable_line_search and not config.enable_rescaling
        ):
            # reference guard: cone_program.cc:237-240.
            raise ValueError(
                "quadratic costs require enable_line_search=True and "
                "enable_rescaling=False"
            )
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
            tuple(self._blocks), tuple(self._eq_blocks), b[None], init_ws,
            init_scalars, config, kkt_structure=self._kkt_structure(),
        )

        self._ws = res.ws
        self._scalings = (res.b_scaling, res.c_scaling)
        with span("conex.program.copy_out"):
            raw = to_numpy(_strip_scenario(res), site="sync.front_end.copy_out")
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

    @spanned("conex.program.dual")
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

    @spanned("conex.program.dual")
    def get_equality_dual(self, i: int) -> np.ndarray:
        """lambda of equality block i, from the tail of the KKT solution.

        reference: equality_constraint.cc:30-35 (lambda = y tail).  Scaled
        by 1/(inv_sqrt_mu * b_scaling) like the cone duals, so that the
        stationarity condition b = A_cone' x + A_eq' lambda holds.
        """
        raw = self._last_result
        if raw is None:
            raise RuntimeError("no solve yet")
        lam = self._eq_blocks[i].dual_variable(raw.y_kkt[None], self.num_vars)[0]
        if not bool(raw.primal_infeasible):
            lam = lam / (float(raw.k) * float(raw.b_scaling))
        return lam

    # -- checkpoint / resume ----------------------------------------------

    def save_state(self) -> dict:
        """Serializable warmstart checkpoint: the cone iterates + scalings,
        as plain numpy arrays in the JAX package's layout (no scenario
        axis), storable with np.savez: an array per linear, SOC, quadratic
        or octonion block, the six fields of a PSDState or HermState (the
        port's NamedTuple, with the JAX one's fields) per LMI or Hermitian
        block of d <= 4."""
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
            elif isinstance(blk, HermitianCone) and not blk.octonion:
                ws.append(HermState(*(self._tensor(x)[None] for x in w)))
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
        n_kkt = self.num_vars + self._dual_size
        _, AW, _, _, _ = assemble(blocks, tuple(self._eq_blocks), ws, n_kkt,
                                  self.num_vars, self.dtype)
        return 0.5 * to_numpy(AW[0, :self.num_vars])

"""High-level Conex-compatible API.

Twin of ``conex_tpu/interface.py``.  Mirrors the capability surface of the
reference's C API (interfaces/conex.h:41-99) and its Python binding
(interfaces/python/ConexProgram.py), python3-ified:
constraint construction (dense/sparse LMI over all hypercomplex dims,
linear inequalities with box preprocessing, Lorentz cones, quadratic
costs), incremental updates (New* + UpdateLinearOperator/UpdateAffineTerm),
Maximize/Solve, dual readback, per-iteration statistics, and a KKT error
checker.  A ``Conex`` builds a ``Program`` on its ``device``: the card
unless the caller asks for the CPU.  A d = 1 LMI goes to
``add_lmi_constraint`` (and so through the Schur kernel on the card), d > 1
to ``add_hermitian_constraint``.  A sparse LMI (variables other than the
first v) makes the Program sparse: it is solved on the supernodal KKT path
(``supernodal/``), as in ``conex_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .config import SolverConfig
from .program import Program


@dataclasses.dataclass
class IterationStats:
    """reference: CONEX_IterationStats (interfaces/conex.h:31-35)."""

    iteration_number: int
    mu: float


@dataclasses.dataclass
class Errors:
    """reference: ConexProgram.py Errors."""

    Ax_minus_b: float = 0.0
    x_dot_s: float = 0.0
    min_eig_S: list = dataclasses.field(default_factory=list)
    min_eig_X: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Solution:
    y: np.ndarray = None
    x: list = dataclasses.field(default_factory=list)
    s: list = dataclasses.field(default_factory=list)
    status: bool = False
    err: Errors = dataclasses.field(default_factory=Errors)


def preprocess_linear_inequality(A, lb, ub):
    """Split box constraints lb <= A y <= ub into normalized one-sided
    inequalities + equalities.

    reference: PreprocessLinearInequality (linear_constraint.cc:22-46):
    rows with lb == ub become equalities; finite bounds each contribute a
    row scaled by 1/sqrt(|a|^2 + rhs^2).
    """
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    lb = np.asarray(lb, dtype=np.float64).reshape(-1)
    ub = np.asarray(ub, dtype=np.float64).reshape(-1)
    Aineq, bineq, Aeq, beq = [], [], [], []
    for i in range(A.shape[0]):
        if lb[i] == ub[i]:
            scale = 1.0 / np.sqrt(A[i] @ A[i] + ub[i] ** 2)
            Aeq.append(scale * A[i])
            beq.append(scale * ub[i])
        else:
            if ub[i] < 1e8:
                scale = 1.0 / np.sqrt(A[i] @ A[i] + ub[i] ** 2)
                Aineq.append(scale * A[i])
                bineq.append(scale * ub[i])
            if lb[i] > -1e8:
                scale = 1.0 / np.sqrt(A[i] @ A[i] + lb[i] ** 2)
                Aineq.append(-scale * A[i])
                bineq.append(-scale * lb[i])
    return (
        np.asarray(Aineq),
        np.asarray(bineq),
        np.asarray(Aeq),
        np.asarray(beq),
    )


class _StagedConstraint:
    """An incrementally-built constraint (New* + Update* C API calls)."""

    def __init__(self, kind, order, hyper_complex_dim=1, num_rows=None):
        self.kind = kind  # "lmi" | "lorentz" | "linear" | "qcost"
        self.order = order
        self.d = hyper_complex_dim
        self.num_rows = num_rows
        self.A = None  # grown on demand
        self.c = None
        self.num_vars = 0

    def _ensure_var(self, var):
        self.num_vars = max(self.num_vars, var + 1)

    def update_linear_operator(self, value, variable, row, col, dim):
        # reference: CONEX_UpdateLinearOperator semantics per kind
        # (hermitian_psd.cc:248-283, soc_constraint.cc:314-324,
        # linear_constraint.cc:207-216).
        self._ensure_var(variable)
        if self.kind == "lmi":
            if dim >= self.d:
                raise ValueError("hypercomplex dimension out of bounds")
            if row == col and dim > 0 and value != 0:
                raise ValueError("imaginary diagonal must be zero")
            if self.A is None:
                self.A = np.zeros((0, self.d, self.order, self.order))
            while self.A.shape[0] <= variable:
                self.A = np.concatenate(
                    [self.A, np.zeros((1,) + self.A.shape[1:])]
                )
            self.A[variable, dim, row, col] = value
            self.A[variable, dim, col, row] = value if dim == 0 else -value
        elif self.kind in ("lorentz", "linear"):
            if dim != 0:
                raise ValueError("complex constraints not supported here")
            if col != 0:
                raise ValueError("constraint is not matrix valued")
            rows = self.order + 1 if self.kind == "lorentz" else self.num_rows
            if row >= rows:
                raise ValueError("row index out of bounds")
            if self.A is None:
                self.A = np.zeros((rows, 0))
            while self.A.shape[1] <= variable:
                self.A = np.concatenate(
                    [self.A, np.zeros((self.A.shape[0], 1))], axis=1
                )
            self.A[row, variable] = value
        elif self.kind == "qcost":
            if self.A is None:
                self.A = np.zeros((self.order, self.order))
            self.A[row, variable] = value
        return True

    def update_affine_term(self, value, row, col, dim):
        if self.kind == "qcost":
            # reference: QuadraticFunction UpdateAffineTerm writes the cost
            # matrix entry directly (quadratic_cost.cc:33-39); the C API's
            # CONEX_UpdateQuadraticCostMatrix routes here with dim=0
            # (interfaces/conex.cc:356-363).
            if dim != 0:
                raise ValueError("Quadratic cost must be real valued matrix.")
            if row >= self.order or col >= self.order:
                raise ValueError("Index out of bounds")
            if self.A is None:
                self.A = np.zeros((self.order, self.order))
            self.A[row, col] = value
            return True
        if self.kind == "lmi":
            if dim >= self.d:
                raise ValueError("hypercomplex dimension out of bounds")
            if self.c is None:
                self.c = np.zeros((self.d, self.order, self.order))
            self.c[dim, row, col] = value
            self.c[dim, col, row] = value if dim == 0 else -value
        else:
            rows = self.order + 1 if self.kind == "lorentz" else self.num_rows
            if row >= rows:
                raise ValueError("row index out of bounds")
            if self.c is None:
                self.c = np.zeros(rows)
            self.c[row] = value
        return True


class Conex:
    """Drop-in equivalent of the reference Python `Conex` class; its
    Program runs on ``device``."""

    def __init__(self, m: int = -1, device="cuda"):
        self.m = m
        self.device = device
        self._staged: List[_StagedConstraint] = []
        self._direct = []  # (kind, args) added via Add* methods
        self._A = []  # user-facing operators for ComputeErrors
        self._c = []
        self.num_constraints = 0
        self._prog: Optional[Program] = None
        self._result = None
        self._linear_cost = None
        self._built_n = -1
        self._block_map: Dict[int, int] = {}

    def SetNumberOfVariables(self, m):
        self.m = m

    # -- direct constraint construction -----------------------------------

    def AddLinearInequality(self, A, c):
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        self._direct.append(("linear", (A, c, None)))
        self._A.append(A)
        self._c.append(c)
        if self.m < 0:
            self.m = A.shape[1]
        self.num_constraints += 1

    def AddLinearInequalities(self, A, lb, ub):
        Aineq, bineq, Aeq, beq = preprocess_linear_inequality(A, lb, ub)
        if len(Aineq):
            self._direct.append(("linear", (Aineq, bineq, None)))
            self._A.append(Aineq)
            self._c.append(bineq)
            self.num_constraints += 1
        if len(Aeq):
            self._direct.append(("equality", (Aeq, beq, None)))

    def AddDenseLMIConstraint(self, A, C):
        """A: (n, n, m) stack (reference numpy layout) or (m, n, n)."""
        A = np.asarray(A, dtype=np.float64)
        C = np.asarray(C, dtype=np.float64)
        if A.ndim != 3:
            raise ValueError("LMI operator must be 3d")
        if A.shape[0] == A.shape[1] != A.shape[2]:
            A = np.moveaxis(A, 2, 0)  # (n, n, m) -> (m, n, n)
        self._direct.append(("lmi", (A, C, None)))
        self._A.append(A)
        self._c.append(C)
        if self.m < 0:
            self.m = A.shape[0]
        self.num_constraints += 1

    def AddSparseLMIConstraint(self, A, C, variables):
        A = np.asarray(A, dtype=np.float64)
        if A.shape[0] == A.shape[1] != A.shape[2]:
            A = np.moveaxis(A, 2, 0)
        self._direct.append(("lmi", (A, np.asarray(C, float), list(variables))))
        self._A.append(A)
        self._c.append(np.asarray(C, float))
        self.num_constraints += 1

    def AddLorentzConeConstraint(self, A, c):
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        self._direct.append(("lorentz", (A, c, None)))
        self._A.append(A)
        self._c.append(c)
        self.num_constraints += 1

    def AddComplexLMIConstraint(self, A, C):
        """A: complex (m, n, n) or real stacked (m, 2, n, n)."""
        self._direct.append(("hermitian", (np.asarray(A), np.asarray(C), None)))
        self._A.append(np.asarray(A))
        self._c.append(np.asarray(C))
        self.num_constraints += 1

    def AddHermitianLMIConstraint(self, A, C):
        self._direct.append(
            ("hermitian", (np.asarray(A, float), np.asarray(C, float), None))
        )
        self._A.append(np.asarray(A, float))
        self._c.append(np.asarray(C, float))
        self.num_constraints += 1

    # Aliases matching the reference Python binding's method names.
    def AddDenseLinearMatrixInequality(self, A, C):
        return self.AddDenseLMIConstraint(A, C)

    def AddSparseLinearMatrixInequality(self, A, C, variables):
        return self.AddSparseLMIConstraint(A, C, variables)

    def AddQuadraticCost(self, P):
        P = np.atleast_2d(np.asarray(P, dtype=np.float64))
        if self.m >= 0 and P.shape != (self.m, self.m):
            raise ValueError(
                "Cost matrix dimension does not match number of variables."
            )
        self._direct.append(("qcost", (P, None, None)))

    def AddLinearCost(self, c):
        c = np.asarray(c, dtype=np.float64).reshape(-1)
        if self._linear_cost is None:
            self._linear_cost = np.zeros(self.m)
        self._linear_cost = self._linear_cost + c

    # -- incremental construction (reference C API New*/Update*) ----------

    def NewLinearMatrixInequality(self, order, hyper_complex_dim=1):
        if order < 1:
            raise ValueError("Invalid LMI dimensions.")
        if hyper_complex_dim not in (1, 2, 4, 8):
            raise ValueError("Hypercomplex dimension must be 1, 2, 4, or 8.")
        if hyper_complex_dim == 8 and order > 3:
            raise ValueError("Octonion LMIs must have order <= 3.")
        sc = _StagedConstraint("lmi", order, hyper_complex_dim)
        self._staged.append(sc)
        self._direct.append(("staged", (sc, None, None)))
        self.num_constraints += 1
        return len(self._direct) - 1

    def NewLorentzConeConstraint(self, order):
        sc = _StagedConstraint("lorentz", order)
        self._staged.append(sc)
        self._direct.append(("staged", (sc, None, None)))
        self.num_constraints += 1
        return len(self._direct) - 1

    def NewLinearInequality(self, num_rows):
        sc = _StagedConstraint("linear", 0, num_rows=num_rows)
        self._staged.append(sc)
        self._direct.append(("staged", (sc, None, None)))
        self.num_constraints += 1
        return len(self._direct) - 1

    def NewQuadraticCost(self):
        # reference: CONEX_NewQuadraticCost (interfaces/conex.cc:331-341) —
        # registers an all-zero m x m cost filled in afterwards via
        # CONEX_UpdateQuadraticCostMatrix (-> UpdateAffineTerm).
        if self.m < 0:
            raise ValueError("Set the number of variables first.")
        sc = _StagedConstraint("qcost", self.m)
        self._staged.append(sc)
        self._direct.append(("staged", (sc, None, None)))
        self.num_constraints += 1
        return len(self._direct) - 1

    def UpdateQuadraticCostMatrix(self, constraint, value, row, col):
        # reference: interfaces/conex.cc:356-363.
        return self.UpdateAffineTerm(constraint, value, row, col, 0)

    def UpdateLinearOperator(self, constraint, value, variable, row, col=0,
                             hyper_complex_dim=0):
        """Update one operator entry.  Cheap when a Program is already
        built: value-only updates route to the structure-preserving
        Program.update_linear_operator, so the Program and its warmstart
        state stay valid and the next Maximize re-solves it (reference
        contract: in-place updates with solver reuse,
        cone_program.h:147-172, interfaces/conex.cc).  Updates that grow
        the constraint (a new variable index) invalidate the build."""
        kind, (sc, _, _) = self._direct[constraint]
        assert kind == "staged"
        grows = sc.A is None or variable >= sc.num_vars
        sc.update_linear_operator(value, variable, row, col, hyper_complex_dim)
        if (
            not grows
            and self._prog is not None
            and constraint in self._block_map
        ):
            self._prog.update_linear_operator(
                self._block_map[constraint], value, variable, row, col,
                hyper_complex_dim,
            )
        else:
            self._prog = None  # structure changed: rebuild on next solve

    def UpdateAffineTerm(self, constraint, value, row, col=0,
                         hyper_complex_dim=0):
        kind, (sc, _, _) = self._direct[constraint]
        assert kind == "staged"
        sc.update_affine_term(value, row, col, hyper_complex_dim)
        if self._prog is not None and constraint in self._block_map:
            self._prog.update_affine_term(
                self._block_map[constraint], value, row, col,
                hyper_complex_dim,
            )
        else:
            self._prog = None

    # -- solving ----------------------------------------------------------

    def DefaultConfiguration(self) -> SolverConfig:
        # reference: ConexProgram.py DefaultConfiguration overrides.
        return SolverConfig(
            inv_sqrt_mu_max=1000.0,
            maximum_mu=1e20,
            max_iterations=100,
            final_centering_steps=1,
            prepare_dual_variables=True,
            infeasibility_threshold=1e8,
            divergence_upper_bound=1.0,
        )

    def _build(self) -> Program:
        if self.m < 0:
            raise ValueError("number of variables unknown")
        prog = Program(self.m, device=self.device)
        self._built_n = len(self._direct)
        self._block_map: Dict[int, int] = {}
        for ci, (kind, (a1, a2, vars_)) in enumerate(self._direct):
            if kind == "staged":
                sc = a1
                A = sc.A
                c = sc.c
                if sc.kind == "lmi":
                    if A is None:
                        raise ValueError("empty staged LMI")
                    if c is None:
                        c = np.zeros((sc.d, sc.order, sc.order))
                    if sc.d == 1:
                        idx = prog.add_lmi_constraint(A[:, 0], c[0])
                    else:
                        idx = prog.add_hermitian_constraint(A, c)
                elif sc.kind == "lorentz":
                    nv = A.shape[1]
                    if c is None:
                        c = np.zeros(sc.order + 1)
                    idx = prog.add_soc_constraint(A, c)
                elif sc.kind == "linear":
                    if c is None:
                        c = np.zeros(sc.num_rows)
                    idx = prog.add_linear_constraint(A, c)
                elif sc.kind == "qcost":
                    Q = A if A is not None else np.zeros((sc.order, sc.order))
                    # Entry updates may fill only one triangle; the cost
                    # form 1/2 y'Qy only sees the symmetric part.
                    prog.add_quadratic_cost(0.5 * (Q + Q.T))
                    continue  # costs have no dual variable / block index
                self._block_map[ci] = idx
            elif kind == "linear":
                self._block_map[ci] = prog.add_linear_constraint(a1, a2, variables=vars_)
            elif kind == "equality":
                prog.add_equality_constraint(a1, a2, variables=vars_)
            elif kind == "lmi":
                self._block_map[ci] = prog.add_lmi_constraint(a1, a2, variables=vars_)
            elif kind == "lorentz":
                self._block_map[ci] = prog.add_soc_constraint(a1, a2, variables=vars_)
            elif kind == "hermitian":
                self._block_map[ci] = prog.add_hermitian_constraint(a1, a2, variables=vars_)
            elif kind == "qcost":
                prog.add_quadratic_cost(a1)
        return prog

    def Maximize(self, b, config: Optional[SolverConfig] = None) -> Solution:
        if config is None:
            config = self.DefaultConfiguration()
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        if b.shape[0] != self.m:
            raise ValueError(
                "Cost vector dimension does not match number of variables."
            )
        # Reuse the built Program (and its warmstart state) when only
        # values changed since the last build; rebuild only on structural
        # change (new constraints, grown operators).
        if self._prog is None or self._built_n != len(self._direct):
            self._prog = self._build()
        if self._prog._has_quadratic_cost:
            config = config.replace(
                enable_line_search=True, enable_rescaling=False
            )
        self._result = self._prog.solve(b, config)
        sol = Solution()
        sol.y = self._result.y
        sol.status = self._result.solved
        return sol

    def Solve(self, config: Optional[SolverConfig] = None) -> Solution:
        # reference: CONEX_Solve — uses the accumulated linear cost and
        # forces the line-search configuration (ConexProgram.py:128-139).
        if config is None:
            config = self.DefaultConfiguration()
        config = config.replace(enable_line_search=True, enable_rescaling=False)
        cost = self._linear_cost
        if cost is None:
            cost = np.zeros(self.m)
        return self.Maximize(-cost, config)

    # -- readback ---------------------------------------------------------

    def GetDualVariable(self, i):
        blk = self._block_map.get(i)
        if blk is None:
            raise ValueError("constraint has no dual variable")
        return self._prog.get_dual_variable(blk)

    def GetDualVariables(self):
        return [self.GetDualVariable(i) for i in range(len(self._direct))
                if i in self._block_map]

    def GetIterationNumberStats(self, num) -> IterationStats:
        # reference: CONEX_GetIterationStats with circular indexing
        # (interfaces/conex.cc:259-285).
        stats_k = self._result.stats_inv_sqrt_mu
        n = len(stats_k)
        if num < 0:
            num = n + num
        if num < 0 or num >= n:
            raise IndexError("Specified iteration is out of bounds.")
        return IterationStats(
            iteration_number=num, mu=float(1.0 / stats_k[num] ** 2)
        )

    def GetIterationStats(self):
        last = self.GetIterationNumberStats(-1).iteration_number
        return [self.GetIterationNumberStats(i) for i in range(last + 1)]

    def ComputeErrors(self, y, xa, b):
        """KKT error checker (reference ConexProgram.py:244-276)."""
        err = Errors()
        err.min_eig_S = []
        err.min_eig_X = []
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        Ax = np.zeros_like(b)
        sa = []
        xds = 0.0
        for i, blk_i in enumerate(sorted(self._block_map)):
            A = self._A[i]
            c = self._c[i]
            x = np.asarray(xa[i])
            if A.ndim == 3:  # LMI
                Ay = np.einsum("vij,v->ij", A, y)
                s = c - Ay
                Ax += np.einsum("vij,ij->v", A, x)
                xds += np.trace(s @ x)
                err.min_eig_S.append(np.linalg.eigvalsh(s).min())
                err.min_eig_X.append(np.linalg.eigvalsh(x).min())
            else:
                s = c - A @ y
                Ax += A.T @ x
                xds += float(s @ x)
                err.min_eig_S.append(s.min())
                err.min_eig_X.append(x.min())
            sa.append(s)
        err.Ax_minus_b = float(np.linalg.norm(b - Ax))
        err.x_dot_s = xds
        return sa, err

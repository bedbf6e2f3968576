"""Solver configuration.

Field-for-field copy of ``conex_tpu.config.SolverConfig`` with the same
defaults, so a configuration written for the JAX package means the same
thing here.  The copy exists because importing ``conex_tpu.config`` would
import ``conex_tpu``, which imports jax; a test keeps the two in step.

Every field is implemented by the solve loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

COLDSTART = 0
WARMSTART = 1

# KKT solver modes (reference: conex/kkt_solver.h:10-14).
KKT_SOLVER_LLT = 0
KKT_SOLVER_LDLT = 1
KKT_SOLVER_QR = 2

# Matmul precision mode names of the JAX package (conex_tpu/algebra/mm.py).
# Every mode computes in the data's own dtype here: float32 products on the
# card are true float32 (TF32 is switched off where a solve starts), and
# float64 is native.
SCHUR_PRECISION_MODES = ("default", "x3", "x6", "highest", "float32", "ozaki")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the geodesic interior-point solver.

    Defaults match reference conex/cone_program.h:17-38.
    """

    prepare_dual_variables: bool = False
    initialization_mode: int = COLDSTART
    # inv_sqrt_mu_max = 1/sqrt(mu_final): the target accuracy.
    inv_sqrt_mu_max: float = 1000.0
    minimum_mu: float = 1e-15
    maximum_mu: float = 1e4
    divergence_upper_bound: float = 1.0
    enable_line_search: bool = False
    dinf_upper_bound: float = 1.0
    final_centering_steps: int = 5
    final_centering_tolerance: float = 0.01
    initial_centering_steps_warmstart: int = 0
    initial_centering_steps_coldstart: int = 0
    warmstart_abort_threshold: float = 2.0
    max_iterations: int = 25
    infeasibility_threshold: float = 1e5
    kkt_error_tolerance: float = 1e10
    kkt_solver: int = KKT_SOLVER_LLT
    enable_rescaling: bool = True
    iterative_refinement_iterations: int = 0

    # --- additions beyond the reference ---
    # Solve dtype.  None => inherit from problem data.
    dtype: Optional[str] = None
    # Fixed-iteration throughput mode: run exactly ``max_iterations`` Newton
    # iterations with no early termination of any kind (no final-centering
    # exit, no mu-target stop, no stall exit).  Benchmark-only.
    fixed_iterations: bool = False
    # Precision guard: absolute cap on the *scaled* k = 1/sqrt(mu) carried
    # by the loop.  The scaled mu governs the conditioning of the Schur
    # complement, so this keeps it factorable at a given arithmetic
    # precision.  inf disables (default).
    inv_sqrt_mu_cap_scaled: float = float("inf")
    # Mu-stall detection: exit (mu_stalled=True, solved=False) after
    # mu_stall_iterations consecutive non-centering mu updates with less
    # than mu_stall_tolerance relative progress on k.  0 disables.
    mu_stall_iterations: int = 0
    mu_stall_tolerance: float = 1e-4
    # Numerical-floor latch: a divergence-mode mu update that collapses k
    # (k_new < mu_floor_drop_ratio * k_old) while k is already within
    # mu_floor_kmax_fraction of k_max holds k, enters final centering and
    # exits solved after the centering budget.  0 disables.
    mu_floor_drop_ratio: float = 0.5
    mu_floor_kmax_fraction: float = 0.1
    # Matmul precision mode of the JAX package; one of
    # SCHUR_PRECISION_MODES.  Accepted for compatibility: every mode
    # computes in the data's own dtype here.
    schur_precision: str = "default"
    # Precision island for the dense KKT factor+solve: "float64" casts the
    # assembled Schur complement to f64 for factorization and the
    # triangular solves, casting solutions back to the solve dtype.
    # None = factor in the solve dtype.
    kkt_island_dtype: Optional[str] = None

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()

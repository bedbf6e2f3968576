"""conex_tpu_torch: the geodesic interior-point solver in PyTorch, for CUDA.

A port of ``conex_tpu`` (JAX) that mirrors its module layout, one twin per
module.  It covers the batched dense-SDP solve (dense LMI cones, the
divergence mu update and the dense LLT KKT path, with the Schur phase as a
hand-written CUDA kernel, ``csrc/schur.cu``) and the batched SOCP solve
(the SOC cone on the general path, and ``parallel.fused_socp``, the whole
solve as one CUDA kernel, ``csrc/fused_socp.cu``).  Each kernel runs on the
card and its plain PyTorch twin on the CPU.  The package imports torch and
numpy, never jax.
"""

from .config import (
    COLDSTART,
    DEFAULT_CONFIG,
    KKT_SOLVER_LDLT,
    KKT_SOLVER_LLT,
    KKT_SOLVER_QR,
    WARMSTART,
    SolverConfig,
)
from .parallel.sharded import solve_scenarios
from .program import Program, Result

__all__ = [
    "COLDSTART",
    "DEFAULT_CONFIG",
    "KKT_SOLVER_LDLT",
    "KKT_SOLVER_LLT",
    "KKT_SOLVER_QR",
    "WARMSTART",
    "Program",
    "Result",
    "SolverConfig",
    "solve_scenarios",
]

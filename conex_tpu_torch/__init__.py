"""conex_tpu_torch: the geodesic interior-point solver in PyTorch, for CUDA.

A port of ``conex_tpu`` (JAX) that mirrors its module layout, one twin per
module.  It covers the batched dense-SDP solve (dense LMI cones, the
divergence mu update and the dense LLT KKT path, with the Schur phase as a
hand-written CUDA kernel, ``csrc/schur.cu``), the batched SOCP solve (the
SOC cone on the general path, and ``parallel.fused_socp``, the whole
solve as one CUDA kernel, ``csrc/fused_socp.cu``), the LP cone with
the line-search mu update, and the indefinite-KKT half: equality
constraints, quadratic costs and Q-weighted quadratic cones, with the
clamped LDLT and QR KKT modes, the Hermitian PSD cones over the complex
numbers, quaternions and octonions, and the two front ends
(``interface.Conex`` and ``sedumi.solve_sedumi``).  Each kernel runs on the
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
from .cones.equality import EqualityBlock
from .cones.hermitian import HermitianCone
from .cones.lp import LinearCone
from .cones.psd import DenseLMICone
from .cones.qcost import QuadraticCost
from .cones.quadratic import QuadraticCone
from .cones.soc import SOCCone
from .parallel.sharded import solve_scenarios
from .program import Program, Result

__all__ = [
    "COLDSTART",
    "DEFAULT_CONFIG",
    "KKT_SOLVER_LDLT",
    "KKT_SOLVER_LLT",
    "KKT_SOLVER_QR",
    "WARMSTART",
    "DenseLMICone",
    "EqualityBlock",
    "HermitianCone",
    "LinearCone",
    "Program",
    "QuadraticCone",
    "QuadraticCost",
    "Result",
    "SOCCone",
    "SolverConfig",
    "solve_scenarios",
]

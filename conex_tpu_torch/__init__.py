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
numbers, quaternions and octonions, the supernodal KKT path for programs
whose blocks cover variable subsets (``supernodal/``: the clique-tree
ordering, with its C++ version in ``native/``, and the unrolled, padded
and block-compressed factorizations), multi-device execution over a
``torch.distributed`` mesh (``parallel.sharded``: scenario and cone
sharding, with the distributed supernodal factorizations), the phase
timers (``utils.profiling``), and the two front ends
(``interface.Conex`` and ``sedumi.solve_sedumi``, exported lazily).  Each kernel runs on the
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


def __getattr__(name):
    # Lazy exports, as in the JAX package: the front ends import more
    # modules than a solve needs.
    if name == "Conex":
        from .interface import Conex

        return Conex
    if name == "solve_sedumi":
        from .sedumi import solve_sedumi

        return solve_sedumi
    raise AttributeError(name)


__all__ = [
    "COLDSTART",
    "Conex",
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
    "solve_sedumi",
]

__version__ = "0.1.0"

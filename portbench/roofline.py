"""Peaks of the card and the work of the Schur phase, counted from shapes.

The Schur phase of a dense LMI cone (DenseLMICone.schur) forms, per cone,
the m + 1 panels Op_v W (C W as operator m), 2 (m+1) n^3 operations, and
one triangle of the symmetric extended Gram matrix over them,
2 (m+1)(m+2)/2 n^2.  Each operation is counted once, whatever passes an
implementation makes.  Bytes: A, W and C read once, G, AW, AQc, w_dot_c
and c_dot_Qc of each program written once.
"""

from __future__ import annotations

# NVIDIA's data sheet, SXM part, dense rates: float64 on the FP64 tensor
# cores, float32 products as TF32 on the tensor cores, HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float64": 67e12, "float32": 495e12,
                              "bytes_per_s": 3.35e12},
}


def schur_ops(cones: int, m: int, n: int) -> int:
    return (2 * cones * (m + 1) * n**3
            + 2 * cones * ((m + 1) * (m + 2) // 2) * n**2)


def schur_bytes(cones: int, programs: int, m: int, n: int, itemsize: int) -> int:
    return itemsize * (cones * (m + 2) * n * n + programs * (m * m + 2 * m + 2))


def bound_s(ops: int, nbytes: int, kind: str, dtype: str):
    """(least seconds, "operations" or "bytes") on a card of ``kind``, or
    None for a card or type the table does not hold."""
    peak = PEAKS.get(kind, {})
    if dtype not in peak:
        return None
    compute, memory = ops / peak[dtype], nbytes / peak["bytes_per_s"]
    return (compute, "operations") if compute >= memory else (memory, "bytes")

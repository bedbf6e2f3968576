"""Dense KKT solvers: Cholesky (LLT), clamped LDLT, QR; iterative refinement.

Twin of the dense paths of ``conex_tpu/solver/kkt.py``, batched over the
scenario axis: K is (S, N, N), right-hand sides (S, N), and the fail flag
(S,).  Each scenario makes its own clamp decisions and sets its own fail
flag.  With a supernodal structure (``supernodal/``) the LLT and LDLT
factor along the clique tree instead: the unrolled and padded structures
take the dense K, the compressed one its flat (S, buf_size) buffer.  The
two distributed structures (supernodal/distributed.py, dist_compressed.py)
factor and solve across the ranks of a process ``group``, the twin of the
JAX package's ``axis_name``: the distributed one on the dense K, the
distributed compressed one on its base structure's buffer.

Mode semantics (reference kkt_solver.cc:172-199):
  LLT  - used when there are no equality-constraint duals.
  LDLT - indefinite KKT systems.  The reference pivots fully, with pivots
         clamped to +/-1e-9 (RLDLT.h:381-393); the JAX package runs a fixed
         elimination order with the same clamp and leans on iterative
         refinement, and so does this port.  The clamp decisions are part
         of the result, so the loop is written out here rather than taken
         from ``torch.linalg.ldl_factor``, which pivots (Bunch-Kaufman).
  QR   - a dense least-squares fallback for rank-deficient systems,
         factored once and reused by every solve of the iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT, KKT_SOLVER_QR
from ..utils.profiling import spanned

# Pivot clamp magnitude (reference RLDLT.h:261-263, 310-318).
LDLT_PIVOT_CLAMP = 1e-9
# Panel width of the blocked LDLT.  The JAX package takes the scalar loop
# up to this order and the blocked one above it; the port does the same,
# so that both round alike.
LDLT_PANEL = 128


class KKTFactor(NamedTuple):
    matrix: torch.Tensor  # (S, N, N) KKT matrix (kept for refinement)
    # (S, N, N) Cholesky L (LLT), unit-L with d on the diagonal (LDLT), or
    # the (Q, R) pair (QR)
    factor: object
    fail: torch.Tensor  # (S,) bool: factorization failed


def island_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """SolverConfig.kkt_island_dtype ("float64", ...) as a torch dtype."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"kkt_island_dtype {name!r} is not a floating dtype")
    return dtype


def _cholesky(K):
    # jnp.linalg.cholesky symmetrizes its input ((K + K^T) / 2) before
    # factoring; cholesky_ex reads only the lower triangle.  Symmetrize
    # first, or the rounding asymmetry of the assembled G drifts the two
    # packages apart.
    L, info = torch.linalg.cholesky_ex(0.5 * (K + K.transpose(-2, -1)))
    # The reference treats Eigen::LLT info() != Success as failure
    # (kkt_solver.cc:178-189); a non-finite input fails too, as the NaN
    # test of the JAX package does.
    fail = (info != 0) | ~torch.isfinite(L).all(dim=(-2, -1))
    return L, fail


def _clamp_pivot(d):
    """Pivots with |d| < 1e-9 become +/-1e-9, an exact 0 becoming +1e-9
    (RLDLT.h:381-393)."""
    clamp = torch.full_like(d, LDLT_PIVOT_CLAMP)
    return torch.where(d.abs() < LDLT_PIVOT_CLAMP,
                       torch.where(d >= 0, clamp, -clamp), d)


def _factor_columns(M, lo, hi):
    """Right-looking fixed-order LDLT steps j = lo .. hi-1 on M (S, n, n),
    in place, updating only rows and columns below hi: the scalar loop of
    the JAX package (``_ldlt_scalar``, ``panel_factor``) on a square.

    Column j is read as it stands (no symmetrization): M[j+1:, j] / d is
    the L column, the trailing square loses d * l l^T, and the clamped
    pivot lands on the diagonal.  The entries above the diagonal keep
    stale intermediates, as in the JAX package."""
    for j in range(lo, hi):
        d = _clamp_pivot(M[:, j, j])
        l_col = M[:, j + 1:hi, j] / d[:, None]
        # M - d * (l l^T) as one fused multiply-add per entry, as XLA
        # computes the JAX package's update: a separate product and
        # subtraction round twice, and an unpivoted factor amplifies that
        # (1e-7 apart at n = 130 on a random symmetric K).
        M[:, j + 1:hi, j + 1:hi].addcmul_(
            l_col[:, :, None] * l_col[:, None, :], d[:, None, None], value=-1)
        M[:, j + 1:hi, j] = l_col
        M[:, j, j] = d


def _ldlt_scalar(K):
    """Fixed-order LDLT with pivot clamping of the (S, n, n) K: M holds the
    unit-lower L strictly below the diagonal and d on it.  reference:
    RLDLT.h:381-393; JAX ``_ldlt_scalar``."""
    M = K.clone()
    _factor_columns(M, 0, M.shape[-1])
    return M, ~torch.isfinite(M).all(dim=(-2, -1))


def _ldlt_clamped(K, panel: int = LDLT_PANEL):
    """Blocked right-looking fixed-order LDLT with the +/-1e-9 clamp.

    Panels of ``panel`` columns: the diagonal block by the scalar steps,
    then the panel solve L21 = (A21 L11^-T) / d and the trailing update
    M22 -= (L21 d) L21^T as products.  The same elimination order, and so
    the same clamp decisions, as the scalar loop.  reference:
    BlockLDLTInPlace (block_triangular_operations.cc:315-349); JAX
    ``_ldlt_clamped``.  The JAX package pads n to a multiple of the panel
    with an identity; the port's last panel is narrower instead, which
    changes no entry of the factor (LDLT(blockdiag(K, I)) =
    blockdiag(LDLT(K), I)).
    """
    n = K.shape[-1]
    if n <= panel:
        return _ldlt_scalar(K)
    M = K.clone()
    for j0 in range(0, n, panel):
        j1 = min(j0 + panel, n)
        _factor_columns(M, j0, j1)
        if j1 == n:
            break
        L11 = torch.tril(M[:, j0:j1, j0:j1], -1)
        d = torch.diagonal(M[:, j0:j1, j0:j1], dim1=-2, dim2=-1)
        X = torch.linalg.solve_triangular(
            L11, M[:, j1:, j0:j1].transpose(-2, -1), upper=False,
            unitriangular=True).transpose(-2, -1)
        L21 = X / d[:, None, :]
        M[:, j1:, j0:j1] = L21
        M[:, j1:, j1:] -= (L21 * d[:, None, :]) @ L21.transpose(-2, -1)
    return M, ~torch.isfinite(M).all(dim=(-2, -1))


def _supernodal(structure):
    """The module that factors and solves on ``structure``, and whether it
    runs across the ranks of a group."""
    from ..supernodal import compressed, dist_compressed, distributed, scan
    from ..supernodal import solver as unrolled

    for module, kind, spread in (
            (compressed, compressed.CompressedSupernodalStructure, False),
            (scan, scan.ScanSupernodalStructure, False),
            (unrolled, unrolled.SupernodalStructure, False),
            (dist_compressed, dist_compressed.DistributedCompressedStructure, True),
            (distributed, distributed.DistributedSupernodalStructure, True)):
        if isinstance(structure, kind):
            return module, spread
    raise TypeError(f"unknown supernodal structure {type(structure).__name__}")


def _sparse(structure, mode: int) -> bool:
    # QR always runs on the dense matrix (reference kkt_solver.cc:174-177).
    return structure is not None and mode in (KKT_SOLVER_LLT, KKT_SOLVER_LDLT)


@spanned("conex.factor")
def factor(K, mode: int, structure=None, group=None,
           island_dtype=None) -> KKTFactor:
    """Factor the (S, N, N) KKT matrices, or with a (distributed)
    compressed structure the (S, buf_size) compressed buffers.
    ``structure``: optional supernodal structure to factor along (QR
    ignores it); a distributed one factors across the ranks of ``group``,
    every rank holding the same K.  ``island_dtype``: optional precision
    island (e.g. torch.float64) for the dense path — K is cast up before
    factorization and ``solve`` casts solutions back to the rhs dtype."""
    if island_dtype is not None and structure is None:
        K = K.to(island_dtype)
    if _sparse(structure, mode):
        sn, spread = _supernodal(structure)
        fn = sn.factor_llt if mode == KKT_SOLVER_LLT else sn.factor_ldlt
        if spread:
            if group is None:
                raise ValueError(
                    f"{type(structure).__name__} requires axis_name (a process group)")
            fac, fail = fn(K, structure, group)
        else:
            fac, fail = fn(K, structure)
        return KKTFactor(matrix=K, factor=fac, fail=fail)
    if mode == KKT_SOLVER_LLT:
        L, fail = _cholesky(K)
    elif mode == KKT_SOLVER_LDLT:
        L, fail = _ldlt_clamped(K)
    elif mode == KKT_SOLVER_QR:
        # The JAX package's QR never reports a failure.
        L = tuple(torch.linalg.qr(K))
        fail = torch.zeros(K.shape[:-2], dtype=torch.bool, device=K.device)
    else:
        raise ValueError(f"unknown kkt solver mode {mode}")
    return KKTFactor(matrix=K, factor=L, fail=fail)


def _solve_llt(L, b):
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-2, -1), y, upper=True)[..., 0]


def _solve_ldlt(M, b):
    L = torch.tril(M, -1)
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False,
                                      unitriangular=True)
    y = y / d[..., None]
    return torch.linalg.solve_triangular(L.transpose(-2, -1), y, upper=True,
                                         unitriangular=True)[..., 0]


def _solve_qr(qr, b):
    # Least squares for rank-deficient KKT systems, reusing the
    # decomposition of factor() (reference kkt_solver.cc:174-177, 227-231).
    q, r = qr
    qtb = q.transpose(-2, -1) @ b[..., None]
    return torch.linalg.solve_triangular(r, qtb, upper=True)[..., 0]


_SOLVES = {KKT_SOLVER_LLT: _solve_llt, KKT_SOLVER_LDLT: _solve_ldlt,
           KKT_SOLVER_QR: _solve_qr}


def _residual_product(matrix, structure, x):
    """K x for refinement: from the compressed buffer, or the dense K."""
    from ..supernodal import compressed, dist_compressed

    if isinstance(structure, dist_compressed.DistributedCompressedStructure):
        structure = structure.base
    if isinstance(structure, compressed.CompressedSupernodalStructure):
        return compressed.matvec(matrix, structure, x)
    return (matrix @ x[..., None])[..., 0]


@spanned("conex.kkt_solve")
def solve(f: KKTFactor, b, mode: int, refinement_steps: int = 0,
          structure=None, group=None):
    """Solve K x = b per scenario, with optional iterative refinement;
    ``structure`` and ``group`` as given to ``factor``.

    reference: SolveInPlace + refinement loop, kkt_solver.cc:220-263.
    """
    if mode not in _SOLVES:
        raise ValueError(f"unknown kkt solver mode {mode}")
    out_dtype = b.dtype
    if _sparse(structure, mode):
        sn, spread = _supernodal(structure)
        fn = sn.solve_llt if mode == KKT_SOLVER_LLT else sn.solve_ldlt
        extra = (group,) if spread else ()

        def base_solve(fac, rhs):
            return fn(fac, structure, rhs, *extra)
    else:
        base_solve = _SOLVES[mode]
        if structure is None and f.matrix.dtype != b.dtype:
            b = b.to(f.matrix.dtype)

    x = base_solve(f.factor, b)
    for _ in range(refinement_steps):
        r = b - _residual_product(f.matrix, structure, x)
        x = x + base_solve(f.factor, r)
    return x.to(out_dtype)

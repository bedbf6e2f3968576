"""Supernodal block Cholesky / clamped LDLT over a clique tree, batched.

Twin of ``conex_tpu/supernodal/solver.py``.  The clique ordering and
fill-in are computed once on the host (ordering.py); the resulting static
supernode/separator index sets drive a Python loop of dense block
operations over the elimination order, on the (S, N, N) KKT matrices of S
scenarios at once.  Each scenario sets its own fail flag.

The reference's fully pivoted RLDLT is replaced by a fixed-order LDLT with
the same +/-1e-9 pivot clamp (RLDLT.h:381-393), as in the dense path of
solver/kkt.py, whose column loop each block runs: the clamp decisions are
part of the result.  Iterative refinement (kkt_solver.cc:248-263)
compensates, as in the reference.

The per-clique step (``factor_step``, ``forward_step``, ``backward_step``)
is shared with scan.py and compressed.py, which run it on padded index
sets and, in compressed.py, on per-clique blocks read from a flat buffer.
"""

from __future__ import annotations

import functools
import sys
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from ..solver import kkt
from .ordering import pick_clique_order


class SupernodalStructure(NamedTuple):
    """Static elimination structure: per clique (in elimination order) its
    supernode and separator variable index tuples.  Hashable."""

    blocks: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    n: int  # KKT dimension

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     valid_leaf=None, root: int = -1):
        co = pick_clique_order(cliques, valid_leaf=valid_leaf, root=root)
        blocks = []
        for e in co.order:
            s = tuple(co.supernodes[e])
            p = tuple(co.separators[e])
            if s:
                blocks.append((s, p))
        covered = {v for s, _ in blocks for v in s}
        # Variables not covered by any clique (shouldn't happen for
        # well-formed programs) get their own trailing supernode.
        rest = tuple(v for v in range(n) if v not in covered)
        if rest:
            blocks.append((rest, ()))
        return SupernodalStructure(blocks=tuple(blocks), n=n)


@functools.lru_cache(maxsize=None)
def index_tensors(index_sets: Tuple[Tuple[int, ...], ...], device):
    """One int64 tensor on ``device`` per index tuple, made once per
    structure and device (no host-to-device copy inside the loops)."""
    return tuple(torch.as_tensor(np.asarray(ix, np.int64).reshape(-1), device=device)
                 for ix in index_sets)


def _gather(G, r, c):
    """G[:, r, c] for index tensors r, c: an (S, len(r), len(c)) copy."""
    return G[:, r[:, None], c[None, :]]


def _t(X):
    return X.transpose(-2, -1)


# ---------------------------------------------------------------------------
# The per-clique step, shared by the three structures
# ---------------------------------------------------------------------------


def llt_block(D, O):
    """One supernode of the block Cholesky (reference BlockCholeskyInPlace,
    block_triangular_operations.cc:184-219): D = L L^T, B = L^-1 O with O
    the supernode x separator block, and the separator's Schur update
    U = -(B^T B).  Returns (L, B, U, fail)."""
    L, fail = kkt._cholesky(D)
    B = torch.linalg.solve_triangular(L, O, upper=False)
    fail = fail | ~torch.isfinite(B).all(dim=(-2, -1))
    return L, B, -(_t(B) @ B), fail


def ldlt_block(D, O):
    """One supernode of the clamped LDLT (reference BlockLDLTInPlace,
    block_triangular_operations.cc:315-349): D = Lu diag(d) Lu^T by the
    dense path's column loop, C = O^T Lu^-T / d (the separator x supernode
    block of L) and the Schur update U = -(C d) C^T.  Returns
    (Lu, d, C, U, fail)."""
    M, _ = kkt._ldlt_scalar(D)
    k = D.shape[-1]
    Lu = torch.tril(M, -1) + torch.eye(k, dtype=D.dtype, device=D.device)
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    tmp = _t(torch.linalg.solve_triangular(Lu, O, upper=False, unitriangular=True))
    C = tmp / d[:, None, :]
    U = -(C * d[:, None, :]) @ _t(C)
    fail = ~(torch.isfinite(Lu).all(dim=(-2, -1)) & torch.isfinite(d).all(dim=-1)
             & torch.isfinite(C).all(dim=(-2, -1)))
    return Lu, d, C, U, fail


def factor_step(G, si, pi, mode):
    """Factor the supernode si (separator pi) of the (S, n, n) G in place:
    read its blocks, factor them, subtract the Schur update from G[pi, pi].
    The LLT reads G[si, pi], the LDLT G[pi, si]^T, as the JAX package does.
    Returns (factor tuple, fail)."""
    D = _gather(G, si, si)
    if mode == KKT_SOLVER_LLT:
        L, B, U, fail = llt_block(D, _gather(G, si, pi))
        fac = (L, B)
    else:
        Lu, d, C, U, fail = ldlt_block(D, _t(_gather(G, pi, si)))
        fac = (Lu, d, C)
    if pi.numel():
        G[:, pi[:, None], pi[None, :]] += U
    return fac, fail


def _trsv(L, z, **kw):
    return torch.linalg.solve_triangular(L, z[..., None], **kw)[..., 0]


def _matvec(M, x):
    return (M @ x[..., None])[..., 0]


def forward_step(z, si, pi, fac, mode):
    """Forward substitution through one supernode, z (S, n) in place
    (reference ApplyBlockInverseInPlace, block_triangular_operations.cc:
    114-147)."""
    if mode == KKT_SOLVER_LLT:
        L, B = fac
        zs = _trsv(L, z[:, si], upper=False)
        off = _t(B)
    else:
        Lu, _, C = fac
        zs = _trsv(Lu, z[:, si], upper=False, unitriangular=True)
        off = C
    z[:, si] = zs
    if pi.numel():
        z[:, pi] -= _matvec(off, zs)


def scale_step(z, si, fac):
    """The LDLT's diagonal scale of one supernode, z (S, n) in place."""
    z[:, si] = z[:, si] / fac[1]


def backward_step(z, si, pi, fac, mode):
    """Back substitution through one supernode, z (S, n) in place
    (reference ApplyBlockInverseOfTransposeInPlace,
    block_triangular_operations.cc:149-182)."""
    rhs = z[:, si]
    if mode == KKT_SOLVER_LLT:
        L, B = fac
        if pi.numel():
            rhs = rhs - _matvec(B, z[:, pi])
        z[:, si] = _trsv(_t(L), rhs, upper=True)
    else:
        Lu, _, C = fac
        if pi.numel():
            rhs = rhs - _matvec(_t(C), z[:, pi])
        z[:, si] = _trsv(_t(Lu), rhs, upper=True, unitriangular=True)


def substitute(z, steps, facs, mode):
    """Solve with the factors ``facs`` of the supernodes ``steps``
    ((si, pi) pairs in elimination order), z (S, n) in place."""
    for (si, pi), fac in zip(steps, facs):
        forward_step(z, si, pi, fac, mode)
    if mode != KKT_SOLVER_LLT:
        for (si, _), fac in zip(steps, facs):
            scale_step(z, si, fac)
    for (si, pi), fac in zip(reversed(steps), reversed(facs)):
        backward_step(z, si, pi, fac, mode)
    return z


# ---------------------------------------------------------------------------
# The unrolled structure: one step per clique at its own size
# ---------------------------------------------------------------------------


def _steps(structure: SupernodalStructure, device):
    t = index_tensors(tuple(ix for s, p in structure.blocks for ix in (s, p)), device)
    return list(zip(t[0::2], t[1::2]))


def _factor(G, structure, mode):
    G = G.clone()
    facs = []
    fail = torch.zeros(G.shape[0], dtype=torch.bool, device=G.device)
    for si, pi in _steps(structure, G.device):
        fac, f = factor_step(G, si, pi, mode)
        facs.append(fac)
        fail = fail | f
    # The JAX package's layout: a tuple per factor part, a clique each.
    return tuple(zip(*facs)), fail


def factor_llt(G, structure: SupernodalStructure):
    """Supernodal block Cholesky of the (S, N, N) G: ((Ls, Bs), fail (S,)),
    Ls and Bs tuples of one (S, ...) tensor per clique."""
    return _factor(G, structure, KKT_SOLVER_LLT)


def factor_ldlt(G, structure: SupernodalStructure):
    """Supernodal clamped LDLT of the (S, N, N) G: ((Ls, ds, Cs),
    fail (S,))."""
    return _factor(G, structure, KKT_SOLVER_LDLT)


def solve_llt(fac, structure: SupernodalStructure, b):
    """Forward/backward block substitution for the (S, N) b."""
    return substitute(b.clone(), _steps(structure, b.device), list(zip(*fac)),
                      KKT_SOLVER_LLT)


def solve_ldlt(fac, structure: SupernodalStructure, b):
    return substitute(b.clone(), _steps(structure, b.device), list(zip(*fac)),
                      KKT_SOLVER_LDLT)


class SupernodalKKTSolver:
    """Standalone host-facing wrapper (reference SupernodalKKTSolver,
    kkt_solver.h:16-65): analyze once, then factor/solve dense KKT matrices
    restricted to the clique-tree pattern.  Takes numpy arrays or tensors,
    (N, N) and (N,) or with a leading scenario axis, and runs on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cliques: Sequence[Sequence[int]], n: int,
                 mode: str = "llt", scan: bool = False, device="cuda"):
        self.structure = SupernodalStructure.from_cliques(cliques, n)
        self.mode = mode
        self.device = torch.device(device)
        impl = sys.modules[__name__]
        if scan:
            from . import scan as impl

            self.structure = impl.ScanSupernodalStructure.from_structure(
                self.structure
            )
        if mode == "llt":
            self._factor, self._solve = impl.factor_llt, impl.solve_llt
        else:
            self._factor, self._solve = impl.factor_ldlt, impl.solve_ldlt
        self._fac = None

    def _tensor(self, x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float64)
        return torch.as_tensor(x, device=self.device)

    def factor(self, G) -> bool:
        """True when every scenario factored."""
        G = self._tensor(G)
        self._batched = G.dim() == 3
        self._fac, fail = self._factor(G if self._batched else G[None],
                                       self.structure)
        return not bool(fail.any())

    def solve(self, b):
        b = self._tensor(b)
        x = self._solve(self._fac, self.structure, b if self._batched else b[None])
        x = x.cpu().numpy()
        return x if self._batched else x[0]

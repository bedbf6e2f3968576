"""The supernodal factorization on padded per-clique shapes, batched.

Twin of ``conex_tpu/supernodal/scan.py``.  The JAX package compiles the
elimination (reference BlockCholeskyInPlace / BlockLDLTInPlace,
block_triangular_operations.cc:184-219, 315-349) as one ``lax.scan`` so
that its compile time does not grow with the number of cliques.  Here
there is no compile step: the scan is a Python loop over the K cliques
that runs solver.py's per-clique step, and what carries over is the
static shapes:

- every supernode is padded to the largest supernode size ``smax`` and
  every separator to ``pmax``;
- padded index slots point into a dummy identity block appended to the
  backing matrix (rows/cols N..N+pad-1), so the padded diagonal block is
  ``blockdiag(D, I)``: its Cholesky/LDLT is exact and the padded rows of
  the off-diagonal block are zero, making all padded Schur/solve
  contributions exactly zero;
- so every step does the same work on the same shapes (what a CUDA graph
  could capture), and the factors stack into (S, K, smax, ...) tensors,
  as the scan's outputs do.

Pivot semantics match the reference RLDLT clamp (RLDLT.h:381-393) via
solver/kkt.py's column loop, as in solver.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from .solver import SupernodalStructure, factor_step, substitute


class ScanSupernodalStructure(NamedTuple):
    """Static, hashable elimination structure for the padded path: the
    same (supernode, separator) tuples as SupernodalStructure."""

    blocks: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    n: int

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     valid_leaf=None, root: int = -1):
        base = SupernodalStructure.from_cliques(
            cliques, n, valid_leaf=valid_leaf, root=root
        )
        return ScanSupernodalStructure(blocks=base.blocks, n=base.n)

    @staticmethod
    def from_structure(s: SupernodalStructure):
        return ScanSupernodalStructure(blocks=s.blocks, n=s.n)

    @property
    def smax(self) -> int:
        return max((len(s) for s, _ in self.blocks), default=1)

    @property
    def pmax(self) -> int:
        return max((len(p) for _, p in self.blocks), default=0)

    def padded_indices(self):
        """(s_idx[K, smax], p_idx[K, pmax], n_ext) int32 numpy arrays.

        Padded slots are distinct dummy indices so gathered padding blocks
        are exactly the identity (a repeated dummy index would gather a
        singular all-ones block).  Supernode padding uses slots
        n..n+smax-1 and separator padding the DISJOINT slots
        n+smax..n+smax+pmax-1 — otherwise G[s_pad, p_pad] would gather a
        dummy diagonal 1 and the Schur update would corrupt it.
        """
        smax, pmax = self.smax, self.pmax
        K = len(self.blocks)
        s_idx = np.zeros((K, smax), np.int32)
        p_idx = np.zeros((K, max(pmax, 1)), np.int32)
        for k, (s, p) in enumerate(self.blocks):
            s_idx[k, : len(s)] = s
            s_idx[k, len(s):] = self.n + np.arange(smax - len(s))
            p_idx[k, : len(p)] = p
            p_idx[k, len(p):] = (
                self.n + smax + np.arange(p_idx.shape[1] - len(p))
            )
        return s_idx, p_idx, self.n + smax + max(pmax, 1)


@functools.lru_cache(maxsize=None)
def padded_steps(structure: ScanSupernodalStructure, device):
    """[(s_idx[k], p_idx[k]) int64 tensors on ``device``], n_ext."""
    s_idx, p_idx, n_ext = structure.padded_indices()
    s = torch.as_tensor(s_idx.astype(np.int64), device=device)
    p = torch.as_tensor(p_idx.astype(np.int64), device=device)
    return list(zip(s, p)), n_ext


def _extend(G, structure: ScanSupernodalStructure, n_ext: int):
    """Embed the (S, n, n) G into the (S, n_ext, n_ext) backing with an
    identity dummy block."""
    n = structure.n
    Gext = G.new_zeros((G.shape[0], n_ext, n_ext))
    Gext[:, :n, :n] = G
    r = torch.arange(n, n_ext, device=G.device)
    Gext[:, r, r] = 1.0
    return Gext


def _factor(G, structure, mode):
    steps, n_ext = padded_steps(structure, G.device)
    Gc = _extend(G, structure, n_ext)
    facs = []
    fail = torch.zeros(G.shape[0], dtype=torch.bool, device=G.device)
    for si, pi in steps:
        fac, f = factor_step(Gc, si, pi, mode)
        facs.append(fac)
        fail = fail | f
    return tuple(torch.stack(parts, dim=1) for parts in zip(*facs)), fail


def factor_llt(G, structure: ScanSupernodalStructure):
    """Supernodal block Cholesky of the (S, N, N) G on padded shapes:
    ((Ls (S, K, smax, smax), Bs (S, K, smax, pmax)), fail (S,))."""
    return _factor(G, structure, KKT_SOLVER_LLT)


def factor_ldlt(G, structure: ScanSupernodalStructure):
    """Supernodal clamped LDLT on padded shapes: ((Ls, ds (S, K, smax),
    Cs (S, K, pmax, smax)), fail (S,))."""
    return _factor(G, structure, KKT_SOLVER_LDLT)


def padded_solve(fac, steps, n_ext, n, b, mode):
    """Solve with stacked per-clique factors on the padded index sets:
    b (S, n) into the extended vector, substitution, and back."""
    z = b.new_zeros((b.shape[0], n_ext))
    z[:, :n] = b
    facs = [tuple(f[:, k] for f in fac) for k in range(len(steps))]
    return substitute(z, steps, facs, mode)[:, :n]


def solve_llt(fac, structure: ScanSupernodalStructure, b):
    """Forward/backward block substitution for the (S, N) b (reference
    ApplyBlockInverseInPlace / ...OfTransposeInPlace,
    block_triangular_operations.cc:114-182)."""
    steps, n_ext = padded_steps(structure, b.device)
    return padded_solve(fac, steps, n_ext, structure.n, b, KKT_SOLVER_LLT)


def solve_ldlt(fac, structure: ScanSupernodalStructure, b):
    steps, n_ext = padded_steps(structure, b.device)
    return padded_solve(fac, steps, n_ext, structure.n, b, KKT_SOLVER_LDLT)

"""SeDuMi-format presolve: row cleanup, free-variable elimination,
block-diagonal decomposition of sparse PSD cones.

A copy of ``conex_tpu/preprocess.py`` (numpy only), kept equal to it by
tests/test_torch_frontends.py: the port cannot import that module, since
importing anything under ``conex_tpu`` imports jax.

Python equivalents of the reference's MATLAB preprocessing utilities
(interfaces/matlab/util/):

- ``clean_linear``       — CleanLinear.m (zero / linearly-dependent row
  removal with a dual-recovery map T),
- ``eliminate_free_vars``— EliminateFreeVars.m (project the dual onto the
  affine set c_f - A_f' y = 0: y = y0 + B z with B an orthonormal null
  basis of A_f'),
- ``blkdiag_decompose``  — blkdiagPrg.m + BuildMask.m +
  BinaryPsdCompletion.m (aggregate-sparsity mask propagation, then one PSD
  block per connected component of each s-block's mask),
- ``SedumiPresolve``     — ConexPreprocess.m (the composition, with primal
  and dual recovery).

These run once on the host (numpy) before the solve; the decomposition
turns one big sparse LMI into many small dense ones, which is exactly the
batched-cone shape the solver wants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def clean_linear(A, b, use_qr: bool = False):
    """Drop redundant equality rows; returns (A_red, b_red, T) with
    ``y_original = T @ y_reduced``.

    Default mode drops all-zero rows of [A, b]; ``use_qr`` drops linearly
    dependent rows (first-nonzero structure of the R factor of [A, b]').
    reference: CleanLinear.m:1-30.
    """
    A = np.atleast_2d(np.asarray(A, float))
    b = np.asarray(b, float).reshape(-1)
    if A.shape[0] != b.shape[0]:
        raise ValueError("Number of rows of A and b do not match.")
    Ab = np.concatenate([A, b[:, None]], axis=1)
    if use_qr:
        R = np.linalg.qr(Ab.T, mode="r")
        keep = []
        tol = max(Ab.shape) * np.finfo(float).eps * (
            np.abs(R).max() if R.size else 1.0
        )
        seen_rows = set()
        # First sufficiently-nonzero entry on each row of R marks an
        # independent column of Ab' (= row of [A, b]).
        for i in range(R.shape[0]):
            nz = np.flatnonzero(np.abs(R[i]) > tol)
            if nz.size and i not in seen_rows:
                keep.append(int(nz[0]))
                seen_rows.add(i)
        keep = sorted(set(keep))
    else:
        keep = [int(i) for i in np.flatnonzero(np.abs(Ab).sum(axis=1) > 0)]
    T = np.zeros((A.shape[0], len(keep)))
    for j, i in enumerate(keep):
        T[i, j] = 1.0
    return A[keep], b[keep], T


def _null_basis(M, rcond=None):
    """Orthonormal basis of the null space of M (SVD)."""
    M = np.atleast_2d(M)
    u, s, vh = np.linalg.svd(M, full_matrices=True)
    if rcond is None:
        rcond = max(M.shape) * np.finfo(float).eps
    tol = (s.max() if s.size else 0.0) * rcond
    rank = int((s > tol).sum())
    return vh[rank:].T.conj()


def eliminate_free_vars(A, b, c, K: Dict):
    """Eliminate the K['f'] leading free variables from the SeDuMi pair.

    The free block contributes the affine condition c_f - A_f' y = 0 to
    the dual; substituting y = y0 + B z (y0 a particular solution, B an
    orthonormal null basis of A_f') gives the reduced pair

        A_r = B' A_rest,  b_r = B' b,  c_r = c_rest - A_rest' y0.

    Returns (A_r, b_r, c_r, K_r, B, y0).  reference: EliminateFreeVars.m.
    """
    A = np.atleast_2d(np.asarray(A, float))
    b = np.asarray(b, float).reshape(-1)
    c = np.asarray(c, float).reshape(-1)
    f = int(K.get("f", 0) or 0)
    Af = A[:, :f].T  # f x m
    cf = c[:f]
    Arest = A[:, f:]
    crest = c[f:]
    y0 = np.linalg.lstsq(Af, cf, rcond=None)[0]
    B = _null_basis(Af)
    c_r = crest - Arest.T @ y0
    A_r = B.T @ Arest
    b_r = B.T @ b
    K_r = dict(K)
    K_r["f"] = 0
    return A_r, b_r, c_r, K_r, B, y0


def _cone_offsets(K: Dict):
    nf = int(K.get("f", 0) or 0)
    nl = int(K.get("l", 0) or 0)
    qs = [int(q) for q in (K.get("q", []) or [])]
    ss = [int(s) for s in (K.get("s", []) or [])]
    return nf, nl, qs, ss


def _mask_closure(M, A, b):
    """Propagate the coordinate mask through the subspace {Ax = b}.

    reference: SubspaceClosureCoordDisjointSupport (BuildMask.m:58-85):
    start from the coordinates that MUST carry signal (support of c, plus
    every row with b != 0), then iterate "rows touching the mask
    contribute their whole support" to a fixed point.  Conservative
    (support-disjointness, not numeric rank), but fast.
    """
    M = M.copy()
    nzb = np.abs(b) > 0
    if nzb.any():
        M |= (np.abs(A[nzb]) > 0).any(axis=0)
    nnz = M.sum()
    while True:
        tau = (np.abs(A[:, M]) > 0).any(axis=1)
        M = (np.abs(A[tau]) > 0).any(axis=0) if tau.any() else M
        if M.sum() == nnz:
            return M
        nnz = M.sum()


def _psd_completion(Mblk):
    """Connected components of one PSD block's mask; fills each component's
    clique block.  Returns (filled mask, cliques sorted by size ascending).
    reference: BinaryPsdCompletion.m."""
    n = Mblk.shape[0]
    touched = np.flatnonzero(Mblk.any(axis=1) | Mblk.any(axis=0))
    if touched.size == 0:
        return Mblk, []
    Adj = Mblk[np.ix_(touched, touched)] | Mblk[np.ix_(touched, touched)].T
    np.fill_diagonal(Adj, False)
    k = touched.size
    comp = -np.ones(k, int)
    cliques = []
    for start in range(k):
        if comp[start] >= 0:
            continue
        stack = [start]
        comp[start] = len(cliques)
        members = [start]
        while stack:
            u = stack.pop()
            for v in np.flatnonzero(Adj[u]):
                if comp[v] < 0:
                    comp[v] = comp[start]
                    stack.append(int(v))
                    members.append(int(v))
        cliques.append(sorted(int(touched[i]) for i in members))
    cliques.sort(key=len)
    Mout = Mblk.copy()
    for cl in cliques:
        Mout[np.ix_(cl, cl)] = True
    return Mout, cliques


@dataclasses.dataclass
class BlkdiagReduction:
    """Reduced SeDuMi triple + recovery data (reference blkdiagPrg)."""

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    K: Dict
    indx: np.ndarray  # selected original coordinates (column gather)
    T: np.ndarray  # dual-recovery row map (y_orig = T @ y_red)
    n_orig: int

    def recover_primal(self, x_red):
        x = np.zeros(self.n_orig)
        x[self.indx] = np.asarray(x_red).reshape(-1)
        return x

    def recover_dual(self, y_red):
        return self.T @ np.asarray(y_red).reshape(-1)


def blkdiag_decompose(A, b, c, K: Dict) -> BlkdiagReduction:
    """Split sparse PSD cones into block-diagonal sub-cones.

    Builds the aggregate-sparsity mask (c support + rows carrying b),
    closes it under the constraint subspace, and replaces each s-block by
    one PSD cone per connected component of its mask; coordinates outside
    the mask are dropped (recovered as 0).  reference: BuildMask.m +
    blkdiagPrg.m.  Lorentz cones are not decomposed (kept whole), matching
    the reference's scope (conex.m rejects them up front).
    """
    A = np.atleast_2d(np.asarray(A, float))
    b = np.asarray(b, float).reshape(-1)
    c = np.asarray(c, float).reshape(-1)
    nf, nl, qs, ss = _cone_offsets(K)
    if qs:
        raise ValueError(
            "blkdiag decomposition does not support Lorentz cones"
        )
    n = A.shape[1]

    # Symmetrize s-block data so the mask sees symmetric support.
    def symmetrize(v):
        v = v.copy()
        off = nf + nl
        for s in ss:
            blk = v[off:off + s * s].reshape(s, s)
            v[off:off + s * s] = (0.5 * (blk + blk.T)).reshape(-1)
            off += s * s
        return v

    c = symmetrize(c)
    A = np.stack([symmetrize(row) for row in A]) if A.size else A

    M = np.abs(c) > 0
    nnz = M.sum()
    cliques_per_block: List[List[List[int]]] = [[] for _ in ss]
    while True:
        M = _mask_closure(M, A, b)
        off = nf + nl
        for i, s in enumerate(ss):
            Mblk = M[off:off + s * s].reshape(s, s)
            Mblk, cliques = _psd_completion(Mblk)
            M[off:off + s * s] = Mblk.reshape(-1)
            cliques_per_block[i] = cliques
            off += s * s
        if M.sum() == nnz:
            break
        nnz = M.sum()

    indx = list(np.flatnonzero(M[:nf]))
    new_f = len(indx)
    indx += [nf + int(i) for i in np.flatnonzero(M[nf:nf + nl])]
    new_l = len(indx) - new_f
    new_s = []
    off = nf + nl
    for i, s in enumerate(ss):
        for cl in cliques_per_block[i]:
            for r in cl:
                for col in cl:
                    indx.append(off + r * s + col)
            new_s.append(len(cl))
        off += s * s
    indx = np.asarray(indx, int)

    A_r = A[:, indx]
    c_r = c[indx]
    A_r, b_r, T = clean_linear(A_r, b)
    K_r = dict(f=new_f, l=new_l, q=[], s=new_s)
    return BlkdiagReduction(
        A=A_r, b=b_r, c=c_r, K=K_r, indx=indx, T=T, n_orig=n
    )


@dataclasses.dataclass
class SedumiPresolve:
    """Free-variable elimination + block-diagonal decomposition with full
    primal/dual recovery (reference ConexPreprocess.m)."""

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    K: Dict
    _A_orig: np.ndarray
    _b_orig: np.ndarray
    _num_free: int
    _B: Optional[np.ndarray]
    _y0: Optional[np.ndarray]
    _red: BlkdiagReduction

    @staticmethod
    def build(A, b, c, K: Dict) -> "SedumiPresolve":
        A = np.atleast_2d(np.asarray(A, float))
        b = np.asarray(b, float).reshape(-1)
        c = np.asarray(c, float).reshape(-1)
        A_orig, b_orig = A, b
        num_free = int(K.get("f", 0) or 0)
        B = y0 = None
        if num_free:
            A, b, c, K, B, y0 = eliminate_free_vars(A, b, c, K)
        red = blkdiag_decompose(A, b, c, K)
        return SedumiPresolve(
            A=red.A, b=red.b, c=red.c, K=red.K,
            _A_orig=A_orig, _b_orig=b_orig, _num_free=num_free,
            _B=B, _y0=y0, _red=red,
        )

    def recover(self, x_red, y_red) -> Tuple[np.ndarray, np.ndarray]:
        """Map the reduced solution back to the original coordinates.

        reference: ConexPostProcess (ConexPreprocess.m:34-56): scatter the
        block-diagonal primal, un-reduce the dual through T then (for free
        variables) y = y0 + B z; free primal variables solve
        A_f x_f = b - A_rest x_rest in least squares.
        """
        x = self._red.recover_primal(x_red)
        y = self._red.recover_dual(y_red)
        if self._num_free:
            nf = self._num_free
            xf = np.linalg.lstsq(
                self._A_orig[:, :nf],
                self._b_orig - self._A_orig[:, nf:] @ x,
                rcond=None,
            )[0]
            x = np.concatenate([xf, x])
            y = self._y0 + self._B @ y
        return x, y

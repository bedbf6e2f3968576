"""Block-compressed supernodal storage: O(sum of block sizes) memory, batched.

Twin of ``conex_tpu/supernodal/compressed.py``.  The reference stores the
Cholesky factor as per-clique dense blocks in one contiguous buffer — a
supernode x supernode ``diagonal`` and a supernode x separator
``off_diagonal`` per clique — with the separator x separator Schur updates
scattered into *other* cliques' storage through precomputed pointers
(triangular_matrix_workspace.cc:123-159, supernodal_solver.h:64-106,
block_triangular_operations.cc:184-219).

Here the storage is one (S, buf_size) tensor, a row per scenario, holding
the padded per-clique blocks

    buf = [ D_0 .. D_{K-1} | O_0 .. O_{K-1} | dump ]

with D_k: (smax, smax) supernode diagonal and O_k: (smax, pmax) supernode x
separator blocks (padded slots stay zero).  The reference's pointer scatter
becomes a host-precomputed index map per clique: entry (i, j) of clique k's
separator Schur update lands at a flat position inside an ancestor's D or O
block (or the dump slot for padding / the redundant mirrored orientation).
Assembly is the same mechanism: each cone block's dense Schur contribution
over its variable clique scatters through a per-block index map — the
compressed counterpart of SupernodalAssembler::Scatter
(supernodal_assembler.cc:103-111) — so the dense (N, N) KKT matrix is never
built.  Every scatter's real targets are distinct; only the dump slot
repeats, and nothing reads it, so an accumulating ``index_add_`` gives the
same bits on every run.

The factorization and the solves run solver.py's per-clique step on the
padded shapes of scan.py, reading each clique's blocks from the buffer.
Pivot semantics match the reference RLDLT clamp (RLDLT.h:381-393).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from .scan import ScanSupernodalStructure, padded_solve, padded_steps
from .solver import SupernodalStructure, ldlt_block, llt_block


class CompressedSupernodalStructure(NamedTuple):
    """Static, hashable elimination structure for the compressed path.

    Same (supernode, separator) block tuples as SupernodalStructure; all
    index maps are derived on the host and cached per structure.
    """

    blocks: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    n: int

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     valid_leaf=None, root: int = -1):
        base = SupernodalStructure.from_cliques(
            cliques, n, valid_leaf=valid_leaf, root=root
        )
        return CompressedSupernodalStructure(blocks=base.blocks, n=base.n)

    @staticmethod
    def from_structure(s: SupernodalStructure):
        return CompressedSupernodalStructure(blocks=s.blocks, n=s.n)

    @property
    def smax(self) -> int:
        return max((len(s) for s, _ in self.blocks), default=1)

    @property
    def pmax(self) -> int:
        return max((len(p) for _, p in self.blocks), default=0)

    # -- flat buffer layout -------------------------------------------------

    @property
    def d_size(self) -> int:
        return len(self.blocks) * self.smax * self.smax

    @property
    def o_size(self) -> int:
        return len(self.blocks) * self.smax * max(self.pmax, 1)

    @property
    def buf_size(self) -> int:
        """Flat buffer length: D region + O region + one dump slot."""
        return self.d_size + self.o_size + 1

    @property
    def dump(self) -> int:
        return self.buf_size - 1

    def d_pos(self, k: int, i: int, j: int) -> int:
        return (k * self.smax + i) * self.smax + j

    def o_pos(self, k: int, i: int, j: int) -> int:
        return self.d_size + (k * self.smax + i) * max(self.pmax, 1) + j


# ---------------------------------------------------------------------------
# Host-side index-map construction (cached per structure)
# ---------------------------------------------------------------------------


class _Layout(NamedTuple):
    """The buffer layout's numbers, computed once (each property of the
    structure walks every block)."""

    smax: int
    pmax: int  # at least 1
    d_size: int
    dump: int

    def d_pos(self, k: int, i: int, j: int) -> int:
        return (k * self.smax + i) * self.smax + j

    def o_pos(self, k: int, i: int, j: int) -> int:
        return self.d_size + (k * self.smax + i) * self.pmax + j


@functools.lru_cache(maxsize=None)
def _maps(structure: CompressedSupernodalStructure):
    """Ownership and position maps, and the layout.

    owner[v]   — elimination-order index of the clique whose supernode holds v
    sn_pos[v]  — v's position within that supernode
    sep_pos[k] — {var: position in separator(k)}
    """
    n = structure.n
    owner = np.full(n, -1, np.int64)
    sn_pos = np.full(n, -1, np.int64)
    sep_pos = []
    for k, (s, p) in enumerate(structure.blocks):
        for i, v in enumerate(s):
            owner[v] = k
            sn_pos[v] = i
        sep_pos.append({v: i for i, v in enumerate(p)})
    layout = _Layout(structure.smax, max(structure.pmax, 1), structure.d_size,
                     structure.dump)
    return owner, sn_pos, tuple(sep_pos), layout


def _pair_target(layout, owner, sn_pos, sep_pos, row: int, col: int) -> int:
    """Flat position of KKT entry (row, col), or the dump slot.

    Each unordered pair {row, col} is stored exactly once unless both
    variables share a supernode (then both orientations live in the D
    block, which is kept full-symmetric so the block Cholesky can consume
    it directly).  The cross-supernode orientation with ``col`` eliminated
    first lives in owner(col)'s off-diagonal block at (sn_pos(col),
    sep_pos(row)) — the compressed equivalent of the reference's
    seperator_diagonal pointers (triangular_matrix_workspace.cc:149-159);
    the mirrored orientation dumps.
    """
    tr, tc = owner[row], owner[col]
    if tr < 0 or tc < 0:
        return layout.dump
    if tr == tc:
        return layout.d_pos(int(tc), int(sn_pos[row]), int(sn_pos[col]))
    if tc < tr:
        j = sep_pos[tc].get(row)
        if j is None:
            raise ValueError(
                f"entry ({row},{col}) outside the clique-tree fill pattern"
            )
        return layout.o_pos(int(tc), int(sn_pos[col]), int(j))
    return layout.dump


@functools.lru_cache(maxsize=None)
def _update_map(structure: CompressedSupernodalStructure):
    """(K, pmax, pmax) int64: flat targets of each clique's separator
    Schur-update entries (dump for padding and mirrored orientations)."""
    owner, sn_pos, sep_pos, layout = _maps(structure)
    K = len(structure.blocks)
    out = np.full((K, layout.pmax, layout.pmax), layout.dump, np.int64)
    for k, (_, p) in enumerate(structure.blocks):
        for i, a in enumerate(p):
            for j, b in enumerate(p):
                out[k, i, j] = _pair_target(layout, owner, sn_pos, sep_pos, a, b)
    return out


@functools.lru_cache(maxsize=None)
def assembly_map(structure: CompressedSupernodalStructure,
                 rows: Tuple[int, ...], cols: Tuple[int, ...]):
    """(len(rows), len(cols)) int64 flat targets for scattering a dense
    contribution over KKT rows x cols into the compressed buffer.  The
    compressed counterpart of SupernodalAssembler block binding
    (supernodal_assembler.cc:72-111)."""
    owner, sn_pos, sep_pos, layout = _maps(structure)
    out = np.empty((len(rows), len(cols)), np.int64)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            out[i, j] = _pair_target(layout, owner, sn_pos, sep_pos, r, c)
    return out


@functools.lru_cache(maxsize=None)
def _padded_indices(structure: CompressedSupernodalStructure):
    """scan.py's solve-time gather indices (padded supernode slots
    n..n+smax-1 and disjoint separator slots n+smax..), plus per-clique
    diagonal padding masks for the factor: (s_idx, p_idx, diag_pad,
    n_ext)."""
    s_idx, p_idx, n_ext = ScanSupernodalStructure(*structure).padded_indices()
    diag_pad = np.zeros(s_idx.shape, np.float64)
    for k, (s, _) in enumerate(structure.blocks):
        diag_pad[k, len(s):] = 1.0
    return s_idx, p_idx, diag_pad, n_ext


@functools.lru_cache(maxsize=None)
def _device_maps(structure: CompressedSupernodalStructure, device, dtype):
    """The maps of the factor and the solves on ``device``: scan.py's
    [(s_idx[k], p_idx[k])] and n_ext, the update map (K, pmax * pmax) and
    the padding identities (K, smax, smax) in ``dtype``."""
    steps, n_ext = padded_steps(ScanSupernodalStructure(*structure), device)
    _, _, diag_pad, _ = _padded_indices(structure)
    upd = torch.as_tensor(_update_map(structure).reshape(len(structure.blocks), -1),
                          device=device)
    pad = torch.diag_embed(torch.as_tensor(diag_pad, dtype=dtype, device=device))
    return steps, n_ext, upd, pad


@functools.lru_cache(maxsize=None)
def _assembly_index(structure, rows, cols, device):
    return torch.as_tensor(assembly_map(structure, rows, cols).reshape(-1),
                           device=device)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def empty_buffer(structure: CompressedSupernodalStructure, dtype, scenarios=1,
                 device=None):
    """A zero (scenarios, buf_size) buffer."""
    return torch.zeros((scenarios, structure.buf_size), dtype=dtype, device=device)


def scatter_contribution(buf, structure, vars_rows, vars_cols, value):
    """buf[:, map] += value for a dense (S, rows, cols) contribution over
    rows x cols, in place; returns buf."""
    idx = _assembly_index(structure, tuple(vars_rows), tuple(vars_cols), buf.device)
    return buf.index_add_(1, idx, value.reshape(value.shape[0], -1))


# ---------------------------------------------------------------------------
# Factorization (a loop over the elimination order on the buffer)
# ---------------------------------------------------------------------------


def _blocks(buf, structure):
    """(S, K, smax, smax) D and (S, K, smax, pmax) O views of buf."""
    S, K = buf.shape[0], len(structure.blocks)
    smax, pmax = structure.smax, max(structure.pmax, 1)
    D = buf[:, : structure.d_size].view(S, K, smax, smax)
    O = buf[:, structure.d_size: structure.d_size + structure.o_size]
    return D, O.view(S, K, smax, pmax)


def _factor(buf, structure, mode):
    bc = buf.clone()
    steps, _, upd, pad = _device_maps(structure, buf.device, buf.dtype)
    D_all, O_all = _blocks(bc, structure)
    S = buf.shape[0]
    facs = []
    fail = torch.zeros(S, dtype=torch.bool, device=buf.device)
    for k in range(len(steps)):
        D = D_all[:, k] + pad[k]
        if mode == KKT_SOLVER_LLT:
            L, B, U, f = llt_block(D, O_all[:, k])
            facs.append((L, B))
        else:
            Lu, d, C, U, f = ldlt_block(D, O_all[:, k])
            facs.append((Lu, d, C))
        bc.index_add_(1, upd[k], U.reshape(S, -1))
        fail = fail | f
    return tuple(torch.stack(parts, dim=1) for parts in zip(*facs)), fail


def factor_llt(buf, structure: CompressedSupernodalStructure):
    """Supernodal block Cholesky on compressed storage.

    reference: BlockCholeskyInPlace (block_triangular_operations.cc:184-219)
    — per supernode an in-place dense LLT, a triangular solve of the
    off-diagonal block, then the separator Schur update scattered through
    the ancestor-block map.
    """
    return _factor(buf, structure, KKT_SOLVER_LLT)


def factor_ldlt(buf, structure: CompressedSupernodalStructure):
    """Supernodal clamped LDLT on compressed storage (reference
    BlockLDLTInPlace, block_triangular_operations.cc:315-349)."""
    return _factor(buf, structure, KKT_SOLVER_LDLT)


def solve_llt(fac, structure: CompressedSupernodalStructure, b):
    """Forward/backward block substitution for the (S, N) b (reference
    ApplyBlockInverseInPlace / ...OfTransposeInPlace,
    block_triangular_operations.cc:114-182)."""
    steps, n_ext, _, _ = _device_maps(structure, b.device, b.dtype)
    return padded_solve(fac, steps, n_ext, structure.n, b, KKT_SOLVER_LLT)


def solve_ldlt(fac, structure: CompressedSupernodalStructure, b):
    steps, n_ext, _, _ = _device_maps(structure, b.device, b.dtype)
    return padded_solve(fac, steps, n_ext, structure.n, b, KKT_SOLVER_LDLT)


# ---------------------------------------------------------------------------
# Matvec (for iterative refinement) and densify (tests / QR fallback)
# ---------------------------------------------------------------------------


def matvec(buf, structure: CompressedSupernodalStructure, x):
    """K @ x from compressed storage for the (S, N) x (used by the
    refinement loop, reference kkt_solver.cc:248-261).  D blocks are
    full-symmetric; O blocks represent both orientations of their pairs."""
    steps, n_ext, _, _ = _device_maps(structure, buf.device, buf.dtype)
    D_all, O_all = _blocks(buf, structure)
    S, n = x.shape[0], structure.n
    xe = x.new_zeros((S, n_ext))
    xe[:, :n] = x
    ye = torch.zeros_like(xe)
    for k, (s, p) in enumerate(steps):
        D, O = D_all[:, k], O_all[:, k]
        xs = xe[:, s, None]
        xp = xe[:, p, None]
        ye[:, s] += (D @ xs + O @ xp)[..., 0]
        ye[:, p] += (O.transpose(-2, -1) @ xs)[..., 0]
    return ye[:, :n]


def compress_dense(G, structure: CompressedSupernodalStructure):
    """Pack the (S, N, N) dense clique-patterned matrices into the
    compressed buffer (test oracle / standalone-solver entry).  Only
    pattern entries are read: for each clique, the (supernode u separator)
    x supernode column block."""
    buf = empty_buffer(structure, G.dtype, G.shape[0], G.device)
    for s, p in structure.blocks:
        rows = tuple(s) + tuple(p)
        cols = tuple(s)
        ri = torch.as_tensor(rows, device=G.device)
        ci = torch.as_tensor(cols, device=G.device)
        scatter_contribution(buf, structure, rows, cols,
                             G[:, ri[:, None], ci[None, :]])
    buf[:, structure.dump] = 0.0
    return buf


def densify(buf, structure: CompressedSupernodalStructure):
    """Reconstruct the (S, N, N) dense KKT matrices (test oracle;
    reference KKTMatrix(), kkt_solver.cc:265-269): one matvec of every
    unit vector, the S x N products as one batch."""
    S, n = buf.shape[0], structure.n
    eye = torch.eye(n, dtype=buf.dtype, device=buf.device).repeat(S, 1)
    cols = matvec(buf.repeat_interleave(n, dim=0), structure, eye)
    return cols.view(S, n, n).transpose(-2, -1)

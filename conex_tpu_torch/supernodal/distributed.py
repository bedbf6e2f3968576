"""Distributed supernodal factorization: clique subtrees sharded over ranks.

Twin of ``conex_tpu/supernodal/distributed.py``, batched over the scenario
axis.  The reference factors the whole clique tree on one core
(BlockCholeskyInPlace, block_triangular_operations.cc:184-219).  Here the
clique tree is partitioned over the ranks of a process group:

- the tree is cut into a small upward-closed **root region** and the forest
  of subtrees hanging below it;
- subtrees are bin-packed onto the ranks by estimated factorization work;
  each rank eliminates its local cliques independently, with solver.py's
  per-clique step on scan.py's padded index sets;
- the Schur-complement contributions of every subtree land on the root
  separator set R (upward-closedness and the running-intersection property
  keep subtrees apart: a variable shared by two subtrees belongs to a
  root-region supernode, so subtrees couple ONLY through R);
- one sum all-reduce combines the R-block contributions, after which the
  (small) root system is factored on every rank alike;
- solves mirror this: local forward substitution, an all-reduce of the R
  residual contributions, the replicated root solve, local backward
  substitution, and a last all-reduce assembles the owner-masked solution.

Each rank holds the same assembled (S, n, n) KKT matrix.  Its index within
the group (its coordinate on the mesh axis, ``jax.lax.axis_index`` in the
JAX package) picks its cliques.  The host-side structure is a copy of the
JAX package's and comes out equal to it, tuple for tuple.  A rank's loop
runs over its own cliques only: the JAX package pads every rank to the
largest clique count with identity steps, which change nothing.

Pivot semantics for the LDLT variant match the reference RLDLT clamp
(RLDLT.h:381-393), as in solver.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from ..parallel.collectives import axis_index, axis_size, pany, psum
from . import scan
from .ordering import pick_clique_order
from .scan import ScanSupernodalStructure
from .solver import backward_step, factor_step, forward_step, scale_step

Block = Tuple[Tuple[int, ...], Tuple[int, ...]]


class DistributedSupernodalStructure(NamedTuple):
    """Static, hashable partitioned elimination structure.

    ``local_blocks[d]`` is rank d's (supernode, separator) sequence in
    elimination order (global variable numbering); ``root_blocks`` is the
    root region's sequence; ``r_vars`` the sorted root separator set R.
    """

    local_blocks: Tuple[Tuple[Block, ...], ...]
    root_blocks: Tuple[Block, ...]
    r_vars: Tuple[int, ...]
    n: int
    n_devices: int

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     n_devices: int, valid_leaf=None, root: int = -1):
        co = pick_clique_order(cliques, valid_leaf=valid_leaf, root=root)
        pos = {e: i for i, e in enumerate(co.order)}

        def work(e):
            s, p = len(co.supernodes[e]), len(co.separators[e])
            return s * (s + p) ** 2

        # Root region: start at the tree roots, then peel the top clique of
        # the heaviest remaining component until there is enough parallelism.
        # Upward-closed by construction (a peeled top's parent was already
        # in the region).
        root_set = {e for e in co.order if co.parent[e] == e}

        def components():
            # Group non-root cliques by their highest ancestor outside the
            # root region (parents precede children in -pos order).
            comp = {}
            top_of = {}
            for e in sorted(co.order, key=lambda e: -pos[e]):  # parents first
                if e in root_set:
                    continue
                p = co.parent[e]
                top_of[e] = e if p in root_set else top_of[p]
            for e, t in top_of.items():
                comp.setdefault(t, []).append(e)
            return comp

        total = sum(work(e) for e in co.order) or 1
        for _ in range(len(co.order)):
            comp = components()
            if not comp:
                break
            heaviest = max(
                comp.values(), key=lambda es: sum(work(e) for e in es)
            )
            w_heaviest = sum(work(e) for e in heaviest)
            if len(comp) >= n_devices and w_heaviest <= total / n_devices:
                break
            if len(heaviest) <= 1 and len(comp) >= n_devices:
                break
            # peel the top clique (max elimination position) of the
            # heaviest component into the root region
            top = max(heaviest, key=lambda e: pos[e])
            root_set.add(top)

        comp = components()
        # LPT bin-packing of components onto ranks.
        bins = [[] for _ in range(n_devices)]
        bin_work = [0] * n_devices
        for es in sorted(
            comp.values(), key=lambda es: -sum(work(e) for e in es)
        ):
            d = int(np.argmin(bin_work))
            bins[d].extend(es)
            bin_work[d] += sum(work(e) for e in es)

        def blocks_of(es):
            out = []
            for e in sorted(es, key=lambda e: pos[e]):
                s = tuple(co.supernodes[e])
                if s:
                    out.append((s, tuple(co.separators[e])))
            return tuple(out)

        local_blocks = tuple(blocks_of(es) for es in bins)
        root_blocks = list(blocks_of(root_set))
        covered = {
            v
            for blks in local_blocks + (tuple(root_blocks),)
            for s, _ in blks
            for v in s
        }
        rest = tuple(v for v in range(n) if v not in covered)
        if rest:
            root_blocks.append((rest, ()))
        root_blocks = tuple(root_blocks)
        r_vars = tuple(sorted({v for s, _ in root_blocks for v in s}))
        return DistributedSupernodalStructure(
            local_blocks=local_blocks,
            root_blocks=root_blocks,
            r_vars=r_vars,
            n=n,
            n_devices=n_devices,
        )

    def padded_arrays(self):
        """Stacked per-rank local index arrays + root structure.

        Returns (s_all[D,K,smax], p_all[D,K,pmax], own[D,n] bool,
        r_idx[r], root_struct (R-local ScanSupernodalStructure), n_ext).
        Padding uses disjoint dummy identity slots as in scan.py.
        """
        D = self.n_devices
        K = max((len(b) for b in self.local_blocks), default=0)
        smax = max(
            (len(s) for b in self.local_blocks for s, _ in b), default=1
        )
        pmax = max(
            (len(p) for b in self.local_blocks for _, p in b), default=0
        )
        K, smax, pmax_w = max(K, 1), max(smax, 1), max(pmax, 1)
        n = self.n
        s_all = np.zeros((D, K, smax), np.int32)
        p_all = np.zeros((D, K, pmax_w), np.int32)
        own = np.zeros((D, n), bool)
        for d, blks in enumerate(self.local_blocks):
            for k in range(K):
                if k < len(blks):
                    s, p = blks[k]
                else:
                    s, p = (), ()
                s_all[d, k, : len(s)] = s
                s_all[d, k, len(s):] = n + np.arange(smax - len(s))
                p_all[d, k, : len(p)] = p
                p_all[d, k, len(p):] = n + smax + np.arange(pmax_w - len(p))
                own[d, list(s)] = True
        r_idx = np.asarray(self.r_vars, np.int32)
        rmap = {v: i for i, v in enumerate(self.r_vars)}
        root_local = tuple(
            (tuple(rmap[v] for v in s), tuple(rmap[v] for v in p))
            for s, p in self.root_blocks
        )
        root_struct = ScanSupernodalStructure(
            blocks=root_local, n=len(self.r_vars)
        )
        return s_all, p_all, own, r_idx, root_struct, n + smax + pmax_w


def group_rank(n_devices: int, group) -> int:
    """This rank's index in ``group``, which must have ``n_devices`` ranks."""
    size = axis_size(group)
    if size != n_devices:
        raise ValueError(f"the structure is partitioned over {n_devices} ranks, "
                         f"the group has {size}")
    return axis_index(group)


@functools.lru_cache(maxsize=None)
def _local(ds: DistributedSupernodalStructure, device, rank: int):
    """Rank ``rank``'s tensors on ``device``, made once per (structure,
    device, rank): its steps [(s_idx[k], p_idx[k])] (its own cliques), its
    ownership mask (n,), the root set R, the root structure and n_ext."""
    s_all, p_all, own, r_idx, root_struct, n_ext = ds.padded_arrays()
    K = len(ds.local_blocks[rank])

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    steps = list(zip(t(s_all[rank, :K]), t(p_all[rank, :K])))
    return (steps, torch.as_tensor(own[rank], device=device), t(r_idx),
            root_struct, n_ext)


def _factor(G, ds, group, mode):
    """Subtree-local elimination of the (S, n, n) G + the all-reduced root
    Schur complement, factored on every rank."""
    steps, _, r, root_struct, n_ext = _local(ds, G.device,
                                             group_rank(ds.n_devices, group))
    Gc = scan._extend(G, ds, n_ext)
    rr = (r[:, None], r[None, :])
    G_rr = Gc[:, rr[0], rr[1]]
    facs = []
    fail = torch.zeros(G.shape[0], dtype=torch.bool, device=G.device)
    for si, pi in steps:
        fac, f = factor_step(Gc, si, pi, mode)
        facs.append(fac)
        fail = fail | f
    S_root = G_rr + psum((Gc[:, rr[0], rr[1]] - G_rr,), group)[0]
    root_factor = scan.factor_llt if mode == KKT_SOLVER_LLT else scan.factor_ldlt
    root_fac, fail_root = root_factor(S_root, root_struct)
    return (facs, root_fac), pany(fail, group) | fail_root


def _solve(fac, ds, b, group, mode):
    facs, root_fac = fac
    steps, own, r, root_struct, n_ext = _local(ds, b.device,
                                               group_rank(ds.n_devices, group))
    S, n = b.shape
    z = b.new_zeros((S, n_ext))
    z[:, :n] = b
    for (si, pi), f in zip(steps, facs):
        forward_step(z, si, pi, f, mode)
    # Combine the R-residual contributions and solve the root system.
    zR = b[:, r] + psum((z[:, r] - b[:, r],), group)[0]
    root_solve = scan.solve_llt if mode == KKT_SOLVER_LLT else scan.solve_ldlt
    xR = root_solve(root_fac, root_struct, zR)
    z[:, r] = xR
    if mode != KKT_SOLVER_LLT:
        for (si, _), f in zip(steps, facs):
            scale_step(z, si, f)
    for (si, pi), f in zip(reversed(steps), reversed(facs)):
        backward_step(z, si, pi, f, mode)
    x = psum((torch.where(own, z[:, :n], torch.zeros_like(b)),), group)[0]
    x[:, r] = xR
    return x


def factor_llt(G, ds: DistributedSupernodalStructure, group):
    """Subtree-local block Cholesky + all-reduced root Schur complement.
    Every rank of ``group`` holds the same (S, n, n) G (for example after
    the cone-sharded assembly's all-reduce) and calls this together."""
    return _factor(G, ds, group, KKT_SOLVER_LLT)


def solve_llt(fac, ds: DistributedSupernodalStructure, b, group):
    return _solve(fac, ds, b, group, KKT_SOLVER_LLT)


def factor_ldlt(G, ds: DistributedSupernodalStructure, group):
    """Subtree-local clamped LDLT + all-reduced root Schur complement
    (indefinite KKT systems with equality duals)."""
    return _factor(G, ds, group, KKT_SOLVER_LDLT)


def solve_ldlt(fac, ds: DistributedSupernodalStructure, b, group):
    return _solve(fac, ds, b, group, KKT_SOLVER_LDLT)

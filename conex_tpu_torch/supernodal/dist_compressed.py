"""Distributed supernodal factorization on block-compressed storage.

Twin of ``conex_tpu/supernodal/dist_compressed.py``, batched over the
scenario axis.  It composes two designs:

* supernodal/compressed.py — the factor lives in ONE flat buffer of padded
  per-clique blocks (O(sum of block sizes), never a dense (N, N) matrix),
  the counterpart of the reference's contiguous per-clique storage with
  pointer-scattered separator updates
  (reference triangular_matrix_workspace.cc:123-159);
* supernodal/distributed.py — the clique tree is cut into an upward-closed
  root region plus per-rank subtrees; ranks eliminate their subtrees
  independently and couple only through the root separator set.

The global elimination order is laid out subtree-contiguous (rank 0's
cliques, rank 1's, ..., root cliques last — a valid elimination order
because the running-intersection property routes every local clique's
separator updates to later cliques of the SAME subtree or to the root
region).  Assembly scatters cone contributions into the global compressed
buffer (``base``) and one all-reduce combines them (solver/loop.py).

The factorization carries only a LOCAL buffer per rank: the rank's own
clique blocks plus a copy of the root-region blocks, gathered from the
global buffer in one shot.  Each rank eliminates its own cliques with
update targets remapped into local coordinates, one all-reduce of the
root-region delta combines the cross-rank Schur contributions, and the
(small) root system factors on every rank alike in root-local coordinates.
Solves mirror it on O(n) vectors: local forward substitution, one
root-residual all-reduce, the replicated root solve, local backward
substitution, owner-masked all-reduce.

The host-side maps (``_device_arrays``) are a copy of the JAX package's and
equal to its maps, array for array; their tensors are made once per
(structure, device, rank, dtype).  A rank's loop runs over its own cliques
only (the JAX package pads every rank with identity steps, which change
nothing).  Pivot semantics for LDLT match the reference RLDLT clamp
(RLDLT.h:381-393).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import KKT_SOLVER_LDLT, KKT_SOLVER_LLT
from ..parallel.collectives import pany, psum
from .compressed import CompressedSupernodalStructure, _padded_indices, _update_map
from .distributed import DistributedSupernodalStructure, group_rank
from .solver import (backward_step, forward_step, ldlt_block, llt_block,
                     scale_step)


class DistributedCompressedStructure(NamedTuple):
    """Static, hashable partitioned compressed elimination structure.

    ``base`` is the global compressed structure in subtree-contiguous
    elimination order; ``device_cliques[d]`` are rank d's global clique
    indices (its subtrees, in elimination order); ``root_cliques`` are the
    root region's clique indices (last in the global order).
    """

    base: CompressedSupernodalStructure
    device_cliques: Tuple[Tuple[int, ...], ...]
    root_cliques: Tuple[int, ...]
    n_devices: int

    @property
    def n(self) -> int:
        return self.base.n

    @staticmethod
    def from_cliques(cliques: Sequence[Sequence[int]], n: int,
                     n_devices: int, valid_leaf=None, root: int = -1):
        ds = DistributedSupernodalStructure.from_cliques(
            cliques, n, n_devices, valid_leaf=valid_leaf, root=root
        )
        blocks = []
        device_cliques = []
        for blks in ds.local_blocks:
            device_cliques.append(
                tuple(range(len(blocks), len(blocks) + len(blks)))
            )
            blocks.extend(blks)
        root_ids = tuple(
            range(len(blocks), len(blocks) + len(ds.root_blocks))
        )
        blocks.extend(ds.root_blocks)
        return DistributedCompressedStructure(
            base=CompressedSupernodalStructure(blocks=tuple(blocks), n=n),
            device_cliques=tuple(device_cliques),
            root_cliques=root_ids,
            n_devices=n_devices,
        )


@functools.lru_cache(maxsize=None)
def _device_arrays(dcs: DistributedCompressedStructure):
    """Host-precomputed local-coordinate maps.

    Local buffer layout per rank (identical shape on every rank):
        [ Dloc: Kd*smax^2 | Oloc: Kd*smax*pmax
        | Droot: Kr*smax^2 | Oroot: Kr*smax*pmax | dump ]
    Root-only buffer layout (for the replicated root elimination):
        [ Droot | Oroot | dump ]
    """
    struct = dcs.base
    upd = np.asarray(_update_map(struct))
    s_idx, p_idx, diag_pad, n_ext = _padded_indices(struct)
    smax, pmax = struct.smax, max(struct.pmax, 1)
    dsz, osz = smax * smax, smax * pmax
    D = dcs.n_devices
    Kd = max((len(c) for c in dcs.device_cliques), default=0) or 1
    Kr = len(dcs.root_cliques)

    o_loc_off = Kd * dsz
    d_root_off = Kd * (dsz + osz)
    root_len = Kr * (dsz + osz)
    dump_local = d_root_off + root_len
    dump_root = root_len

    root_index = {k: i for i, k in enumerate(dcs.root_cliques)}

    def decode(t):
        """Global flat position -> (clique, region, offset) or None."""
        if t == struct.dump:
            return None
        if t < struct.d_size:
            return t // dsz, "D", t % dsz
        t2 = t - struct.d_size
        return t2 // osz, "O", t2 % osz

    def root_local(t):
        dec = decode(t)
        if dec is None:
            return dump_root
        k2, reg, off = dec
        i2 = root_index.get(k2)
        if i2 is None:
            return dump_root
        return i2 * dsz + off if reg == "D" else Kr * dsz + i2 * osz + off

    ids = np.zeros((D, Kd), np.int32)
    pad = np.ones((D, Kd), bool)
    gather = np.full((D, d_root_off), struct.dump, np.int64)
    upd_loc = np.full((D, Kd, pmax, pmax), dump_local, np.int64)
    s_dev = np.zeros((D, Kd, smax), np.int32)
    p_dev = np.zeros((D, Kd, pmax), np.int32)
    dpad_dev = np.zeros((D, Kd, smax), diag_pad.dtype)
    own = np.zeros((D, struct.n), bool)
    for d, cl in enumerate(dcs.device_cliques):
        loc_index = {k: j for j, k in enumerate(cl)}
        for j, k in enumerate(cl):
            ids[d, j] = k
            pad[d, j] = False
            gather[d, j * dsz:(j + 1) * dsz] = k * dsz + np.arange(dsz)
            gather[d, o_loc_off + j * osz: o_loc_off + (j + 1) * osz] = (
                struct.d_size + k * osz + np.arange(osz)
            )
            s_dev[d, j] = s_idx[k]
            p_dev[d, j] = p_idx[k]
            dpad_dev[d, j] = diag_pad[k]
            s, _ = struct.blocks[k]
            own[d, list(s)] = True
            for a in range(pmax):
                for bb in range(pmax):
                    t = upd[k, a, bb]
                    dec = decode(t)
                    if dec is None:
                        continue
                    k2, reg, off = dec
                    j2 = loc_index.get(k2)
                    if j2 is not None:
                        upd_loc[d, j, a, bb] = (
                            j2 * dsz + off
                            if reg == "D"
                            else o_loc_off + j2 * osz + off
                        )
                    elif k2 in root_index:
                        upd_loc[d, j, a, bb] = d_root_off + root_local(t)
                    # else: outside rank+root => dump (impossible by RIP)
        # padded steps' s/p indices alias real slots harmlessly (L=I, B=0);
        # point them at clique 0 of the structure.
        for j in range(len(cl), Kd):
            s_dev[d, j] = s_idx[0]
            p_dev[d, j] = p_idx[0]

    rids = np.asarray(dcs.root_cliques, np.int32)
    r_upd_loc = np.full((max(Kr, 1), pmax, pmax), dump_root, np.int64)
    for i, k in enumerate(dcs.root_cliques):
        for a in range(pmax):
            for bb in range(pmax):
                r_upd_loc[i, a, bb] = root_local(upd[k, a, bb])
    r_vars = np.asarray(
        sorted({v for k in dcs.root_cliques for v in struct.blocks[k][0]}),
        np.int32,
    )
    # Root cliques are contiguous at the END of the global order: their D
    # and O blocks are two contiguous tail slices of the global buffer.
    r0 = int(rids.min()) if Kr else len(struct.blocks)
    root_slices = (
        (r0 * dsz, struct.d_size),
        (struct.d_size + r0 * osz, struct.d_size + struct.o_size),
    )
    geom = dict(
        smax=smax, pmax=pmax, dsz=dsz, osz=osz, Kd=Kd, Kr=Kr,
        o_loc_off=o_loc_off, d_root_off=d_root_off, root_len=root_len,
        dump_local=dump_local, dump_root=dump_root, n_ext=n_ext,
        root_slices=root_slices,
    )
    return dict(
        ids=ids, pad=pad, gather=gather, upd_loc=upd_loc, s_dev=s_dev,
        p_dev=p_dev, dpad_dev=dpad_dev, own=own, rids=rids,
        r_upd_loc=r_upd_loc, r_s=s_idx[rids], r_p=p_idx[rids],
        r_dpad=diag_pad[rids], r_vars=r_vars, geom=geom,
    )


class _Maps(NamedTuple):
    """One rank's maps as tensors on one device: its own cliques' steps,
    update targets and padding identities, the root's, and the layout."""

    gather: torch.Tensor  # (d_root_off,) global positions of Dloc | Oloc
    steps: list  # [(s_idx, p_idx)] of the rank's cliques
    upd: torch.Tensor  # (Kloc, pmax * pmax) local update targets
    pad: torch.Tensor  # (Kloc, smax, smax) diagonal padding identities
    own: torch.Tensor  # (n,) bool: the rank's supernode variables
    r_steps: list
    r_upd: torch.Tensor  # (Kr, pmax * pmax) root-local update targets
    r_pad: torch.Tensor  # (Kr, smax, smax)
    r_vars: torch.Tensor  # (r,) the root set R
    geom: dict


@functools.lru_cache(maxsize=None)
def _maps(dcs: DistributedCompressedStructure, device, rank: int, dtype) -> _Maps:
    """Rank ``rank``'s maps on ``device``, made once per (structure,
    device, rank, dtype): no host-to-device copy inside the loops."""
    a = _device_arrays(dcs)
    K = len(dcs.device_cliques[rank])
    Kr, pmax = a["geom"]["Kr"], a["geom"]["pmax"]

    def index(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def eye_pad(x):
        return torch.diag_embed(torch.as_tensor(x, dtype=dtype, device=device))

    return _Maps(
        gather=index(a["gather"][rank]),
        steps=list(zip(index(a["s_dev"][rank, :K]), index(a["p_dev"][rank, :K]))),
        upd=index(a["upd_loc"][rank, :K].reshape(K, pmax * pmax)),
        pad=eye_pad(a["dpad_dev"][rank, :K]),
        own=torch.as_tensor(a["own"][rank], device=device),
        r_steps=list(zip(index(a["r_s"]), index(a["r_p"]))),
        r_upd=index(a["r_upd_loc"][:Kr].reshape(Kr, pmax * pmax)),
        r_pad=eye_pad(a["r_dpad"]),
        r_vars=index(a["r_vars"]),
        geom=a["geom"],
    )


def _local_buffer(buf, m: _Maps):
    """Gather [Dloc | Oloc | Droot | Oroot | dump] from the (S, buf_size)
    global buffer."""
    (lo1, hi1), (lo2, hi2) = m.geom["root_slices"]
    return torch.cat([buf[:, m.gather], buf[:, lo1:hi1], buf[:, lo2:hi2],
                      buf.new_zeros((buf.shape[0], 1))], dim=1)


def _combined_root(buf, lc, m: _Maps, group):
    """Root-only buffer: original root blocks + the all-reduced local
    deltas."""
    g = m.geom
    (lo1, hi1), (lo2, hi2) = g["root_slices"]
    root_orig = torch.cat([buf[:, lo1:hi1], buf[:, lo2:hi2]], dim=1)
    delta = lc[:, g["d_root_off"]: g["dump_local"]] - root_orig
    combined = root_orig + psum((delta,), group)[0]
    return torch.cat([combined, buf.new_zeros((buf.shape[0], 1))], dim=1)


def _eliminate(bc, upd, pad, o_off, g, mode):
    """Eliminate the cliques of the buffer bc (S, len) in place: clique j's
    D block at j * dsz and its O block at o_off + j * osz, its separator
    update scattered through upd[j].  Returns ([factor tuple], fail)."""
    S, smax, pmax = bc.shape[0], g["smax"], g["pmax"]
    dsz, osz = g["dsz"], g["osz"]
    facs = []
    fail = torch.zeros(S, dtype=torch.bool, device=bc.device)
    for j in range(upd.shape[0]):
        D = bc[:, j * dsz:(j + 1) * dsz].view(S, smax, smax) + pad[j]
        O = bc[:, o_off + j * osz: o_off + (j + 1) * osz].view(S, smax, pmax)
        if mode == KKT_SOLVER_LLT:
            L, B, U, f = llt_block(D, O)
            facs.append((L, B))
        else:
            Lu, d, C, U, f = ldlt_block(D, O)
            facs.append((Lu, d, C))
        bc.index_add_(1, upd[j], U.reshape(S, -1))
        fail = fail | f
    return facs, fail


def _factor(buf, dcs, group, mode):
    m = _maps(dcs, buf.device, group_rank(dcs.n_devices, group), buf.dtype)
    g = m.geom
    lc = _local_buffer(buf, m)
    local, fail = _eliminate(lc, m.upd, m.pad, g["o_loc_off"], g, mode)
    rb = _combined_root(buf, lc, m, group)
    root, fail_root = _eliminate(rb, m.r_upd, m.r_pad, g["Kr"] * g["dsz"], g, mode)
    return (local, root), pany(fail, group) | fail_root


def _solve(fac, dcs, b, group, mode):
    local, root = fac
    m = _maps(dcs, b.device, group_rank(dcs.n_devices, group), b.dtype)
    S, n = b.shape
    r = m.r_vars
    z = b.new_zeros((S, m.geom["n_ext"]))
    z[:, :n] = b
    for (si, pi), f in zip(m.steps, local):
        forward_step(z, si, pi, f, mode)
    # Root residual: the local forward substitution only ADDS to root
    # positions, so the deltas are additive contributions.
    z[:, r] = b[:, r] + psum((z[:, r] - b[:, r],), group)[0]
    for (si, pi), f in zip(m.r_steps, root):
        forward_step(z, si, pi, f, mode)
    if mode != KKT_SOLVER_LLT:
        for (si, _), f in zip(m.r_steps, root):
            scale_step(z, si, f)
        for (si, _), f in zip(m.steps, local):
            scale_step(z, si, f)
    for (si, pi), f in zip(reversed(m.r_steps), reversed(root)):
        backward_step(z, si, pi, f, mode)
    for (si, pi), f in zip(reversed(m.steps), reversed(local)):
        backward_step(z, si, pi, f, mode)
    x = psum((torch.where(m.own, z[:, :n], torch.zeros_like(b)),), group)[0]
    x[:, r] = z[:, r]
    return x


def factor_llt(buf, dcs: DistributedCompressedStructure, group):
    """Subtree-parallel block Cholesky on compressed storage.

    ``buf`` is the all-reduced assembled (S, buf_size) global compressed
    buffer, the same on every rank of ``group``, which call this together.
    Per-rank work and memory are O(local blocks + root); communication is
    one O(root) all-reduce and the fail flag's.

    reference: BlockCholeskyInPlace semantics
    (block_triangular_operations.cc:184-219) with the separator pointer
    scatter becoming the remapped local-coordinate index add."""
    return _factor(buf, dcs, group, KKT_SOLVER_LLT)


def solve_llt(fac, dcs: DistributedCompressedStructure, b, group):
    return _solve(fac, dcs, b, group, KKT_SOLVER_LLT)


def factor_ldlt(buf, dcs: DistributedCompressedStructure, group):
    """Subtree-parallel clamped LDLT (indefinite KKT systems with equality
    duals; RLDLT 1e-9 pivot clamp semantics)."""
    return _factor(buf, dcs, group, KKT_SOLVER_LDLT)


def solve_ldlt(fac, dcs: DistributedCompressedStructure, b, group):
    return _solve(fac, dcs, b, group, KKT_SOLVER_LDLT)

"""Standalone elimination-ordering utilities on dense adjacency matrices.

Copy of ``conex_tpu/supernodal/elimination.py`` (numpy, no JAX).
Re-implements the reference's elimination_ordering.{h,cc} (Maximum
Cardinality Search, chordality test, perfect-elimination-ordering test;
cites Vandenberghe's chordal-SDP lecture notes).  Note: in the reference
this file is vestigial — no BUILD target and no callers (SURVEY.md §2.2) —
the live machinery is the clique ordering in ordering.py.  Provided for
inventory completeness and as a testing aid for chordal structure.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def maximum_cardinality_search(adjacency: np.ndarray) -> List[int]:
    """MCS elimination ordering: repeatedly pick the unnumbered vertex with
    the most numbered neighbors.  For a chordal graph the reverse of this
    order is a perfect elimination ordering."""
    A = np.asarray(adjacency) != 0
    n = A.shape[0]
    weight = np.zeros(n, dtype=int)
    numbered = np.zeros(n, dtype=bool)
    order = []
    for _ in range(n):
        cand = np.where(~numbered)[0]
        v = cand[np.argmax(weight[cand])]
        order.append(int(v))
        numbered[v] = True
        weight[A[v] & ~numbered] += 1
    order.reverse()
    return order


def is_perfectly_ordered(adjacency: np.ndarray,
                         order: Sequence[int]) -> bool:
    """True if ``order`` is a perfect elimination ordering: for each vertex
    v, its later-ordered neighbors form a clique."""
    A = np.asarray(adjacency) != 0
    n = A.shape[0]
    pos = np.empty(n, dtype=int)
    for i, v in enumerate(order):
        pos[v] = i
    for v in range(n):
        later = [u for u in np.where(A[v])[0] if pos[u] > pos[v]]
        for i in range(len(later)):
            for j in range(i + 1, len(later)):
                if not A[later[i], later[j]]:
                    return False
    return True


def is_chordal(adjacency: np.ndarray) -> bool:
    """Chordality test: MCS produces a perfect elimination ordering iff the
    graph is chordal."""
    return is_perfectly_ordered(
        adjacency, maximum_cardinality_search(adjacency)
    )


def eliminate(adjacency: np.ndarray, v: int) -> np.ndarray:
    """Eliminate vertex v: connect its neighbors (fill-in) and remove it
    from the graph (the adjacency keeps its size; row/col v zeroed)."""
    A = (np.asarray(adjacency) != 0).copy()
    nbrs = np.where(A[v])[0]
    for i in nbrs:
        for j in nbrs:
            if i != j:
                A[i, j] = True
    A[v, :] = False
    A[:, v] = False
    return A

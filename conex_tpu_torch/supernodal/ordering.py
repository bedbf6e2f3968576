"""Clique-tree elimination ordering and fill-in (host-side analysis).

Copy of ``conex_tpu/supernodal/ordering.py`` (pure Python, no JAX).
Re-implements the reference's tree_utils.{h,cc} and clique_ordering.{h,cc}:
greedy DFS over the clique-intersection graph maximizing separator size,
automatic root re-selection by maximum weighted degree, supernode/separator
splitting, and fill-in computation via the running-intersection property on
tree paths.  This is inherently sequential graph preprocessing and runs on
the host once per program structure (SURVEY.md §7 phase 5); the result is
*static* structure baked into the compiled factorization.

A C++ implementation of the same algorithm lives in
conex_tpu_torch/native/ (used when built, which ``native.available()``
tells); this module is the reference-faithful Python fallback and oracle.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple


def intersection_of_sorted(a: Sequence[int], b: Sequence[int]) -> List[int]:
    sb = set(b)
    return [x for x in a if x in sb]


def union_of_sorted(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return sorted(set(a) | set(b))


def path_in_tree(x: int, y: int, parent: Sequence[int],
                 height: Sequence[int]) -> List[int]:
    """Path between nodes x and y of a rooted tree.

    reference: PathInTree (tree_utils.cc:11-25).
    """
    path = []
    while x != y:
        if height[x] < height[y]:
            path.append(y)
            y = parent[y]
        else:
            path.append(x)
            x = parent[x]
    path.append(x)
    return path


class CliqueOrder(NamedTuple):
    order: List[int]  # elimination order of cliques
    supernodes: List[List[int]]  # per-clique supernode variables (sorted)
    separators: List[List[int]]  # per-clique separator variables (sorted)
    parent: List[int]  # clique tree parent array
    height: List[int]


def _pick_clique_order_helper(cliques_sorted, valid_leaf, root_in,
                              intersections, separators, order, parent,
                              height):
    """Greedy DFS (reference PickCliqueOrderHelper,
    clique_ordering.cc:111-201).  Returns the max-weighted-degree node for
    root re-selection."""
    n = len(cliques_sorted)

    def get_intersection(a, b):
        key = (min(a, b), max(a, b))
        if key not in intersections:
            intersections[key] = intersection_of_sorted(
                cliques_sorted[a], cliques_sorted[b]
            )
        return intersections[key]

    def get_weight(active, i):
        w = len(get_intersection(active, i))
        if valid_leaf:
            if not valid_leaf[i]:
                w += 10000
            if not valid_leaf[active]:
                w += 10000
        return w

    visited = [0] * n
    stack = [max(root_in, 0)]
    edges = []
    order.clear()

    while len(order) < n:
        active = stack[-1]
        if visited[active] == 0:
            order.append(active)
            visited[active] = 1
            parent[active] = active
            height[active] = 0

        max_weight = 1
        argmax = []
        for i in range(n):
            if i == active:
                continue
            w = get_weight(active, i)
            if w >= max_weight and not visited[i]:
                if w > max_weight:
                    argmax.clear()
                    max_weight = w
                argmax.append(i)

        for e in argmax:
            separators[e] = list(get_intersection(active, e))
            stack.append(e)
            order.append(e)
            visited[e] = 1
            edges.append((active, e))
            parent[e] = active
            height[e] = height[active] + 1
            if valid_leaf and not valid_leaf[e]:
                # Heuristic: stop so that e is less likely a leaf
                # (clique_ordering.cc:174-178).
                break

        if not argmax:
            stack.pop()
            if not stack:
                try:
                    node = visited.index(0)
                except ValueError:
                    break
                stack.append(node)

    weights = [0] * n
    for a, b in edges:
        w = len(get_intersection(a, b))
        weights[a] += w
        weights[b] += w
    root_node = max(range(n), key=lambda i: weights[i])
    order.reverse()
    return root_node


def fill_in(parent, height, num_variables, order, supernodes, separators):
    """Fill-in via the running-intersection property.

    reference: FillIn (clique_ordering.cc:261-305).
    """
    num_cliques = len(order)
    eliminated = [num_cliques + 1] * num_variables

    for i in range(num_cliques):
        for v in supernodes[order[i]]:
            if eliminated[v] < num_cliques:
                path = path_in_tree(
                    order[i], eliminated[v], parent, height
                )
                for e in path[:-1]:
                    separators[e] = union_of_sorted(separators[e], [v])
                eliminated[v] = path[-1]
            else:
                eliminated[v] = order[i]

    new_supernodes = [[] for _ in range(num_cliques)]
    for v in range(num_variables):
        if eliminated[v] < num_cliques:
            new_supernodes[eliminated[v]].append(v)
    for s in new_supernodes:
        s.sort()
    for s in separators:
        s.sort()
    return new_supernodes, separators


def pick_clique_order(cliques: Sequence[Sequence[int]],
                      valid_leaf: Optional[Sequence[int]] = None,
                      root: int = -1,
                      use_native: bool = True) -> CliqueOrder:
    """Full ordering pipeline (reference PickCliqueOrder,
    clique_ordering.cc:307-342): DFS order (+ root re-selection when
    root == -1), supernode/separator split, then fill-in.

    Uses the native C++ implementation (conex_tpu_torch/native) when
    available; this Python version is the fallback and test oracle."""
    if use_native:
        from .. import native

        res = native.clique_order_native(cliques, valid_leaf, root)
        if res is not None:
            order, supernodes, separators, parent, height = res
            return CliqueOrder(
                order=order,
                supernodes=supernodes,
                separators=separators,
                parent=parent,
                height=height,
            )
    cliques_sorted = [sorted(c) for c in cliques]
    n = len(cliques_sorted)
    valid_leaf = list(valid_leaf) if valid_leaf is not None else []

    intersections = {}
    separators = [[] for _ in range(n)]
    order: List[int] = []
    parent = list(range(n))
    height = [0] * n
    better_root = _pick_clique_order_helper(
        cliques_sorted, valid_leaf, root, intersections, separators, order,
        parent, height,
    )
    if root == -1:
        separators = [[] for _ in range(n)]
        order = []
        parent = list(range(n))
        height = [0] * n
        _pick_clique_order_helper(
            cliques_sorted, valid_leaf, better_root, intersections,
            separators, order, parent, height,
        )

    supernodes = [[] for _ in range(n)]
    for e in order:
        supernodes[e] = sorted(
            set(cliques_sorted[e]) - set(separators[e])
        )

    num_vars = max(max(c) for c in cliques_sorted) + 1
    supernodes, separators = fill_in(
        parent, height, num_vars, order, supernodes, separators
    )
    return CliqueOrder(
        order=order,
        supernodes=supernodes,
        separators=separators,
        parent=parent,
        height=height,
    )


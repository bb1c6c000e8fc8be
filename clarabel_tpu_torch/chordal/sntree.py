"""Supernodal elimination tree / clique tree analysis.

reference: src/solver/chordal/supernode_tree.rs — parents from the factor
pattern, postordering, Pothen-Sun supernode detection, separators, the
consecutive-reordering needed for PSD completion, and per-clique block
dimensions.

The port's copy of ``clarabel_tpu/chordal/sntree.py``.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

NO_PARENT = -1
INACTIVE = -2


def children_from_parent(parent: List[int]) -> List[Set[int]]:
    children: List[Set[int]] = [set() for _ in range(len(parent))]
    for i, p in enumerate(parent):
        if p >= 0:
            children[p].add(i)
    return children


def post_order(parent: List[int], children: List[Set[int]], nc: int) -> List[int]:
    """Topological postorder (reference: supernode_tree.rs:266-300)."""
    n = len(parent)
    order = [nc + 1] * n
    root = next(i for i, p in enumerate(parent) if p == NO_PARENT)
    stack = [root]
    i = nc
    while stack:
        v = stack.pop()
        order[v] = i
        i -= 1
        stack.extend(sorted(children[v]))
    post = sorted(range(n), key=lambda x: order[x])
    return post[:nc]


class SuperNodeTree:
    """Clique tree of the chordal extension defined by an L pattern."""

    def __init__(self, L_cols: List[List[int]]):
        n = len(L_cols)
        # parent[v] = first below-diagonal entry of column v
        parent = [
            (min((r for r in L_cols[v] if r > v), default=NO_PARENT))
            if v < n - 1
            else NO_PARENT
            for v in range(n)
        ]
        children = children_from_parent(parent)
        self.post = post_order(parent, children, n)

        # higher degree: below-diagonal count per column
        degree = [len([r for r in L_cols[v] if r > v]) for v in range(n)]
        degree[n - 1] = 0

        snode, snode_parent = _pothen_sun(parent, self.post, degree)
        self.snode: List[Set[int]] = snode
        self.snode_parent: List[int] = snode_parent
        self.snode_children = children_from_parent(self.snode_parent)
        self.snode_post = post_order(
            self.snode_parent, self.snode_children, len(self.snode_parent)
        )

        # separators: higher neighbors of the supernode's representative
        # vertex not inside the supernode (supernode_tree.rs:222-239)
        self.separators: List[Set[int]] = []
        for sn in self.snode:
            vrep = min(sn)
            adjplus = [r for r in L_cols[vrep] if r > vrep]
            self.separators.append({v for v in adjplus if v not in sn})

        self.n_cliques = len(self.snode)
        self.nblk: List[int] | None = None

    # -- clique accessors (all take post-order positions) -------------
    def get_snode(self, i: int) -> Set[int]:
        return self.snode[self.snode_post[i]]

    def get_separators(self, i: int) -> Set[int]:
        return self.separators[self.snode_post[i]]

    def get_clique(self, i: int) -> Set[int]:
        c = self.snode_post[i]
        return self.snode[c] | self.separators[c]

    def get_nblk(self, i: int) -> int:
        return self.nblk[i]

    def get_overlap(self, i: int) -> int:
        return len(self.separators[self.snode_post[i]])

    def get_decomposed_dim_and_overlaps(self):
        dim = overlaps = 0
        for i in range(self.n_cliques):
            dim += _tri(self.get_nblk(i))
            overlaps += _tri(self.get_overlap(i))
        return dim, overlaps

    # ------------------------------------------------------------------
    def reorder_snode_consecutively(self, ordering: np.ndarray) -> np.ndarray:
        """Renumber vertices so each supernode is a consecutive range
        (required for PSD completion's equal column structure).

        reference: supernode_tree.rs:128-171.  Returns the updated
        ``ordering`` (permuted-vertex -> original-vertex map).
        """
        n = len(self.post)
        p = np.zeros(n, np.int64)
        k = 0
        for i in self.snode_post:
            sn = sorted(self.snode[i])
            cnt = len(sn)
            p[k : k + cnt] = sn
            self.snode[i] = set(range(k, k + cnt))
            k += cnt

        p_inv = np.argsort(p)
        self.separators = [
            {int(p_inv[x]) for x in sep} for sep in self.separators
        ]
        return np.asarray(ordering)[p]

    def calculate_block_dimensions(self):
        self.nblk = [
            len(self.separators[c]) + len(self.snode[c])
            for c in (self.snode_post[i] for i in range(self.n_cliques))
        ]


def _tri(k: int) -> int:
    return (k * (k + 1)) // 2


def _pothen_sun(parent, post, degree):
    """Pothen-Sun fundamental supernode detection
    (reference: supernode_tree.rs:310-398)."""
    n = len(parent)
    snode_index = [-1] * n  # < 0: representative vertex
    snode_parent = [NO_PARENT] * n
    children: List[Set[int]] = [set() for _ in range(n)]
    root_index = parent.index(NO_PARENT)

    for v in post:
        if parent[v] == NO_PARENT:
            children[root_index].add(v)
        else:
            children[parent[v]].add(v)

        if parent[v] != NO_PARENT:
            if degree[v] - 1 == degree[parent[v]] and snode_index[parent[v]] == -1:
                if snode_index[v] < 0:
                    snode_index[parent[v]] = v
                    snode_index[v] -= 1
                else:
                    snode_index[parent[v]] = snode_index[v]
                    snode_index[snode_index[v]] -= 1
            elif snode_index[v] < 0:
                snode_parent[v] = v
            else:
                snode_parent[snode_index[v]] = snode_index[v]

        k = v if snode_index[v] < 0 else snode_index[v]
        for w in children[v]:
            l = w if snode_index[w] < 0 else snode_index[w]
            if l != k:
                snode_parent[l] = k

    repr_vertex = [i for i, x in enumerate(snode_index) if x < 0]
    repr_parent = [snode_parent[i] for i in repr_vertex]

    new_parent = [NO_PARENT] * len(repr_vertex)
    for i, rp in enumerate(repr_parent):
        if rp in repr_vertex:
            new_parent[i] = repr_vertex.index(rp)

    snode: List[Set[int]] = [set() for _ in range(len(repr_vertex))]
    rep_pos = {r: k for k, r in enumerate(repr_vertex)}
    for i, f in enumerate(snode_index):
        if f < 0:
            snode[rep_pos[i]].add(i)
        else:
            snode[rep_pos[f]].add(i)

    return snode, new_parent

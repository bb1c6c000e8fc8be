"""Symbolic factorization machinery for chordal analysis.

Host-side graph algorithms run once at setup: fill-reducing ordering,
elimination tree, and the symbolic Cholesky pattern L whose columns define
the chordal extension's cliques.

The reference reaches this through a logical-only QDLDL factorization with
AMD ordering (reference: src/solver/chordal/chordal_info.rs:245-306 via
src/qdldl).  Here the same artifacts come from a plain minimum-degree
ordering and an etree-based symbolic pass — the decomposition is equally
valid for any fill-reducing ordering, and this is setup-time-only work.

The port's copy of ``clarabel_tpu/chordal/symbolic.py``, whose functions
dispatch to the JAX package's native C++ engine when it is built and fall
back to these Python versions, which compute the same ordering and pattern
(the same greedy choice, lowest degree first and ties by index).
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np


def minimum_degree_ordering(n: int, adj: Sequence[Set[int]]) -> np.ndarray:
    """Greedy minimum-degree ordering of an undirected graph.

    Returns ``perm`` with perm[k] = original vertex eliminated at step k
    (so the permuted matrix is A[perm][:, perm]).
    """
    adj = [set(a) for a in adj]
    eliminated = [False] * n
    perm = []
    for _ in range(n):
        # pick the lowest-degree uneliminated vertex (ties by index)
        best, best_deg = -1, n + 1
        for v in range(n):
            if not eliminated[v]:
                d = len(adj[v])
                if d < best_deg:
                    best, best_deg = v, d
        v = best
        eliminated[v] = True
        perm.append(v)
        # eliminate: connect neighbors into a clique
        nbrs = adj[v]
        for u in nbrs:
            adj[u].discard(v)
        for u in nbrs:
            adj[u] |= nbrs - {u}
    return np.asarray(perm, np.int64)


def symbolic_cholesky(
    n: int, lower_cols: Sequence[Set[int]]
) -> Tuple[List[List[int]], np.ndarray]:
    """Symbolic Cholesky of a (permuted) symmetric pattern.

    ``lower_cols[j]`` is the strictly-below-diagonal row set of column j.
    Returns (L_cols, parent): per-column sorted row lists of the factor
    pattern and the elimination tree.
    """
    NO_PARENT = -1
    patterns: List[Set[int]] = [set(c) for c in lower_cols]
    parent = np.full(n, NO_PARENT, np.int64)
    children: List[List[int]] = [[] for _ in range(n)]

    for j in range(n):
        pat = patterns[j]
        for c in children[j]:
            pat |= patterns[c] - {j}
        patterns[j] = pat
        if pat:
            p = min(pat)
            parent[j] = p
            children[p].append(j)

    L_cols = [sorted(p) for p in patterns]
    return L_cols, parent


def connect_graph(L_cols: List[List[int]], n: int) -> None:
    """Ensure the adjacency structure L is connected.

    Unconnected blocks have no entries below the diagonal in their
    right-most columns (reference: chordal_info.rs:284-306).
    """
    for j in range(n - 1):
        if not any(r > j for r in L_cols[j]):
            L_cols[j] = sorted(set(L_cols[j]) | {j + 1})


def find_graph(nz_mask: np.ndarray, n: int):
    """From an svec nonzero mask of an n x n PSD cone, produce the chordal
    extension: (L_cols, ordering).

    reference: chordal_info.rs:245-282 — the pattern graph is permuted by a
    fill-reducing ordering and symbolically factored; the factor's columns
    are the cliques of a chordal completion.
    """
    # svec position -> (row, col) in upper triangle, column-major
    pairs = []
    idx = 0
    for col in range(n):
        for row in range(col + 1):
            if nz_mask[idx]:
                pairs.append((row, col))
            idx += 1

    adj: List[Set[int]] = [set() for _ in range(n)]
    for r, c in pairs:
        if r != c:
            adj[r].add(c)
            adj[c].add(r)

    perm = minimum_degree_ordering(n, adj)
    iperm = np.argsort(perm)

    # permuted strictly-lower pattern
    lower_cols: List[Set[int]] = [set() for _ in range(n)]
    for r, c in pairs:
        if r == c:
            continue
        pr, pc = int(iperm[r]), int(iperm[c])
        lo, hi = min(pr, pc), max(pr, pc)
        lower_cols[lo].add(hi)

    L_cols, _parent = symbolic_cholesky(n, lower_cols)
    connect_graph(L_cols, n)

    # ordering maps permuted vertex -> original vertex (like QDLDL's perm)
    return L_cols, perm

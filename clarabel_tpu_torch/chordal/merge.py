"""Clique merge strategies.

reference: src/solver/chordal/merge/* — "none" (keep the fundamental
supernodes), "parent_child" (SparseCoLO-style fill-bounded parent/child
merging) and "clique_graph" (Garstka-Cannon-Goulart reduced clique-graph
merging with cubic edge weights, the default).

The port's copy of ``clarabel_tpu/chordal/merge.py``.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .sntree import INACTIVE, NO_PARENT, SuperNodeTree, children_from_parent, post_order


def merge_cliques(t: SuperNodeTree, method: str) -> None:
    if t.n_cliques <= 1:
        return
    if method == "none":
        return
    if method == "parent_child":
        _parent_child_merge(t)
        return
    if method == "clique_graph":
        _clique_graph_merge(t)
        return
    raise ValueError(f"unrecognized merge strategy {method!r}")


# =================================================================
# parent/child merging (merge/parent_child.rs)
# =================================================================

_T_FILL = 8
_T_SIZE = 8


def _fill_in(dim_c_snode, dim_c_sep, dim_p_snode, dim_p_sep) -> int:
    dim_parent = dim_p_snode + dim_p_sep
    dim_clique = dim_c_snode + dim_c_sep
    return (dim_parent - dim_c_sep) * (dim_clique - dim_c_sep)


def _parent_child_merge(t: SuperNodeTree) -> None:
    # traverse in descending topological order
    for clique_index in range(len(t.snode) - 2, -1, -1):
        c = t.snode_post[clique_index]
        parent = t.snode_parent[c]

        dps, dpp = len(t.snode[parent]), len(t.separators[parent])
        dcs, dcp = len(t.snode[c]), len(t.separators[c])
        fill = _fill_in(dcs, dcp, dps, dpp)
        max_snode = max(dcs, dps)

        if fill <= _T_FILL or max_snode <= _T_SIZE:
            p, ch = (parent, c) if c in t.snode_children[parent] else (c, parent)
            t.snode[p] |= t.snode[ch]
            t.snode[ch] = set()
            t.separators[ch] = set()
            for grandch in t.snode_children[ch]:
                t.snode_parent[grandch] = p
            t.snode_parent[ch] = INACTIVE
            t.snode_children[p].discard(ch)
            t.snode_children[p] |= t.snode_children[ch]
            t.snode_children[ch] = set()
            t.n_cliques -= 1

    t.snode_post = post_order(t.snode_parent, t.snode_children, t.n_cliques)


# =================================================================
# clique-graph merging (merge/clique_graph.rs)
# =================================================================


def _edge_metric(c_a: Set[int], c_b: Set[int]) -> int:
    """Cubic computational-savings weight (clique_graph.rs:716-731)."""
    n1, n2 = len(c_a), len(c_b)
    nm = len(c_a | c_b)
    return n1**3 + n2**3 - nm**3


def _clique_graph_merge(t: SuperNodeTree) -> None:
    # give up the tree: supernodes absorb their separators and become the
    # full cliques (clique_graph.rs:55-70)
    for i in range(len(t.snode)):
        t.snode[i] |= t.separators[i]
        t.snode_parent[i] = INACTIVE
        t.snode_children[i] = set()

    edges = _reduced_clique_graph_edges(t.separators, t.snode)
    weights: Dict[Tuple[int, int], int] = {
        e: _edge_metric(t.snode[e[0]], t.snode[e[1]]) for e in edges
    }
    adjacency: Dict[int, Set[int]] = {i: set() for i in range(len(t.snode))}
    for (a, b) in edges:
        adjacency[a].add(b)
        adjacency[b].add(a)

    # greedy merging while the best permissible edge has positive weight
    while t.n_cliques > 1 and weights:
        cand = _best_permissible(weights, adjacency, t.snode)
        if cand is None:
            break
        if weights[cand] < 0:
            break

        c1, c2 = cand  # merge c2 into c1
        t.snode[c1] |= t.snode[c2]
        t.snode[c2] = set()
        t.n_cliques -= 1

        # rewire edges of the removed clique to the survivor and
        # recompute weights of affected edges (clique_graph.rs:135-201)
        new_neighbors = adjacency[c2] - adjacency[c1] - {c1}
        for n_ind in list(adjacency[c1]):
            if n_ind != c2:
                weights[_key(c1, n_ind)] = _edge_metric(t.snode[c1], t.snode[n_ind])
        for n_ind in new_neighbors:
            weights[_key(c1, n_ind)] = _edge_metric(t.snode[c1], t.snode[n_ind])

        for n_ind in list(adjacency.get(c2, ())):
            weights.pop(_key(c2, n_ind), None)
        adjacency.pop(c2, None)
        for s in adjacency.values():
            s.discard(c2)
        for n_ind in new_neighbors:
            adjacency[c1].add(n_ind)
            adjacency[n_ind].add(c1)

    _clique_tree_from_graph(t, weights)

    t.snode_post = (
        post_order(t.snode_parent, t.snode_children, t.n_cliques)
        if t.n_cliques > 1
        else [i for i, s in enumerate(t.snode) if s]
    )


def _key(a: int, b: int) -> Tuple[int, int]:
    return (max(a, b), min(a, b))


def _best_permissible(weights, adjacency, snode):
    """Highest-weight permissible edge (clique_graph.rs:85-112, 473-495).

    An edge is permissible if for every common neighbor N,
    C1 ∩ N == C2 ∩ N.
    """
    for edge in sorted(weights, key=lambda e: (-weights[e], e)):
        c1, c2 = edge
        ok = True
        for nb in adjacency[c1] & adjacency[c2]:
            if (snode[c1] & snode[nb]) != (snode[c2] & snode[nb]):
                ok = False
                break
        if ok:
            return edge
    return None


def _reduced_clique_graph_edges(separators, snode) -> List[Tuple[int, int]]:
    """Union of all clique trees via the Habib-Stacho construction
    (clique_graph.rs:270-322)."""
    edges: List[Tuple[int, int]] = []
    for sep in sorted(separators, key=len, reverse=True):
        clique_indices = [i for i, s in enumerate(snode) if sep <= s]
        # separator graph H: edges between cliques whose intersection
        # strictly exceeds the separator
        H: Dict[int, List[int]] = {c: [] for c in clique_indices}
        for i in range(len(clique_indices)):
            for j in range(i + 1, len(clique_indices)):
                ca, cb = clique_indices[i], clique_indices[j]
                if (snode[ca] & snode[cb]) != sep:
                    H[ca].append(cb)
                    H[cb].append(ca)
        components = _components(H, clique_indices)
        comp_of = {}
        for k, comp in enumerate(components):
            for v in comp:
                comp_of[v] = k
        for i in range(len(clique_indices)):
            for j in range(i + 1, len(clique_indices)):
                a, b = clique_indices[i], clique_indices[j]
                if comp_of[a] != comp_of[b]:
                    edges.append(_key(a, b))
    return edges


def _components(H, vertices):
    visited = {v: False for v in vertices}
    comps = []
    for v in vertices:
        if not visited[v]:
            comp = set()
            stack = [v]
            while stack:
                u = stack.pop()
                if visited[u]:
                    continue
                visited[u] = True
                comp.add(u)
                stack.extend(w for w in H[u] if not visited[w])
            comps.append(comp)
    return comps


def _clique_tree_from_graph(t: SuperNodeTree, weights) -> None:
    """Rebuild a clique tree as the maximum-weight spanning tree of the
    intersection graph (clique_graph.rs:226-266, 560-593)."""
    alive = [i for i, s in enumerate(t.snode) if s]
    t.snode_parent = [INACTIVE] * len(t.snode)
    t.snode_children = [set() for _ in range(len(t.snode))]

    if t.n_cliques <= 1:
        for i in alive:
            t.snode_parent[i] = NO_PARENT
        t.snode_post = alive
        # split not needed: single clique has no separator
        for i in alive:
            t.separators[i] = set()
        return

    # MST over intersection cardinalities (Kruskal)
    inter_edges = sorted(
        ((len(t.snode[a] & t.snode[b]), (a, b)) for (a, b) in weights),
        key=lambda x: -x[0],
    )
    parent_dsu = {i: i for i in alive}

    def find(x):
        while parent_dsu[x] != x:
            parent_dsu[x] = parent_dsu[parent_dsu[x]]
            x = parent_dsu[x]
        return x

    mst = set()
    found = 0
    for _, (a, b) in inter_edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent_dsu[ra] = rb
            mst.add(_key(a, b))
            found += 1
            if found >= t.n_cliques - 1:
                break

    # root: the clique containing the highest-order vertex
    v_high = t.post[-1]
    root = next(k for k in alive if v_high in t.snode[k])
    t.snode_parent[root] = NO_PARENT

    stack = [root]
    seen = {root}
    while stack:
        c = stack.pop()
        for (a, b) in mst:
            other = None
            if a == c:
                other = b
            elif b == c:
                other = a
            if other is not None and other not in seen:
                t.snode_parent[other] = c
                t.snode_children[c].add(other)
                seen.add(other)
                stack.append(other)

    t.snode_post = post_order(t.snode_parent, t.snode_children, t.n_cliques)

    # split cliques back into supernodes and separators
    # (clique_graph.rs:670-695)
    for i in range(len(t.separators)):
        t.separators[i] = set()
    for j in range(t.n_cliques - 1):
        c_ind = t.snode_post[j]
        p_ind = t.snode_parent[c_ind]
        t.separators[c_ind] = t.snode[c_ind] & t.snode[p_ind]
        t.snode[c_ind] = t.snode[c_ind] - t.separators[c_ind]

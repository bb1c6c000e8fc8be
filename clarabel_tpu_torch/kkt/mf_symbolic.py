"""Host-side symbolic analysis for the multifrontal sparse LDLᵀ engine.

The port's copy of ``clarabel_tpu/kkt/mf_symbolic.py`` (host NumPy and
SciPy, no device work), whose plans it reproduces field for field.  It is
the JAX package's re-design of the reference's QDLDL symbolic phase
(reference: src/qdldl/qdldl.rs:433-464 elimination tree + column counts,
:905-922 AMD ordering): instead of a scalar up-looking factorization it
prepares a *supernodal multifrontal* schedule:

  - fill-reducing ordering (SuperLU's symmetric MMD, nested dissection for
    large patterns, RCM fallback),
  - elimination tree + full symbolic factor pattern,
  - fundamental supernodes + relaxed amalgamation (fatter fronts at the
    cost of a bounded fraction of explicit zeros),
  - a *levelized* schedule of the supernodal assembly tree: all fronts in
    a level are independent and are batched per padded-size bucket, so the
    numeric factorization (``kkt/multifrontal.py``) is a short sequence of
    batched dense partial factorizations instead of a scalar sparse loop,
  - flat gather/scatter index maps for (a) initializing fronts from the
    KKT nonzeros, (b) the extend-add of child update matrices into parent
    fronts, and (c) the levelized triangular solves.

The symbolic factorization and the amalgamation run through the port's
native C++ engine (``clarabel_tpu_torch/native.py``, built with ``g++`` at
first use) when it is built, as in the JAX package, and through their
Python versions otherwise, which make the same decisions.  Everything here
runs once at setup; the output ``MFPlan`` holds static structure (shapes,
Python lists) and a dict of integer index arrays that the numeric
factorization takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp


# --------------------------------------------------------------------------
# ordering
# --------------------------------------------------------------------------

_ND_MIN_DIM = 4096  # below this MMD's lower fill beats ND's parallelism


def nested_dissection_ordering(
    pattern: sp.csc_matrix, leaf: int = 256
) -> np.ndarray:
    """Nested-dissection ordering via recursive RCM-line bisection.

    Minimum-degree orderings produce chain-shaped elimination trees on
    banded/mesh patterns — a fully *sequential* multifrontal schedule.
    Nested dissection instead yields an O(log n)-depth assembly tree whose
    levels are wide batches of independent fronts: exactly the shape the
    levelized batched execution needs (and the separator fronts at the top
    are fat matrix products).  The bisector: lay the graph out with reverse
    Cuthill-McKee, split the line in half, and take the left-half vertices
    adjacent to the right half as the separator (one-way dissection in the
    George/Liu sense).
    """
    n = pattern.shape[0]
    adj = (pattern + pattern.T).tocsr()

    # AMD-style dense-row handling (reference: QDLDLSettings::amd_dense_scale,
    # qdldl.rs:31-40): near-dense vertices (coupling rows, sparse-cone
    # expansion columns) collapse RCM's level structure and induce a huge
    # dense trailing triangle.  Strip them, order the remainder, and
    # eliminate the dense vertices last (they form the top separator).
    deg = np.diff(adj.indptr)
    dense_cut = max(64, int(10.0 * np.sqrt(n)))
    dense_v = np.where(deg >= dense_cut)[0]
    if 0 < dense_v.size < n // 2:
        keep = np.ones(n, bool)
        keep[dense_v] = False
        keep_ids = np.where(keep)[0]
        sub = adj[keep_ids][:, keep_ids].tocsc()
        order_sub = nested_dissection_ordering(sub, leaf)
        return np.concatenate([keep_ids[order_sub], dense_v])

    try:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        rcm = np.asarray(
            reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64
        )
    except Exception:
        rcm = np.arange(n, dtype=np.int64)

    pos = np.full(n, -1, np.int64)
    out: List[np.ndarray] = []
    stack = [(rcm, False)]
    # explicit stack: (vertex set in line order, emit_now)
    while stack:
        vs, emit = stack.pop()
        if emit or vs.size <= leaf:
            out.append(vs)
            continue
        mid = vs.size // 2
        pos[vs] = np.arange(vs.size)
        L = vs[:mid]
        subL = adj[L]  # csr row selection
        rowmax = np.full(L.size, -1, np.int64)
        if subL.nnz:
            nbr_pos = pos[subL.indices]  # -1 for vertices outside vs
            counts = np.diff(subL.indptr)
            nz = counts > 0
            rowmax[nz] = np.maximum.reduceat(nbr_pos, subL.indptr[:-1][nz])
        pos[vs] = -1  # restore
        sep = rowmax >= mid
        S_ids, L_ids, R_ids = L[sep], L[~sep], vs[mid:]
        # elimination order: left part, right part, separator last
        stack.append((S_ids, True))
        if R_ids.size:
            stack.append((R_ids, False))
        if L_ids.size:
            stack.append((L_ids, False))
    return np.concatenate(out) if out else np.arange(n, dtype=np.int64)


def fill_reducing_ordering(K_lower: sp.csc_matrix, method: str = "auto") -> np.ndarray:
    """Symmetric fill-reducing ordering of the pattern of K (given as its
    lower triangle).  Returns perm with perm[k] = original index of the
    k-th pivot.

    "auto": nested dissection for large patterns (log-depth parallel
    assembly trees; see :func:`nested_dissection_ordering`), SuperLU's
    MMD_AT_PLUS_A in symmetric mode (the same minimum-degree family as the
    reference's AMD; qdldl.rs:905-922) for small ones.  Fallbacks:
    reverse Cuthill-McKee, then natural order.
    """
    n = K_lower.shape[0]
    if n == 0 or method == "natural":
        return np.arange(n, dtype=np.int64)
    pattern = (K_lower + K_lower.T).tocsc()
    if method == "nd" or (method == "auto" and n >= _ND_MIN_DIM):
        try:
            return nested_dissection_ordering(pattern)
        except Exception:
            pass
    if method in ("auto", "mmd"):
        try:
            import scipy.sparse.linalg as spl

            # values are irrelevant to perm_c (computed symbolically);
            # a strongly diagonally dominant proxy keeps the numeric
            # phase from erroring out
            proxy = pattern.copy()
            proxy.data = np.ones_like(proxy.data)
            proxy = (proxy + sp.eye(n, format="csc") * (2.0 * n)).tocsc()
            lu = spl.splu(
                proxy,
                permc_spec="MMD_AT_PLUS_A",
                diag_pivot_thresh=0.0,
                options=dict(SymmetricMode=True),
            )
            perm = np.asarray(lu.perm_c, np.int64)
            if np.unique(perm).size == n:
                return perm
        except Exception:
            pass
    try:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(
            reverse_cuthill_mckee(pattern.tocsr(), symmetric_mode=True), np.int64
        )
    except Exception:
        return np.arange(n, dtype=np.int64)


# --------------------------------------------------------------------------
# symbolic factorization (etree + full pattern)
# --------------------------------------------------------------------------

def symbolic_factor_csc(
    n: int, col_ptr: np.ndarray, row_idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symbolic Cholesky of a strictly-lower CSC pattern.

    Returns (parent, L_ptr, L_idx): the elimination tree and the full
    below-diagonal factor pattern in CSC form (rows sorted per column).
    Dispatches to the native C++ engine (``native/symbolic.cpp``) when it
    is built; the NumPy version otherwise.
    """
    from .. import native

    out = native.symbolic_factor_csc(n, col_ptr, row_idx)
    if out is not None:
        return out
    col_ptr = np.ascontiguousarray(col_ptr, np.int64)
    row_idx = np.ascontiguousarray(row_idx, np.int64)

    # NumPy version: per-column pattern merge up the elimination tree
    parent = np.full(n, -1, np.int64)
    children: List[List[int]] = [[] for _ in range(n)]
    patterns: List[np.ndarray] = [None] * n  # type: ignore
    for j in range(n):
        pat = row_idx[col_ptr[j] : col_ptr[j + 1]]
        for c in children[j]:
            cp = patterns[c]
            pat = np.union1d(pat, cp[cp != j])
        pat = np.unique(pat)
        patterns[j] = pat
        if pat.size:
            p = int(pat[0])
            parent[j] = p
            children[p].append(j)
    lnz = np.asarray([p.size for p in patterns], np.int64)
    L_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lnz, out=L_ptr[1:])
    L_idx = (
        np.concatenate(patterns) if n else np.zeros(0, np.int64)
    ).astype(np.int64)
    return parent, L_ptr, L_idx


# --------------------------------------------------------------------------
# supernodes
# --------------------------------------------------------------------------

@dataclasses.dataclass(slots=True)
class _SNode:
    cols: np.ndarray   # sorted pivot columns (permuted frame)
    rows: np.ndarray   # sorted update rows (all > cols.max())
    children: List[int]
    parent: int
    alive: bool = True


def _postorder(nodes: List[_SNode]) -> List[int]:
    order: List[int] = []
    roots = [i for i, nd in enumerate(nodes) if nd.parent < 0]
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        v, done = stack.pop()
        if done:
            order.append(v)
        else:
            stack.append((v, True))
            for c in reversed(nodes[v].children):
                stack.append((c, False))
    return order


def _panel_cells(c: int, r: int) -> int:
    """Cells in the lower trapezoidal panel of a front with c pivot
    columns and r total rows."""
    return c * r - (c * (c - 1)) // 2


def _merge_threshold(c_m: int, relax_frac: float) -> float:
    """Acceptable explicit-zero fraction for a merged panel of ``c_m``
    pivot columns.  Tuned for batched accelerators, where sequential tree
    depth costs far more than the extra flops of explicit zeros, so it
    merges much more readily than CPU-tuned (CHOLMOD) settings would."""
    if c_m <= 32:
        return 1.0
    if c_m <= 128:
        return 0.8
    if c_m <= 256:
        return 0.5
    return relax_frac


def _amalgamate(nodes: List[_SNode], max_cols: int, relax_frac: float) -> None:
    """Relaxed amalgamation (CHOLMOD-style): merge a child supernode into
    its parent when the cumulative explicit-zero fraction of the merged
    panel stays below a size-dependent threshold — small supernodes merge
    readily (per-front dispatch overhead dominates them), large
    ones only when nearly lossless.  Contracting assembly-tree edges is
    structurally safe: a child's update rows are a subset of its
    ancestors' columns."""
    # true (pre-fill) panel cells per node, tracked through merges
    nz = {
        i: float(_panel_cells(nd.cols.size, nd.cols.size + nd.rows.size))
        for i, nd in enumerate(nodes)
    }

    def threshold(c_m: int) -> float:
        return _merge_threshold(c_m, relax_frac)

    for s in _postorder(nodes):
        nd = nodes[s]
        if not nd.alive:
            continue
        p = nd.parent
        if p < 0:
            continue
        pn = nodes[p]
        c_m = nd.cols.size + pn.cols.size
        if c_m > max_cols:
            continue
        # set algebra on sorted arrays via C-level sort/searchsorted —
        # union1d/setdiff1d call overhead dominates the whole analysis on
        # patterns with many singleton supernodes (e.g. identity A blocks)
        m_cols = np.concatenate([nd.cols, pn.cols])  # disjoint column sets
        m_cols.sort()
        rows_u = np.concatenate([nd.rows, pn.rows])
        rows_u.sort()
        if rows_u.size:
            keep = np.empty(rows_u.size, bool)
            keep[0] = True
            np.not_equal(rows_u[1:], rows_u[:-1], out=keep[1:])
            rows_u = rows_u[keep]
            pos = np.searchsorted(m_cols, rows_u)
            pos[pos == m_cols.size] = 0  # clamp; compare catches mismatch
            m_rows = rows_u[m_cols[pos] != rows_u]
        else:
            m_rows = rows_u
        cells_m = _panel_cells(m_cols.size, m_cols.size + m_rows.size)
        nz_m = nz[s] + nz[p]
        zfrac = 1.0 - nz_m / max(cells_m, 1)
        if zfrac <= threshold(c_m):
            pn.cols = m_cols
            pn.rows = m_rows
            pn.children.remove(s)
            for c in nd.children:
                nodes[c].parent = p
            pn.children.extend(nd.children)
            nd.alive = False
            nz[p] = nz_m


def _build_schedule(N, parent, L_ptr, L_idx, max_cols, relax_frac):
    """Supernode schedule: (nodes, live, level_of).

    ``nodes`` maps node id -> _SNode for the surviving nodes; children
    lists reference surviving ids only.

    The JAX package's native fast path: fundamental-supernode boundaries,
    the split points of supernodes wider than ``max_cols``, per-node row
    patterns and the assembly-tree parents as flat arrays (a supernode's
    rows are a suffix of its first column's L pattern, which also holds for
    split chunks), numbered by first column; then the relaxed amalgamation
    over their postorder, through the native C++ engine
    (``native/symbolic.cpp:cl_amalgamate``) when it is built, else through
    :func:`_amalgamate`, which makes the same merge decisions on the same
    numbering, so the plans agree field for field whichever engine ran,
    also where supernodes are split (the JAX package's pure-Python fallback
    numbers split chunks last).
    """
    if N == 0:
        return {}, [], {}
    lnz = np.diff(L_ptr)
    chain = (parent[:-1] == np.arange(1, N)) & (lnz[:-1] == lnz[1:] + 1)
    starts = np.concatenate([[0], np.where(~chain)[0] + 1]).astype(np.int64)
    widths = np.diff(np.concatenate([starts, [N]]))
    wide = np.where(widths > max_cols)[0]
    if wide.size:
        extra = [
            np.arange(starts[i] + max_cols, starts[i] + widths[i], max_cols)
            for i in wide
        ]
        starts = np.sort(np.concatenate([starts] + extra))
    bounds = np.concatenate([starts, [N]])
    k = starts.size
    j0 = bounds[:-1]
    w = np.diff(bounds)

    # rows of node s = the suffix of column j0's L pattern past its own
    # pivot columns (exact for fundamental supernodes and split chunks)
    rbeg = L_ptr[j0] + (w - 1)
    rend = L_ptr[j0 + 1]

    snode_of = np.repeat(np.arange(k, dtype=np.int64), w)
    pcol = parent[bounds[1:] - 1]
    node_parent = np.where(
        pcol >= 0, snode_of[np.clip(pcol, 0, N - 1)], -1
    ).astype(np.int64)

    from .. import native

    post = native.postorder_forest(node_parent)  # None: no native engine
    if post is not None:
        return _amalgamate_native(N, bounds, rbeg, rend, L_idx, node_parent, post,
                                  max_cols, relax_frac)

    nodes = [
        _SNode(
            cols=np.arange(j0[s], bounds[s + 1], dtype=np.int64),
            rows=np.asarray(L_idx[rbeg[s]:rend[s]], np.int64),
            children=[],
            parent=int(node_parent[s]),
        )
        for s in range(k)
    ]
    for s in range(k):
        if node_parent[s] >= 0:
            nodes[node_parent[s]].children.append(s)
    _amalgamate(nodes, max_cols, relax_frac)

    live = [i for i, nd in enumerate(nodes) if nd.alive]
    level_of: Dict[int, int] = {}
    for s in _postorder(nodes):
        if not nodes[s].alive:
            continue
        kids = [level_of[c] for c in nodes[s].children]
        level_of[s] = (max(kids) + 1) if kids else 0
    return {i: nodes[i] for i in live}, live, level_of


def _amalgamate_native(N, bounds, rbeg, rend, L_idx, node_parent, post, max_cols,
                       relax_frac):
    """:func:`_build_schedule`'s amalgamation and levelization through the
    native engine, on the flat node arrays (the JAX package's native path);
    only the surviving nodes become Python objects."""
    from .. import native

    k = node_parent.shape[0]
    counts = rend - rbeg
    total = int(counts.sum())
    rows_ptr = np.zeros(k + 1, np.int64)
    np.cumsum(counts, out=rows_ptr[1:])
    if total:
        src = (
            np.arange(total, dtype=np.int64)
            - np.repeat(rows_ptr[:-1], counts)
            + np.repeat(rbeg, counts)
        )
        rows_idx = L_idx[src]
    else:
        rows_idx = np.zeros(0, np.int64)
    alive, ocp, oci, orp, ori, pout = native.amalgamate(
        bounds, np.arange(N, dtype=np.int64), rows_ptr, rows_idx, node_parent, post,
        max_cols, relax_frac,
    )

    nodes: Dict[int, _SNode] = {}
    live = [int(i) for i in np.where(alive)[0]]
    for i in live:
        nodes[i] = _SNode(
            cols=oci[ocp[i] : ocp[i + 1]].copy(),
            rows=ori[orp[i] : orp[i + 1]].copy(),
            children=[],
            parent=int(pout[i]),
        )
    for i in live:
        p = nodes[i].parent
        if p >= 0:
            nodes[p].children.append(i)

    # levelize bottom-up over the original postorder, skipping dead ids
    level_of: Dict[int, int] = {}
    for s in post:
        s = int(s)
        if not alive[s]:
            continue
        level_of.setdefault(s, 0)
        p = int(pout[s])
        if p >= 0:
            level_of[p] = max(level_of.get(p, 0), level_of[s] + 1)
    return nodes, live, level_of


# --------------------------------------------------------------------------
# level schedule + index maps
# --------------------------------------------------------------------------

_CPAD_MENU = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
_UPAD_MENU = (
    0, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
    1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384,
)


def _pad_to(v: int, menu) -> int:
    for x in menu:
        if v <= x:
            return x
    raise ValueError(f"front dimension {v} exceeds the padding menu")


@dataclasses.dataclass
class MFBucket:
    """One batch of same-padded fronts within a level.  All index arrays
    live in ``MFPlan.arrays`` under this bucket's key prefix."""

    c_pad: int
    u_pad: int
    k: int
    node_ids: List[int]
    # key names into MFPlan.arrays
    key: str
    # offset of this bucket's pivot block in the solve workspace (the
    # workspace orders pivot slots bucket-contiguously so the triangular
    # sweeps use dynamic slices instead of gathers/scatters)
    w_off: int = 0
    # offset of this bucket's fronts in the flat assembly workspace (all
    # fronts initialize from the KKT nonzeros with ONE global scatter;
    # each bucket then slices its [k·r_pad²] cells out)
    f_off: int = 0

    @property
    def r_pad(self) -> int:
        return self.c_pad + self.u_pad


@dataclasses.dataclass
class MFPlan:
    """Static schedule + index arrays for the numeric factorization."""

    N: int
    nnzL: int
    flops: float
    levels: List[List[MFBucket]]
    arrays: Dict[str, np.ndarray]
    # assembly instructions: per (level li, bucket bi) a list of groups
    # (src_level, src_bucket, src_key, dst_key) referencing arrays
    n_supernodes: int = 0
    # solve-workspace size: Σ k·c_pad over buckets + 1 trailing dummy slot
    W: int = 0
    # flat assembly-workspace size: Σ k·r_pad² over buckets
    total_cells: int = 0


# per-group budget of *extra* padded front cells accepted to merge
# different-sized fronts of a level into one batch (each bucket is a
# separate chain of launches on the device, whose time is dominated by
# their count, not flops, so fewer/fatter buckets win as long as the
# padding waste stays bounded: 4M cells and a comparable flop surcharge)
_MERGE_EXTRA_CELLS = 4_000_000


def _group_level(nodes, sids):
    """Group a level's supernodes into padded batches.  One bucket per
    level when the padding waste allows; large fronts open their own
    bucket rather than inflating small ones past the cell budget."""
    members = []
    for s in sids:
        nd = nodes[s]
        cp = _pad_to(nd.cols.size, _CPAD_MENU)
        up = _pad_to(nd.rows.size, _UPAD_MENU)
        members.append((cp + up, cp, up, s))
    members.sort(key=lambda t: (-t[0], -t[1], t[3]))
    out: List[list] = []
    for rp, cp, up, s in members:
        placed = False
        for g in out:
            gcp, gup = g[0]
            grp = gcp + gup
            extra = float(grp * grp - rp * rp)
            if cp <= gcp and up <= gup and g[2] + extra <= _MERGE_EXTRA_CELLS:
                g[1].append(s)
                g[2] += extra
                placed = True
                break
        if not placed:
            out.append([(cp, up), [s], 0.0])
    return [(shape, mem) for shape, mem, _ in out]


def analyze(
    K_lower: sp.csc_matrix,
    dsigns: np.ndarray,
    ordering: str = "auto",
    max_supernode_cols: int = 1024,
    relax_frac: float = 0.35,
) -> MFPlan:
    """Full symbolic analysis of a quasidefinite matrix given by its lower
    triangle (pattern only; ``K_lower.data`` may be anything).

    ``dsigns`` gives the expected sign of each pivot (+1/-1) for dynamic
    regularization (reference: qdldl.rs:517-527).
    """
    N = K_lower.shape[0]
    K_lower = K_lower.tocsc()
    K_lower.sort_indices()

    def _prepare(method):
        perm = fill_reducing_ordering(K_lower, method)
        inv = np.argsort(perm).astype(np.int64)

        # permuted lower pattern, with data = position into the caller's
        # canonical K_lower nonzero order
        coo = K_lower.tocoo()
        pr, pc = inv[coo.row], inv[coo.col]
        lo = np.minimum(pr, pc)
        hi = np.maximum(pr, pc)
        Kp = sp.csc_matrix(
            (np.arange(coo.nnz, dtype=np.int64), (hi, lo)), shape=(N, N)
        )
        Kp.sort_indices()
        kperm_map = Kp.data.astype(np.int64)  # Kvals_perm = Kvals[kperm_map]

        # strictly-lower pattern for the symbolic pass
        strict = sp.csc_matrix(Kp, copy=True)
        mask = strict.indices != np.repeat(
            np.arange(N), np.diff(strict.indptr)
        )
        s_idx = strict.indices[mask].astype(np.int64)
        s_cnt = np.zeros(N, np.int64)
        np.add.at(s_cnt, np.repeat(np.arange(N), np.diff(strict.indptr))[mask], 1)
        s_ptr = np.zeros(N + 1, np.int64)
        np.cumsum(s_cnt, out=s_ptr[1:])

        parent, L_ptr, L_idx = symbolic_factor_csc(N, s_ptr, s_idx)

        nodes, live, level_of = _build_schedule(
            N, parent, L_ptr, L_idx, max_supernode_cols, relax_frac
        )
        n_levels = (max(level_of.values()) + 1) if live else 0
        return perm, inv, Kp, kperm_map, nodes, live, level_of, n_levels

    prep = _prepare(ordering)
    # a deep schedule means a near-sequential (chain) elimination tree:
    # both the traced program size and the device critical path scale with
    # depth, so retry with nested dissection when minimum-degree produced
    # a chain (banded/path-structured patterns do this systematically)
    _MAX_AUTO_LEVELS = 32
    if ordering == "auto" and prep[-1] > _MAX_AUTO_LEVELS and N > 512:
        prep_nd = _prepare("nd")
        if prep_nd[-1] < prep[-1]:
            prep = prep_nd
    perm, inv, Kp, kperm_map, nodes, live, level_of, n_levels = prep

    dsigns_perm = np.asarray(dsigns, np.float64)[perm]

    arrays: Dict[str, np.ndarray] = {
        "perm": perm.astype(np.int32),
        "inv": inv.astype(np.int32),
        "kperm_map": kperm_map.astype(np.int32),
    }

    # bucket fronts per level
    levels: List[List[MFBucket]] = []
    # where each supernode's update matrix lives: sid -> (level, bucket, lane)
    u_slot: Dict[int, Tuple[int, int, int]] = {}
    nnzL = 0
    flops = 0.0
    # scratch: permuted-index -> front-local position for the current lane
    posmap = np.full(N, -1, np.int64)
    # per-bucket (src, dst) init pairs, merged into one global scatter below
    bucket_init: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    for li in range(n_levels):
        sids = [s for s in live if level_of[s] == li]
        lvl: List[MFBucket] = []
        for bi, ((cp, up), members) in enumerate(_group_level(nodes, sids)):
            key = f"L{li}B{bi}"
            k = len(members)
            rp = cp + up
            cols_g = np.full((k, cp), N, np.int32)
            rows_g = np.full((k, up), N, np.int32)
            signs = np.ones((k, cp), np.float64)
            init_src: List[np.ndarray] = []
            init_dst: List[np.ndarray] = []
            asm_groups: Dict[Tuple[int, int], List[Tuple[np.ndarray, np.ndarray]]] = {}
            for lane, s in enumerate(members):
                nd = nodes[s]
                c, u = nd.cols.size, nd.rows.size
                cols_g[lane, :c] = nd.cols
                rows_g[lane, :u] = nd.rows
                signs[lane, :c] = dsigns_perm[nd.cols]
                nnzL += _panel_cells(c, c + u)
                flops += float(c) * (c + u) * (c + u)
                # front row layout: pivot cols at 0..c-1, pad cols at
                # c..c_pad-1, update rows from c_pad (must match the
                # [c_pad | u_pad] split in the numeric kernels)
                posmap[nd.cols] = np.arange(c)
                posmap[nd.rows] = cp + np.arange(u)
                # all KKT entries of this lane's pivot columns, vectorized
                # over the ragged per-column ranges
                starts = Kp.indptr[nd.cols]
                counts = Kp.indptr[nd.cols + 1] - starts
                total = int(counts.sum())
                if total:
                    cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
                    src = (
                        np.arange(total, dtype=np.int64)
                        - np.repeat(cum0, counts)
                        + np.repeat(starts, counts)
                    )
                    lj_e = np.repeat(np.arange(c, dtype=np.int64), counts)
                    dst = (
                        lane * rp * rp
                        + posmap[Kp.indices[src]] * rp
                        + lj_e
                    )
                    init_src.append(src)
                    init_dst.append(dst)
                # extend-add from children.  The destination index of a
                # child update entry is separable — lane·rp² + pos[i]·rp
                # + pos[j] — so instead of a per-element scatter the
                # numeric factorization applies it as P·U·Pᵀ with a 0/1
                # row-selection matrix P built from ``rowpos`` — two
                # batched matrix products + one lane segment-sum per
                # (parent, child storage) pair, exact for 0/1 P.
                for ch in nd.children:
                    cnd = nodes[ch]
                    cu = cnd.rows.size
                    if cu == 0:
                        continue
                    sl, sb, slane = u_slot[ch]
                    cup = levels[sl][sb].u_pad
                    rowpos = np.full(cup, rp, np.int64)  # pad -> one_hot 0
                    rowpos[:cu] = posmap[cnd.rows]
                    asm_groups.setdefault((sl, sb), []).append(
                        (slane, lane, rowpos)
                    )
                posmap[nd.cols] = -1
                posmap[nd.rows] = -1
                u_slot[s] = (li, bi, lane)
            arrays[key + ":cols_g"] = cols_g
            arrays[key + ":rows_g"] = rows_g
            arrays[key + ":signs"] = signs
            # scatter maps sorted by destination (the JAX package's scatter
            # takes a faster path on sorted indices; the plan keeps its order)
            if init_src:
                isrc = np.concatenate(init_src)
                idst = np.concatenate(init_dst)
                order = np.argsort(idst, kind="stable")
                bucket_init[key] = (isrc[order], idst[order])
            else:
                z = np.zeros(0, np.int64)
                bucket_init[key] = (z, z)
            asm_list = []
            for (sl, sb), pairs in sorted(asm_groups.items()):
                # deterministic across the native/vectorized and pure-
                # Python pipelines: ties on parent lane break by child lane
                pairs.sort(key=lambda p: (p[1], p[0]))
                akey = f"{key}:asm{sl}_{sb}"
                arrays[akey + ":clanes"] = np.asarray(
                    [p[0] for p in pairs], np.int32
                )
                arrays[akey + ":planes"] = np.asarray(
                    [p[1] for p in pairs], np.int32
                )
                arrays[akey + ":rowpos"] = np.stack(
                    [p[2] for p in pairs]
                ).astype(np.int32)
                asm_list.append((sl, sb, akey))
            b = MFBucket(c_pad=cp, u_pad=up, k=k, node_ids=members, key=key)
            b.asm = asm_list  # type: ignore[attr-defined]
            lvl.append(b)
        levels.append(lvl)

    # --- flat assembly workspace -----------------------------------------
    # All fronts live consecutively in one flat buffer; initialization from
    # the KKT nonzeros is ONE globally-sorted scatter instead of one per
    # bucket (scatter dispatches dominate the factor at these sizes).
    total_cells = 0
    g_src: List[np.ndarray] = []
    g_dst: List[np.ndarray] = []
    for lvl in levels:
        for B in lvl:
            B.f_off = total_cells
            isrc, idst = bucket_init.pop(B.key)
            g_src.append(isrc)
            g_dst.append(idst + B.f_off)  # per-bucket maps are dst-sorted
            total_cells += B.k * B.r_pad * B.r_pad
    arrays["init_src_all"] = (
        np.concatenate(g_src).astype(np.int32) if g_src else np.zeros(0, np.int32)
    )
    arrays["init_dst_all"] = (
        np.concatenate(g_dst).astype(np.int32) if g_dst else np.zeros(0, np.int32)
    )

    # --- solve workspace layout ------------------------------------------
    # Pivot slots laid out bucket-contiguously (lane-major within a bucket)
    # so the triangular sweeps address each bucket's block with one
    # dynamic slice; only cross-level update-row contributions need real
    # gathers/scatters.  A trailing dummy slot absorbs every padded index.
    W = 0
    ws = np.full(N + 1, -1, np.int64)
    solve_cols: List[np.ndarray] = []
    for lvl in levels:
        for B in lvl:
            B.w_off = W
            cols = arrays[B.key + ":cols_g"].astype(np.int64).ravel()
            slots = W + np.arange(cols.size, dtype=np.int64)
            real = cols < N
            ws[cols[real]] = slots[real]
            solve_cols.append(cols)
            W += cols.size
    ws[N] = W  # dummy
    solve_cols.append(np.asarray([N], np.int64))
    W += 1
    solve_col = np.concatenate(solve_cols)
    perm_ext = np.concatenate([perm, [N]])
    arrays["solve_src"] = perm_ext[solve_col].astype(np.int32)
    arrays["solve_out"] = ws[inv].astype(np.int32)
    for lvl in levels:
        for B in lvl:
            rows = arrays[B.key + ":rows_g"].astype(np.int64)
            arrays[B.key + ":rows_w"] = ws[rows].astype(np.int32)

    return MFPlan(
        N=N,
        nnzL=int(nnzL),
        flops=float(flops),
        levels=levels,
        arrays=arrays,
        n_supernodes=len(live),
        W=int(W),
        total_cells=int(total_cells),
    )

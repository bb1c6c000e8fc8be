"""Chordal decomposition driver: sparsity analysis, the standard ("H")
problem augmentation, solution reversal and PSD completion.

reference: src/solver/chordal/chordal_info.rs, decomp/augment_standard.rs,
decomp/reverse_standard.rs, decomp/psd_completion.rs.

The port's copy of ``clarabel_tpu/chordal/decomp.py``.  All of this is
host-side work on NumPy data: it rewrites the problem before the solve on
the device and maps the solution back afterwards.  Decomposition replaces
each large sparse PSD cone with many small clique cones -- the reference's
mechanism for scaling problem dimension.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..cones import api
from ..cones.api import ConeSpec
from .merge import merge_cliques
from .sntree import SuperNodeTree
from .symbolic import find_graph


def _tri(k: int) -> int:
    return (k * (k + 1)) // 2


def _tri_index(i: int, j: int) -> int:
    """svec index of upper-triangle coordinate (i, j), i <= j."""
    return j * (j + 1) // 2 + i


@dataclasses.dataclass
class SparsityPattern:
    """Clique data for one decomposable PSD cone
    (reference: sparsity_pattern.rs)."""

    sntree: SuperNodeTree
    ordering: np.ndarray  # permuted vertex -> original vertex
    orig_index: int

    @classmethod
    def new(cls, L_cols, ordering, orig_index, merge_method):
        sntree = SuperNodeTree(L_cols)
        if sntree.n_cliques > 1:
            merge_cliques(sntree, merge_method)
        ordering = sntree.reorder_snode_consecutively(ordering)
        sntree.calculate_block_dimensions()
        return cls(sntree, ordering, orig_index)


class ChordalInfo:
    """reference: chordal_info.rs:51-135"""

    def __init__(self, A: np.ndarray, b: np.ndarray, cones: Tuple[ConeSpec, ...],
                 settings):
        self.init_dims = (A.shape[1], A.shape[0])
        self.init_cones = cones
        self.spatterns: List[SparsityPattern] = []
        self.H = None  # standard-transform matrix, set by decomp_augment
        self.cone_maps = None  # compact-transform clique map

        merge_method = settings.chordal_decomposition_merge_method

        # aggregate sparsity across the rows of [A; b]; A may be a scipy
        # sparse matrix (the sparse KKT path hands its CSR straight in —
        # nothing is densified)
        rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
        nz_mask = (rowsum != 0) | (b != 0)

        row = 0
        for coneidx, cone in enumerate(cones):
            w = cone.nvars
            if cone.kind == api.PSD and cone.dim > 1:
                mask = nz_mask[row : row + w].copy()
                n = cone.dim
                # diagonal entries must be structurally present
                for i in range(n):
                    mask[_tri_index(i, i)] = True
                if not mask.all():
                    L_cols, ordering = find_graph(mask, n)
                    sp = SparsityPattern.new(L_cols, ordering, coneidx, merge_method)
                    if sp.sntree.n_cliques > 1:
                        self.spatterns.append(sp)
            row += w

    @property
    def is_decomposed(self) -> bool:
        return bool(self.spatterns)

    # ------------------------------------------------------------------
    # augmentation dispatch (decomp/mod.rs:20-39)
    # ------------------------------------------------------------------

    def decomp_augment(self, P, q, A, b, settings):
        if settings.chordal_decomposition_compact:
            return self._decomp_augment_compact(P, q, A, b)
        return self._decomp_augment_standard(P, q, A, b)

    # ------------------------------------------------------------------
    # standard augmentation (augment_standard.rs)
    # ------------------------------------------------------------------

    def _decomp_augment_standard(self, P, q, A, b):
        """Rewrite (P, q, A, b, cones) with clique cones.

        Standard transform:  A_new = [[A, H], [0, -I]],  b_new = [b; 0],
        with the first m rows becoming equality constraints and each clique
        contributing a small PSD cone on the added variables.  Accepts and
        returns scipy-sparse matrices when given them (the sparse KKT path
        never densifies).
        """
        import scipy.sparse as sps

        self.cone_maps = None
        sparse = sps.issparse(A)
        H, cones_new = self._find_standard_H_and_cones(sparse=sparse)
        nH = H.shape[1]
        n = A.shape[1]

        q_new = np.concatenate([q, np.zeros(nH)])
        b_new = np.concatenate([b, np.zeros(nH)])
        if sparse:
            P_new = sps.block_diag(
                [sps.csc_matrix(P), sps.csc_matrix((nH, nH))], format="csc"
            )
            A_new = sps.bmat(
                [[sps.csr_matrix(A), H], [None, -sps.eye(nH, format="csr")]],
                format="csr",
            )
        else:
            P_new = np.zeros((n + nH, n + nH))
            P_new[:n, :n] = P
            A_new = np.block(
                [[A, np.asarray(H.todense())],
                 [np.zeros((nH, n)), -np.eye(nH)]]
            )

        self.H = H
        return P_new, q_new, A_new, b_new, tuple(cones_new)

    def _find_standard_H_and_cones(self, sparse=False):
        """reference: augment_standard.rs:63-121.  H is returned as a
        scipy-sparse one-hot column matrix (it has exactly one nonzero per
        column); the dense caller densifies it at assembly."""
        cones = self.init_cones
        n0, m0 = self.init_dims

        cones_new: List[ConeSpec] = [api.ZeroConeT(m0)]
        H_rows: List[int] = []

        patterns = list(self.spatterns)
        pat_idx = 0
        row = 0
        for coneidx, cone in enumerate(cones):
            if pat_idx < len(patterns) and patterns[pat_idx].orig_index == coneidx:
                sp = patterns[pat_idx]
                pat_idx += 1
                sntree = sp.sntree
                for i in range(sntree.n_cliques):
                    clique = sorted(sp.ordering[v] for v in sntree.get_clique(i))
                    for j in range(len(clique)):
                        for k in range(j + 1):
                            H_rows.append(
                                row + _tri_index(clique[k], clique[j])
                            )
                    cones_new.append(api.PSDTriangleConeT(sntree.get_nblk(i)))
            else:
                for i in range(cone.nvars):
                    H_rows.append(row + i)
                cones_new.append(cone)
            row += cone.nvars

        import scipy.sparse as sps

        nH = len(H_rows)
        H = sps.csr_matrix(
            (np.ones(nH), (np.asarray(H_rows, np.int64), np.arange(nH))),
            shape=(m0, nH),
        )
        return H, cones_new

    # ------------------------------------------------------------------
    # compact (clique-tree) augmentation (augment_compact.rs; Kim et al.
    # 2011 transform).  In the dense setting the CSC row-index surgery of
    # the reference reduces to direct row gathers: each clique block row
    # either copies the original constraint row for its (i, j) entry, or
    # introduces a fresh overlap variable u with a +1 in the clique row
    # and a -1 in the parent clique's matching row.
    # ------------------------------------------------------------------

    def _decomp_augment_compact(self, P, q, A, b):
        """Both input kinds supported: dense ndarrays or scipy sparse.

        The transform is collected as index lists — copied original rows
        and ±1 overlap entries — then assembled either densely or as
        ``S @ A`` with a one-hot row-selection matrix S plus a COO overlap
        block (the CSC-surgery-free analog of augment_compact.rs)."""
        import scipy.sparse as sps

        sparse = sps.issparse(A)
        n0, m0 = self.init_dims
        dim_new, n_overlaps = self._decomposed_dim_and_overlaps()

        copy_dst: List[int] = []   # new row index of each copied row
        copy_src: List[int] = []   # original row it copies
        ov_rows: List[int] = []    # overlap ±1 entries
        ov_cols: List[int] = []
        ov_vals: List[float] = []
        cones_new: List[ConeSpec] = []
        cone_maps: List[tuple] = []

        patterns = list(self.spatterns)
        pat_idx = 0
        row_ptr = 0  # into the new rows
        ucol = n0  # next overlap-variable column
        row = 0  # into the original rows

        for coneidx, cone in enumerate(self.init_cones):
            if pat_idx < len(patterns) and patterns[pat_idx].orig_index == coneidx:
                sp = patterns[pat_idx]
                t = sp.sntree

                # clique row starts, cliques emitted in descending
                # topological order (clique_rows_map, augment_compact.rs)
                clique_start = {}
                rp = row_ptr
                for i in range(t.n_cliques - 1, -1, -1):
                    clique_start[t.snode_post[i]] = rp
                    rp += _tri(t.get_nblk(i))

                for i in range(t.n_cliques - 1, -1, -1):
                    snode_g = sorted(sp.ordering[v] for v in t.get_snode(i))
                    sep_g = sorted(sp.ordering[v] for v in t.get_separators(i))
                    blocks = _block_indices(snode_g, sep_g)

                    if i < t.n_cliques - 1:
                        p_raw = t.snode_parent[t.snode_post[i]]
                        parent_start = clique_start[p_raw]
                        parent_clique = sorted(
                            sp.ordering[v]
                            for v in (t.snode[p_raw] | t.separators[p_raw])
                        )

                    for counter, (gi, gj, is_overlap) in enumerate(blocks):
                        nr = row_ptr + counter
                        if is_overlap:
                            # +1 here, -1 in the parent's matching entry
                            ov_rows.append(nr)
                            ov_cols.append(ucol)
                            ov_vals.append(1.0)
                            ir = parent_clique.index(gi)
                            jr = parent_clique.index(gj)
                            ov_rows.append(parent_start + _tri_index(ir, jr))
                            ov_cols.append(ucol)
                            ov_vals.append(-1.0)
                            ucol += 1
                        else:
                            copy_dst.append(nr)
                            copy_src.append(row + _tri_index(gi, gj))

                    nblk = t.get_nblk(i)
                    cones_new.append(api.PSDTriangleConeT(nblk))
                    cone_maps.append((coneidx, (pat_idx, i)))
                    row_ptr += _tri(nblk)
                pat_idx += 1
            else:
                w = cone.nvars
                copy_dst.extend(range(row_ptr, row_ptr + w))
                copy_src.extend(range(row, row + w))
                cones_new.append(cone)
                cone_maps.append((coneidx, None))
                row_ptr += w
            row += cone.nvars

        nadd = n_overlaps
        dst = np.asarray(copy_dst, np.int64)
        src = np.asarray(copy_src, np.int64)
        b_new = np.zeros(dim_new)
        b_new[dst] = b[src]
        if sparse:
            S = sps.csr_matrix(
                (np.ones(dst.size), (dst, src)), shape=(dim_new, m0)
            )
            A_left = (S @ sps.csr_matrix(A)).tocsr()
            A_right = sps.csr_matrix(
                (np.asarray(ov_vals),
                 (np.asarray(ov_rows, np.int64),
                  np.asarray(ov_cols, np.int64) - n0)),
                shape=(dim_new, nadd),
            )
            A_new = sps.hstack([A_left, A_right], format="csr")
            P_new = sps.block_diag(
                [sps.csc_matrix(P), sps.csc_matrix((nadd, nadd))],
                format="csc",
            )
        else:
            A_new = np.zeros((dim_new, n0 + nadd))
            A_new[dst, :n0] = A[src, :]
            A_new[ov_rows, ov_cols] = ov_vals
            P_new = np.zeros((n0 + nadd, n0 + nadd))
            P_new[:n0, :n0] = P
        q_new = np.concatenate([q, np.zeros(nadd)])

        self.H = None
        self.cone_maps = cone_maps
        return P_new, q_new, A_new, b_new, tuple(cones_new)

    def _decomposed_dim_and_overlaps(self):
        """Total rows and overlap count of the compact form
        (chordal_info.rs:199-221)."""
        dim = 0
        overlaps = 0
        patterns = list(self.spatterns)
        pat_idx = 0
        for coneidx, cone in enumerate(self.init_cones):
            if pat_idx < len(patterns) and patterns[pat_idx].orig_index == coneidx:
                d, o = patterns[pat_idx].sntree.get_decomposed_dim_and_overlaps()
                dim += d
                overlaps += o
                pat_idx += 1
            else:
                dim += cone.nvars
        return dim, overlaps

    # ------------------------------------------------------------------
    # reversal (reverse_standard.rs / reverse_compact.rs)
    # + completion (psd_completion.rs)
    # ------------------------------------------------------------------

    def decomp_reverse(self, x, z, s, settings):
        """Map the decomposed solution back to the original cones."""
        n, m = self.init_dims
        x_new = x[:n]

        if self.cone_maps is not None:
            z_new, s_new = self._reverse_compact(z, s)
        else:
            s_new = np.asarray(self.H @ s[m:]).ravel()
            z_new = np.asarray(self.H @ z[m:]).ravel()

            # average the overlapping dual entries (reverse_standard.rs:30-39)
            noverlaps = np.asarray(self.H.sum(axis=1)).ravel()
            mask = noverlaps > 1
            z_new[mask] /= noverlaps[mask]

        if settings.chordal_decomposition_complete_dual:
            self._psd_completion(z_new)

        return x_new, z_new, s_new

    def decomp_warm_start(self, x, s, z):
        """Forward-map a user-frame iterate (x, s, z) into the decomposed
        frame (the inverse direction of :meth:`decomp_reverse`), so warm
        starts compose with chordal decomposition.

        The map is a per-clique gather: each clique block takes the
        corresponding principal-submatrix entries of the user s/z.  For the
        standard transform the added variables get the exact split
        H·x_H = s (overlapping entries divided by their multiplicity); for
        the compact transform the overlap rows start at zero (consistent
        with zero overlap variables).  The IPM shifts (s, z) strictly into
        the cone interior before use (loop._shift_to_cone_interior), so the
        map only needs to carry the warm information, not interiority.
        The reference has no warm-start capability to mirror (SURVEY §5.4).
        """
        n0, m0 = self.init_dims
        if self.cone_maps is not None:
            return self._warm_start_compact(x, s, z)

        # standard transform: A_new = [[A, H], [0, -I]], rows = [Zero(m0),
        # cliques].  H is one-hot per column: column c touches row(c).
        H = self.H.tocsc()
        rows_of_col = H.indices  # one entry per column
        noverlaps = np.asarray(self.H.sum(axis=1)).ravel()
        s_add = s[rows_of_col] / noverlaps[rows_of_col]
        x_new = np.concatenate([x, s_add])  # x_H = s_add (rows force s=x_H)
        s_new = np.concatenate([np.zeros(m0), s_add])
        z_new = np.concatenate([z, z[rows_of_col]])
        return x_new, s_new, z_new

    def _warm_start_compact(self, x, s, z):
        """Compact (Kim et al.) forward map: every clique entry gathers the
        user value; s splits overlapping entries by their clique
        multiplicity so the reversal's sum reproduces the user s (z uses
        overwrite semantics, so the plain gather is already exact).
        Overlap variables start at zero."""
        n0, m0 = self.init_dims
        dim_new, n_overlaps = self._decomposed_dim_and_overlaps()

        ranges = []
        row = 0
        for cone in self.init_cones:
            ranges.append(row)
            row += cone.nvars

        # entry gather map (new row -> original row) and the original
        # entry behind each overlap variable, in the exact emission order
        # of _decomp_augment_compact
        src = np.zeros(dim_new, np.int64)
        u_src: List[int] = []
        row_ptr = 0
        for (orig_index, tc) in self.cone_maps:
            lo = ranges[orig_index]
            if tc is None:
                w = self.init_cones[orig_index].nvars
                src[row_ptr : row_ptr + w] = np.arange(lo, lo + w)
                row_ptr += w
            else:
                t_idx, clique_index = tc
                sp = self.spatterns[t_idx]
                t = sp.sntree
                snode_g = sorted(
                    sp.ordering[v] for v in t.get_snode(clique_index)
                )
                sep_g = sorted(
                    sp.ordering[v] for v in t.get_separators(clique_index)
                )
                for counter, (gi, gj, is_overlap) in enumerate(
                    _block_indices(snode_g, sep_g)
                ):
                    off = lo + _tri_index(gi, gj)
                    src[row_ptr + counter] = off
                    if is_overlap:
                        u_src.append(off)
                row_ptr += _tri(len(snode_g) + len(sep_g))

        # s gathers the FULL user value everywhere: each clique block is
        # then a principal submatrix of the user s — PSD by construction,
        # so the interiority shift stays small.  (A 1/multiplicity split
        # would make the reversal sum exact but Hadamard-scales the block,
        # which loses PSD-ness — measured to cost the warm start all of
        # its advantage.)  The homogeneous embedding absorbs the resulting
        # O(|s|) primal residual on the copy rows like any infeasible
        # start; the overlap rows are made exact via u = -s.
        s_new = s[src]
        z_new = z[src]
        u0 = np.asarray(u_src, np.int64)
        x_new = np.concatenate([x, -s[u0]])
        return x_new, s_new, z_new

    def _reverse_compact(self, z, s):
        """reference: reverse_compact.rs — s sums over overlapping clique
        entries; z overwrites them."""
        _, m0 = self.init_dims
        new_s = np.zeros(m0)
        new_z = np.zeros(m0)

        ranges = []
        row = 0
        for cone in self.init_cones:
            ranges.append(row)
            row += cone.nvars

        row_ptr = 0
        for (orig_index, tc) in self.cone_maps:
            lo = ranges[orig_index]
            if tc is None:
                w = self.init_cones[orig_index].nvars
                new_s[lo : lo + w] = s[row_ptr : row_ptr + w]
                new_z[lo : lo + w] = z[row_ptr : row_ptr + w]
                row_ptr += w
            else:
                t_idx, clique_index = tc
                sp = self.spatterns[t_idx]
                clique = sorted(
                    sp.ordering[v] for v in sp.sntree.get_clique(clique_index)
                )
                counter = 0
                for j in clique:
                    for i in clique:
                        if i <= j:
                            off = _tri_index(i, j)
                            new_s[lo + off] += s[row_ptr + counter]
                            new_z[lo + off] = z[row_ptr + counter]
                            counter += 1
                row_ptr += _tri(len(clique))
        return new_z, new_s

    def _psd_completion(self, z: np.ndarray) -> None:
        """PSD completion of the dual variable (Vandenberghe's chordal-graph
        algorithm; psd_completion.rs:36-133).  In-place on z."""
        row = 0
        ranges = []
        for cone in self.init_cones:
            ranges.append((row, row + cone.nvars))
            row += cone.nvars

        for sp in self.spatterns:
            lo, hi = ranges[sp.orig_index]
            zi = z[lo:hi]
            Z = _svec_to_mat(zi)
            _psd_complete(Z, sp)
            z[lo:hi] = _mat_to_svec(Z)


def _block_indices(snode, separator):
    """All (i, j, is_overlap) entries of a clique block, in the block's
    svec order (sorted by global column-major coordinate).

    reference: augment_compact.rs:get_block_indices — separator x separator
    entries are overlaps; everything else copies original data.
    """
    out = []
    for j in separator:
        for i in separator:
            if i <= j:
                out.append((i, j, True))
    for j in snode:
        for i in snode:
            if i <= j:
                out.append((i, j, False))
    for i in snode:
        for j in separator:
            out.append((min(i, j), max(i, j), False))
    out.sort(key=lambda t: (t[1], t[0]))
    return out


def _svec_to_mat(x: np.ndarray) -> np.ndarray:
    t = x.shape[0]
    n = int((np.sqrt(8 * t + 1) - 1) / 2)
    M = np.zeros((n, n))
    idx = 0
    isq2 = 1.0 / np.sqrt(2.0)
    for col in range(n):
        for r in range(col + 1):
            if r == col:
                M[r, col] = x[idx]
            else:
                M[r, col] = M[col, r] = x[idx] * isq2
            idx += 1
    return M


def _mat_to_svec(M: np.ndarray) -> np.ndarray:
    n = M.shape[0]
    out = np.zeros(_tri(n))
    idx = 0
    sq2 = np.sqrt(2.0)
    for col in range(n):
        for r in range(col + 1):
            out[idx] = M[r, col] if r == col else M[r, col] * sq2
            idx += 1
    return out


def _psd_complete(Am: np.ndarray, sp: SparsityPattern) -> None:
    """reference: psd_completion.rs:49-133"""
    sntree = sp.sntree
    p = np.asarray(sp.ordering, np.int64)
    ip = np.argsort(p)
    N = Am.shape[0]

    W = Am[np.ix_(p, p)]

    for j in range(sntree.n_cliques - 2, -1, -1):
        nu = sorted(sntree.get_snode(j))
        alpha = sorted(sntree.get_separators(j))
        i_rep = nu[0]
        in_alpha = set(alpha)
        in_nu = set(nu)
        eta = [x for x in range(i_rep + 1, N) if x not in in_alpha and x not in in_nu]
        if not eta or not alpha:
            continue

        Waa = W[np.ix_(alpha, alpha)]
        Wan = W[np.ix_(alpha, nu)]
        Wea = W[np.ix_(eta, alpha)]

        try:
            Y = np.linalg.solve(Waa, Wan)
        except np.linalg.LinAlgError:
            Y = np.linalg.pinv(Waa) @ Wan

        block = Wea @ Y
        W[np.ix_(eta, nu)] = block
        W[np.ix_(nu, eta)] = block.T

    Am[...] = W[np.ix_(ip, ip)]


def try_chordal_info(A, b, cones, settings) -> Optional[ChordalInfo]:
    """reference: problemdata.rs:352-381"""
    if not settings.chordal_decomposition_enable:
        return None
    if not any(c.kind == api.PSD and c.dim > 3 for c in cones):
        return None
    info = ChordalInfo(A, b, cones, settings)
    if not info.is_decomposed:
        return None
    return info

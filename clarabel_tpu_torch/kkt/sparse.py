"""Sparse KKT engine: pattern assembly maps + multifrontal factor/solve.

PyTorch port of ``clarabel_tpu/kkt/sparse.py``, with its compensated f32
products (``sym_matvec_df`` and the refinement matvecs' ``.df`` closures),
the counterpart of the reference's sparse KKT assembly and data maps
(reference: src/solver/core/kktsolvers/direct/quasidef/kkt_assembly.rs:20-183,
datamaps.rs): the quasidefinite matrix

    K = [ P   A^T ]
        [ A  -Hs  ]

is kept as its lower-triangle nonzero vector ``Kvals`` in the factor's
permuted CSC order.  The host (this module + :mod:`mf_symbolic`) runs once
at setup and produces flat scatter maps from each data source (tril(P)
entries, A entries, Hs block entries in the canonical order of
``cones.ops.hs_lower_coords``, sparse-cone expansion entries, and the full
diagonal for static regularization) into ``Kvals`` slots, plus the
multifrontal factorization plan.  Per IPM iteration the device
re-assembles ``Kvals`` with one scatter and refactors with
:func:`multifrontal.mf_factor` — the analog of the reference's "write -Hs
blocks, regularize, refactor" update (directldlkktsolver.rs:134-158,
217-264) with memory O(nnz(L)) instead of O((n+m)^2).

The sources of one assembly write distinct slots (checked at setup), so
every scatter here has unique destinations and repeats bit for bit on the
card.

Every device-side function takes one problem or a batch of B problems of
one pattern (``parallel.sparse_batch``): the sources then carry a leading
batch dimension (COO values ``[B, nnz]``, Hs values ``[B, entries]``), the
assembled values are ``[B, nnz(K)]``, the static regularization's ε is per
lane, and a matvec takes ``[B, N, r]`` (one problem's ``[N]`` or
``[N, r]``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..algebra.coo import dia_metadata, levels_to, segment_apply, segment_levels
from ..cones import ops as cone_ops
from . import compensated as _dfc
from . import mf_symbolic, multifrontal
from .dense import _amax0, _static_eps


#: SOC cones above this dimension use the rank-2 sparse expansion
#: (reference: socone.rs:46 SOC_NO_EXPANSION_MAX_SIZE = 4)
SOC_NO_EXPANSION_MAX_SIZE = 4

#: f32 keeps small cones dense (the JAX package's f32 thresholds; f64
#: takes the reference's)
SOC_NO_EXPANSION_MAX_SIZE_F32 = 256
GENPOW_NO_EXPANSION_MAX_SIZE_F32 = 256


@dataclasses.dataclass
class SparseKKT:
    """Static sparse-KKT structure: shapes, the multifrontal plan, and the
    NumPy index arrays behind the device data dict."""

    plan: mf_symbolic.MFPlan
    n: int
    m: int
    N: int  # n + m + pdim (sparse-cone expansion rows included)
    nnz: int
    np_arrays: Dict[str, np.ndarray]
    soc_expanded: tuple = ()
    genpow_expanded: bool = False
    #: layout carries nonsymmetric (exp/pow/genpow) cones: their Hessian
    #: blocks are ill-conditioned near the boundary, so the factor keeps
    #: substitution-form L11 inverses (see multifrontal._unit_lower_inverse)
    nonsym: bool = False
    #: static diagonal offsets of the DIA matvec layout (empty = fallback)
    dia_offsets: tuple = ()
    #: scatter-free DIA recipe (zero/NN layouts with DIA-compact P and A):
    #: per K offset, the static segments assembling its lane directly from
    #: P.kd / A.kd / the Hs diagonal — no per-iteration layout scatter
    dia_recipe: tuple = ()

    def device_data(self, dtype, device):
        """Every index array (plan + assembly maps) as tensors on
        ``device`` in one flat dict (integers int64, signs in ``dtype``),
        with the fixed-order levels of the segment-sum matvec."""
        out = multifrontal.device_arrays(self.plan, dtype, device, self.np_arrays)
        if not self.dia_offsets:
            a = self.np_arrays
            out["kkt:levels_low"] = levels_to(segment_levels(a["kkt:rows_sorted"], self.N), device)
            out["kkt:levels_up"] = levels_to(
                segment_levels(a["kkt:K_cols"][a["kkt:strict_sel"]], self.N), device)
        return out


def _unique(idx, what):
    """Host-side: raise unless the scatter destinations ``idx`` are
    distinct (the device scatters assign, they do not add)."""
    if np.unique(idx).size != idx.size:
        raise ValueError(f"internal error: {what} scatter has repeated destinations")


def build(layout, n, P_rows, P_cols, A_rows, A_cols, ordering="auto",
          max_supernode_cols=1024, dtype=None) -> SparseKKT:
    """Symbolic setup.  ``P_rows/P_cols`` are the coordinates of the FULL
    symmetric P in the device COO order; ``A_rows/A_cols`` those of the
    (cone-permuted) A.  reference: kkt_assembly.rs:20-52 (structure),
    qdldl.rs:433-464 + :905-922 (symbolic phase, via mf_symbolic).

    ``dtype`` tunes the sparse-cone expansion thresholds: f32 keeps small
    SOC/genpow cones as dense Hs blocks (see the *_F32 constants)."""
    m = layout.m

    # sparse-cone low-rank expansions: big SOCs get the rank-2 form,
    # genpow cones the rank-3 form (the reference always expands genpow;
    # genpowcone.rs:165-167 Hs_is_diagonal = true)
    is_f32 = dtype is not None and np.dtype(dtype) == np.float32
    soc_max = SOC_NO_EXPANSION_MAX_SIZE_F32 if is_f32 else SOC_NO_EXPANSION_MAX_SIZE
    soc_expanded = tuple(d > soc_max for d in layout.soc_dims)
    genpow_expanded = layout.num_genpow > 0 and not (
        is_f32
        and all(c.nvars <= GENPOW_NO_EXPANSION_MAX_SIZE_F32 for c in layout.genpow_cones)
    )

    hs_r, hs_c = cone_ops.hs_lower_coords(layout, soc_expanded, genpow_expanded)
    exp_r, exp_c, ext_signs = cone_ops.expansion_coords(layout, soc_expanded, genpow_expanded)
    pdim = ext_signs.shape[0]
    N = n + m + pdim

    P_tril_sel = np.where(P_rows >= P_cols)[0].astype(np.int64)
    diag = np.arange(N, dtype=np.int64)

    groups_r = [P_rows[P_tril_sel], A_rows + n, hs_r + n, exp_r + n, diag]
    groups_c = [P_cols[P_tril_sel], A_cols, hs_c + n, exp_c + n, diag]
    lens = [len(g) for g in groups_r]
    all_r = np.concatenate(groups_r).astype(np.int64)
    all_c = np.concatenate(groups_c).astype(np.int64)
    if np.any(all_r < all_c):
        raise ValueError("internal error: upper-triangle KKT contribution")

    # canonical CSC order: sort by (col, row)
    key = all_c * N + all_r
    uniq, inverse = np.unique(key, return_inverse=True)
    nnz = uniq.shape[0]
    K_rows = (uniq % N).astype(np.int64)
    K_cols = (uniq // N).astype(np.int64)

    off = np.cumsum([0] + lens)
    map_P = inverse[off[0]: off[1]].astype(np.int64)
    map_A = inverse[off[1]: off[2]].astype(np.int64)
    map_hs = inverse[off[2]: off[3]].astype(np.int64)
    map_exp = inverse[off[3]: off[4]].astype(np.int64)
    map_diag = inverse[off[4]: off[5]].astype(np.int64)
    _unique(np.concatenate([map_P, map_A, map_hs, map_exp]), "KKT assembly")

    # lower-triangle CSC pattern for the symbolic engine (values unused)
    counts = np.bincount(K_cols, minlength=N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    K_low = sp.csc_matrix((np.ones(nnz), K_rows, indptr), shape=(N, N))

    # expected pivot signs: +1 variables, -1 constraints, per-expansion
    # extras (directldlkktsolver.rs:392-405, datamaps.rs Dsigns)
    dsigns = np.concatenate([np.ones(n), -np.ones(m), ext_signs])

    plan = mf_symbolic.analyze(
        K_low, dsigns, ordering=ordering, max_supernode_cols=max_supernode_cols
    )

    # Assemble Kvals directly in the factor's permuted CSC order: composing
    # the fill-reducing permutation into the assembly maps here removes a
    # per-refactor device gather Kvals[kperm_map].
    kperm = plan.arrays.pop("kperm_map").astype(np.int64)
    inv_kperm = np.empty_like(kperm)
    inv_kperm[kperm] = np.arange(nnz, dtype=np.int64)
    map_P = inv_kperm[map_P]
    map_A = inv_kperm[map_A]
    map_hs = inv_kperm[map_hs]
    map_exp = inv_kperm[map_exp]
    map_diag = inv_kperm[map_diag]
    K_rows = K_rows[kperm]
    K_cols = K_cols[kperm]
    # column-sorted strict-lower selection: the fallback matvec's transpose
    # sum runs by column
    strict_sel = np.where(K_rows != K_cols)[0].astype(np.int64)
    strict_sel = strict_sel[np.argsort(K_cols[strict_sel], kind="stable")]

    # row-sorted view of the nonzeros for the symmetric matvec's first sum
    row_order = np.argsort(K_rows, kind="stable").astype(np.int64)

    np_arrays = {
        "kkt:map_P": map_P,
        "kkt:map_A": map_A,
        "kkt:map_hs": map_hs,
        "kkt:map_exp": map_exp,
        "kkt:map_diag": map_diag,
        "kkt:P_tril_sel": P_tril_sel,
        "kkt:K_rows": K_rows,
        "kkt:K_cols": K_cols,
        "kkt:strict_sel": strict_sel,
        "kkt:dsigns": dsigns,
        "kkt:row_order": row_order,
        "kkt:rows_sorted": K_rows[row_order],
        "kkt:cols_of_sorted": K_cols[row_order],
    }

    # DIA (diagonal-offset) layout of the FULL symmetric pattern for the
    # refinement matvec: one scatter per KKT assembly lays K out by
    # diagonal offset, after which every matvec is y += K_dia[o] *
    # shift(x, o) with fixed shifts (banded/MPC patterns have a handful of
    # offsets).  Patterns with many distinct offsets keep the segment-sum
    # fallback.
    fr = np.concatenate([K_rows, K_cols[strict_sel]]).astype(np.int64)
    fc = np.concatenate([K_cols, K_rows[strict_sel]]).astype(np.int64)
    fslot = np.concatenate([np.arange(nnz, dtype=np.int64), strict_sel])
    uoff = np.unique(fc - fr)
    dia_offsets: tuple = ()
    if uoff.size and uoff.size <= 96 and uoff.size * N <= max(8 * fr.size, 1 << 20):
        oidx = np.searchsorted(uoff, fc - fr)
        dia_pos = oidx * N + fr
        order = np.argsort(dia_pos)
        np_arrays["kkt:dia_pos"] = dia_pos[order]
        np_arrays["kkt:dia_src"] = fslot[order]
        dia_offsets = tuple(int(o) for o in uoff)

    # scatter-free DIA recipe: for zero/NN layouts, K's full-symmetric DIA
    # lanes decompose exactly into P's and A's (already materialized by
    # COOMat.predia) plus the Hs diagonal
    dia_recipe: tuple = ()
    only_zero_nn = (
        layout.m_soc == 0 and layout.num_exp == 0 and layout.num_pow == 0
        and layout.num_genpow == 0 and layout.num_psd == 0
    )
    if dia_offsets and pdim == 0 and only_zero_nn:
        dia_recipe = _build_dia_recipe(dia_offsets, n, m, N, layout,
                                       P_rows, P_cols, A_rows, A_cols)

    if dia_recipe:
        # fused assembly: with the recipe matvec covering refinement, Kvals
        # is never needed — sources scatter STRAIGHT into the multifrontal
        # assembly workspace (map composition through the per-slot front
        # cell).  The JAX package adds sources and regularization in one
        # scatter-add; here the sources assign their (distinct) cells and
        # the regularization is added to the diagonal cells after them, the
        # same sums in the same order.
        cell_of_slot = np.empty(nnz, np.int64)
        cell_of_slot[plan.arrays["init_src_all"]] = plan.arrays["init_dst_all"]
        src_slots = np.concatenate([map_P, map_A, map_hs, map_exp])
        np_arrays["fuse:cells"] = cell_of_slot[src_slots]
        np_arrays["fuse:diag_cells"] = cell_of_slot[map_diag]
        _unique(np_arrays["fuse:cells"], "fused assembly")
        # |diag K| contributions for the static-regularization magnitude:
        # indices into the concatenated source-value vector (each diag slot
        # receives at most one contribution, so max over entries equals
        # max over summed slots)
        nP = P_tril_sel.size
        nA = A_rows.size
        pdiag = np.where(P_rows[P_tril_sel] == P_cols[P_tril_sel])[0]
        hsdiag = np.where(hs_r == hs_c)[0] + nP + nA
        expdiag = np.where(exp_r == exp_c)[0] + nP + nA + hs_r.size
        np_arrays["fuse:absdiag_sel"] = np.concatenate([pdiag, hsdiag, expdiag]).astype(np.int64)

    return SparseKKT(
        plan=plan, n=n, m=m, N=N, nnz=nnz, np_arrays=np_arrays,
        soc_expanded=soc_expanded, genpow_expanded=genpow_expanded,
        dia_offsets=dia_offsets,
        nonsym=bool(layout.num_exp or layout.num_pow or layout.num_genpow),
        dia_recipe=dia_recipe,
    )


def _build_dia_recipe(dia_offsets, n, m, N, layout, P_rows, P_cols, A_rows, A_cols):
    """Host-side: per K offset, the static segments assembling its lane
    from P.kd / A.kd / -hs_diag.  Returns () when P or A is not
    DIA-compact or the derived offset set disagrees with the K pattern's
    (then the scatter fallback stays)."""
    P_offs, _ = dia_metadata(P_rows, P_cols, (n, n))
    A_offs, _ = dia_metadata(A_rows, A_cols, (m, n))
    if P_offs is None or A_offs is None:
        return ()
    derived = set(P_offs)
    for oA in A_offs:
        derived.add(oA - n)   # A block: K row n+i, col i+oA
        derived.add(n - oA)   # mirrored Aᵀ block
    derived.add(0)            # Hs diagonal (may be absent if m == n_zero)
    if not set(dia_offsets) <= derived:
        return ()

    recipe = []
    for o in dia_offsets:
        segs = []
        if o in P_offs:
            # K rows [0, n): P's own lane
            segs.append(("P", P_offs.index(o), 0, n, 0))
        if (o + n) in A_offs:
            # lower A block: K rows [n, n+m)
            segs.append(("Alow", A_offs.index(o + n), n, m, 0))
        if (n - o) in A_offs:
            # mirrored block: K row j = i + oA carries A.kd[oA][i];
            # valid while 0 <= j < n and 0 <= i < m
            oA = n - o
            j0 = max(0, oA)
            j1 = min(n, oA + m)
            if j1 > j0:
                segs.append(("Amir", A_offs.index(oA), j0, j1 - j0, j0 - oA))
        if o == 0 and layout.n_nn:
            # Hs diagonal: NN rows are the contiguous tail after the
            # zero-cone block (row order groups cones by kind)
            segs.append(("Hs", 0, n + layout.n_zero, layout.n_nn, 0))
        recipe.append((int(o), tuple(segs)))
    return tuple(recipe)


# ----------------------------------------------------------------------
# device-side operations
# ----------------------------------------------------------------------

def _regularization(settings):
    """Dynamic regularization (eps, delta): thresholds that never fire
    when it is off (delta 1.0, the sparse path's convention)."""
    if settings.dynamic_regularization_enable:
        return settings.dynamic_regularization_eps, settings.dynamic_regularization_delta
    return -float("inf"), 1.0


def assemble(ctx: SparseKKT, data, P, A, hs_vals, exp_vals, settings):
    """(K_true_vals, K_reg_vals) in the factor's CSC order.  ``P``/``A``
    are COOMat (P full-symmetric) in the exact COO order given to
    :func:`build`; ``exp_vals`` the sparse-cone expansion entries.  Static
    regularization by expected sign mirrors directldlkktsolver.rs:217-264,
    its ε taken over each lane's own diagonal.  All sources assemble with
    one scatter."""
    batch = P.data.shape[:-1]
    vals = [P.data[..., data["kkt:P_tril_sel"]], A.data]
    idx = [data["kkt:map_P"], data["kkt:map_A"]]
    if hs_vals.shape[-1]:
        vals.append(-hs_vals)
        idx.append(data["kkt:map_hs"])
    if exp_vals.shape[-1]:
        # expansion entries carry their own signs (datamaps.rs update fns)
        vals.append(exp_vals)
        idx.append(data["kkt:map_exp"])
    K = torch.zeros(batch + (ctx.nnz,), dtype=P.data.dtype, device=P.data.device)
    K[..., torch.cat(idx)] = torch.cat(vals, dim=-1)

    if settings.static_regularization_enable:
        md = data["kkt:map_diag"]
        dvals = K[..., md]
        K_reg = K.clone()
        eps = _static_eps(settings, _amax0(dvals), 0.0)
        K_reg[..., md] = dvals + data["kkt:dsigns"] * eps.unsqueeze(-1)
    else:
        K_reg = K
    return K, K_reg


def sym_matvec(ctx: SparseKKT, data, Kvals, v):
    """y = K v with K given by its lower-triangle values (for iterative
    refinement against the unregularized K; directldlkktsolver.rs:266-321).
    ``v`` may be [N] or [N, r] (multi-RHS refinement), or [B, N, r] with
    ``Kvals [B, nnz]``.

    Two fixed-order segment sums: the lower-triangle term through a
    row-sorted gather of the nonzeros, the transpose term through the
    column-sorted strict selection.  Prefer :func:`make_matvec` where one
    Kvals vector serves several products."""
    rows = data["kkt:K_rows"]
    gather, per_entry, dim = _gathers(v)
    Kr = Kvals[..., data["kkt:row_order"]]
    y = segment_apply(data["kkt:levels_low"],
                      per_entry(Kr) * gather(v, data["kkt:cols_of_sorted"]), dim=dim)
    ssel = data["kkt:strict_sel"]
    return y + segment_apply(data["kkt:levels_up"],
                             per_entry(Kvals[..., ssel]) * gather(v, rows[ssel]), dim=dim)


def _gathers(v):
    """(gather, per_entry, dim) of the segment products for ``v``: [N] sums
    along dimension 0, [N, r] and a batch's [B, N, r] along -2 with the
    values broadcast over the columns."""
    if v.dim() == 1:
        return (lambda u, idx: u[idx]), (lambda t: t), 0
    return (lambda u, idx: u[..., idx, :]), (lambda t: t.unsqueeze(-1)), -2


def sym_matvec_df(ctx: SparseKKT, data, Kvals, v, v_lo=None):
    """Compensated y = K (v + v_lo) as a double-float (hi, lo) pair, in the
    shapes :func:`sym_matvec` takes (``v_lo`` of v's shape, or None).

    The expanded cones' extension rows are long cancelling sums of
    η-scaled entries (datamaps.rs:199-221 semantics): a plain f32 segment
    sum floors their residual at eps·Σ|K||v| per row, the "Known f32 tier"
    accuracy wall of the rank-2/3 expansions.  Exact products and the
    limb-split segment sums (``compensated.seg_sum_df``) remove that wall
    from the refinement residual.  The JAX package's kkt/sparse.py:404-436,
    which maps its columns one at a time; here they ride together."""
    rows = data["kkt:K_rows"]
    gather, per_entry, dim = _gathers(v)

    def half(Kv, idx, seg_ids, levels):
        p, e = _dfc._two_prod(Kv, gather(v, idx))
        if v_lo is not None:
            e = e + Kv * gather(v_lo, idx)
        return _dfc.seg_sum_df(p, e, seg_ids, levels, dim=dim)

    h1, l1 = half(per_entry(Kvals[..., data["kkt:row_order"]]), data["kkt:cols_of_sorted"],
                  data["kkt:rows_sorted"], data["kkt:levels_low"])
    ssel = data["kkt:strict_sel"]
    h2, l2 = half(per_entry(Kvals[..., ssel]), rows[ssel], data["kkt:K_cols"][ssel],
                  data["kkt:levels_up"])
    hi, err = _dfc._two_sum(h1, h2)
    return hi, err + l1 + l2


def make_matvec(ctx: SparseKKT, data, Kvals):
    """Returns v -> K v for iterative refinement, amortized over the
    several products per assembled Kvals (the IPM does ~4 per iteration),
    with its compensated product v, v_lo -> (hi, lo) as the ``.df``
    attribute (the refinement's residual on f32 systems).

    DIA fast path: one scatter lays K out by diagonal offset; each product
    is then Σ_o K_dia[o] ⊙ shift(v, o) with fixed shifts.  Patterns without
    a compact offset set fall back to the segment path.
    """
    offs = ctx.dia_offsets
    if not offs:
        def mv_seg(v):
            return sym_matvec(ctx, data, Kvals, v)

        mv_seg.df = lambda v, v_lo=None: sym_matvec_df(ctx, data, Kvals, v, v_lo)
        return mv_seg
    O, N = len(offs), ctx.N
    batch = Kvals.shape[:-1]
    Kd = torch.zeros(batch + (O * N,), dtype=Kvals.dtype, device=Kvals.device)
    Kd[..., data["kkt:dia_pos"]] = Kvals[..., data["kkt:dia_src"]]
    return _dia_mv(Kd.reshape(batch + (O, N)), offs, N)


def _dia_mv(Kd, offs, N):
    """The DIA product closure v -> K v: ``Kd [O, N]`` takes v [N] or
    [N, r], a batch's ``Kd [B, O, N]`` takes v [B, N, r].  The offset loop
    is a fixed small accumulation chain, so TwoProd/TwoSum
    (``kkt/compensated.py``) carry its rounding exactly: the closure's
    ``.df`` (v, v_lo) -> (hi, lo) is the compensated product that the
    refinement of f32 sparse systems evaluates residuals with (the JAX
    package's kkt/sparse.py:495-517)."""
    lo = max(0, -min(offs))
    hi = max(0, max(offs))

    def columns(v):
        if (v.dim() == 3) != (Kd.dim() == 3):
            raise ValueError(f"the DIA matvec of K {tuple(Kd.shape)} takes v "
                             f"{'[B, N, r]' if Kd.dim() == 3 else '[N] or [N, r]'}, "
                             f"got {tuple(v.shape)}")
        return v[:, None] if v.dim() == 1 else v

    def shifted(vp, o):
        return vp[..., lo + o: lo + o + N, :]

    def mv(v):
        single = v.dim() == 1
        v = columns(v)
        vp = F.pad(v, (0, 0, lo, hi))
        acc = torch.zeros_like(v)
        for i, o in enumerate(offs):
            acc = acc + Kd[..., i, :, None] * shifted(vp, o)
        return acc[:, 0] if single else acc

    def mv_df(v, v_lo=None):
        single = v.dim() == 1
        v = columns(v)
        vp = F.pad(v, (0, 0, lo, hi))
        vlp = None if v_lo is None else F.pad(columns(v_lo), (0, 0, lo, hi))
        acc_h, acc_l = torch.zeros_like(v), torch.zeros_like(v)
        for i, o in enumerate(offs):
            kd = Kd[..., i, :, None]
            p, e = _dfc._two_prod(kd, shifted(vp, o))
            if vlp is not None:
                e = e + kd * shifted(vlp, o)
            acc_h, e2 = _dfc._two_sum(acc_h, p)
            acc_l = acc_l + e + e2
        return (acc_h[:, 0], acc_l[:, 0]) if single else (acc_h, acc_l)

    mv.df = mv_df
    return mv


def make_matvec_sources(ctx: SparseKKT, P, A, hs_vals):
    """Scatter-free refinement matvec for zero/NN layouts: K's DIA lanes
    assemble directly from the already-materialized ``P.kd`` / ``A.kd``
    and the Hs diagonal by the static :func:`_build_dia_recipe` segments —
    pads and adds, no per-iteration layout scatter."""
    N = ctx.N
    dtype = hs_vals.dtype if hs_vals.numel() else P.data.dtype
    device = P.data.device
    batch = P.data.shape[:-1]

    lanes = []
    for o, segs in ctx.dia_recipe:
        lane = torch.zeros(batch + (N,), dtype=dtype, device=device)
        for spec in segs:
            kind, lane_idx, row0 = spec[0], spec[1], spec[2]
            if kind == "P":
                seg = P.kd[..., lane_idx, :]
            elif kind == "Alow":
                seg = A.kd[..., lane_idx, :]
            elif kind == "Amir":
                src0, length = spec[4], spec[3]
                seg = A.kd[..., lane_idx, src0: src0 + length]
            else:  # Hs diagonal (negated block of K)
                seg = -hs_vals
            lane = lane + F.pad(seg, (row0, N - row0 - seg.shape[-1]))
        lanes.append(lane)
    return _dia_mv(torch.stack(lanes, dim=-2), ctx.dia_offsets, N)


def factor_fused(ctx: SparseKKT, data, P, A, hs_vals, exp_vals, settings):
    """Fused assembly + numeric refactorization for layouts with a DIA
    recipe: source values scatter straight into the multifrontal assembly
    workspace ("fuse:cells" composes the Kvals slot and front-cell maps),
    with static regularization added to the diagonal cells — the Kvals
    vector is never materialized (the recipe matvec serves refinement).
    Semantics identical to assemble()+factor(); a batch's workspace is
    ``[B, total_cells]`` and its ε per lane."""
    dtype, device = P.data.dtype, P.data.device
    batch = P.data.shape[:-1]
    vals = [P.data[..., data["kkt:P_tril_sel"]], A.data]
    if hs_vals.shape[-1]:
        vals.append(-hs_vals)
    if exp_vals.shape[-1]:
        vals.append(exp_vals)
    vals = torch.cat(vals, dim=-1)
    if settings.static_regularization_enable:
        eps = _static_eps(settings, _amax0(vals[..., data["fuse:absdiag_sel"]]), 0.0)
        reg = data["kkt:dsigns"] * eps.unsqueeze(-1)
    else:
        reg = torch.zeros(ctx.N, dtype=dtype, device=device)
    finit = torch.zeros(batch + (ctx.plan.total_cells,), dtype=dtype, device=device)
    finit[..., data["fuse:cells"]] = vals
    dc = data["fuse:diag_cells"]
    finit[..., dc] = finit[..., dc] + reg
    eps, delta = _regularization(settings)
    return multifrontal.mf_factor(ctx.plan, data, None, eps, delta,
                                  stable_inverse=ctx.nonsym, finit=finit)


def factor(ctx: SparseKKT, data, K_reg_vals, settings):
    """Numeric multifrontal refactorization (qdldl.rs:468-700 analog).
    Dynamic per-pivot regularization uses the expected-sign rule
    (qdldl.rs:517-527); disabled -> thresholds that never fire."""
    eps, delta = _regularization(settings)
    return multifrontal.mf_factor(ctx.plan, data, K_reg_vals, eps, delta,
                                  stable_inverse=ctx.nonsym)


def solve(ctx: SparseKKT, data, factors, rhs):
    return multifrontal.mf_solve(ctx.plan, data, factors, rhs)

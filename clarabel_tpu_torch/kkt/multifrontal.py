"""Numeric multifrontal sparse LDLᵀ: factorization and solves.

PyTorch port of ``clarabel_tpu/kkt/multifrontal.py``, the numeric
counterpart of the reference's QDLDL numeric factorization (reference:
src/qdldl/qdldl.rs:468-700): per-pivot dynamic regularization with expected
signs (:517-527) carries over exactly, but the scalar up-looking loop is a
*levelized batched multifrontal* scheme prepared by :mod:`.mf_symbolic`:

  - every level of the supernodal assembly tree is a batch of independent
    fronts, grouped into padded-size buckets;
  - fronts initialize from the KKT nonzeros with one flat scatter; child
    update matrices extend-add as P·U·Pᵀ with 0/1 row-selection matrices
    (two batched matrix products and a fixed-order sum over the children
    of each front);
  - the partial factorization of a [k, r, r] front batch runs over pivot
    panels of ≤128 columns, each in blocks of ≤32 columns: a block's
    pivots come from an LDLᵀ of its diagonal block (:func:`_diag_factor`),
    the rows below it from a triangular solve, and the trailing Schur
    update is a batched matrix product;
  - the triangular solves run the same level schedule with batched
    products by precomputed unit-lower inverses (or triangular solves).

On a CUDA tensor the diagonal blocks of a bucket are factored by one
launch of the hand-written ``ldl_unblocked_kernel`` (``csrc/ldl.cu``, the
port of the TPU kernels K2/K3) over all the bucket's fronts, each front
with its own pivot signs; on a CPU tensor by the JAX package's pivot scan
written as a torch loop (its plain twin here).  Only the lower triangles of
fronts carry valid data throughout; pad pivots regularize to ``delta`` and
their L columns stay zero, so padded fronts factor to the same answers as
unpadded ones.

The sums over children (the extend-add and its counterpart in the solve)
add in a fixed order (``algebra.coo.segment_apply``), so a factorization
on the card repeats bit for bit.

A batch of B problems of one pattern (``parallel.sparse_batch``) shares
the plan: the assembly workspace is ``[B, total_cells]``, each bucket's
fronts ``[B, k, r, r]``, and the partial factorization runs on the bucket
flattened to ``[B·k, r, r]`` with the plan's ``[k, c]`` signs tiled to
``[B·k, c]`` (one copy per bucket and factor) -- so one kernel launch per
diagonal block serves every lane, and the launch count of a factor does not
grow with B.  ``ok`` and the
pivots are per lane; the solves take ``[B, N, r]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..algebra.coo import levels_to, segment_apply, segment_levels
from . import pallas_ldl

_PANEL = 128
_BLOCK = 32
#: pivot blocks up to this width get their unit-lower inverse precomputed
#: at factor time, turning each triangular sweep of the solves into one
#: batched matrix product.  One factor serves ~4-6 solves per IPM
#: iteration, so trading a little factor work for cheaper solves wins.
_INV_MAX_C = 256


def _unit_lower_inverse(L, stable=False):
    """Inverse of a batch of unit-lower matrices stored as their
    strictly-lower part N (zeros at and above the diagonal).

    Default: N is nilpotent with index ≤ c, so (I+N)⁻¹ = Σ (−N)ʲ factors
    exactly into the Neumann product (I+M)(I+M²)(I+M⁴)··· with M = −N:
    ⌈log₂ c⌉ rounds of batched matrix products.

    ``stable=True`` keeps the substitution form: on ill-conditioned
    nonsymmetric-cone (exp/pow) Hessian blocks the Neumann product's
    accumulated rounding costs a digit (the JAX package measured its f32
    solves regressing); symmetric-cone NT scalings have bounded
    conditioning and take the fast form."""
    k, c, _ = L.shape
    eye = torch.eye(c, dtype=L.dtype, device=L.device).expand(k, c, c)
    if stable:
        return torch.linalg.solve_triangular(L, eye, upper=False, unitriangular=True)
    M = -L
    acc = eye + M
    span = 2
    while span < c:
        M = M @ M
        acc = acc + acc @ M
        span *= 2
    return acc


def _diag_factor_scan(D, signs, eps, delta):
    """LDLᵀ of a batch of ``b×b`` diagonal blocks (lower triangles valid):
    the JAX package's pivot scan as a torch loop, the plain twin of the
    kernel route (CPU tensors only).

    Returns (L, d): unit-lower ``L`` with zeros at and above the diagonal
    and the regularized pivots ``d``.  Per-pivot dynamic regularization
    with expected signs mirrors qdldl.rs:517-527: d·sign < eps → d =
    delta·sign.
    """
    k, b, _ = D.shape
    rows = torch.arange(b, device=D.device)
    ls, ds = [], []
    for t in range(b):
        colj = D[:, :, t]  # [k, b]
        dj = colj[:, t]
        sg = signs[:, t]
        dj = torch.where(dj * sg < eps, delta * sg, dj)
        below = rows > t
        l = torch.where(below, colj / dj[:, None], 0.0)
        # rank-1 update of later columns: D[:, i, t'] -= l_i · colj[t']
        rowvals = torch.where(below, colj, 0.0)
        D = D - l[:, :, None] * rowvals[:, None, :]
        ls.append(l)
        ds.append(dj)
    return torch.stack(ls, dim=2), torch.stack(ds, dim=1)  # L: [k,b,b], d: [k,b]


def _diag_factor_ldl(D, signs, eps, delta):
    """The same factorization through ``pallas_ldl.ldl_unblocked``: the
    blocks symmetrized from their lower triangles, one launch of the
    unblocked kernel for the whole batch on a CUDA tensor (its plain twin
    on a CPU tensor), each block with its own row of ``signs``.  The packed
    result (Lᵀ above the diagonal, D on it) becomes (L, d).

    The kernel forms each update as (K[j][r] / d)·K[j][c] where the scan
    forms (K[c][j] / d)·K[r][j]: the two agree to rounding, not bit for
    bit."""
    S = torch.tril(D) + torch.tril(D, -1).mT
    packed = pallas_ldl.ldl_unblocked(S, signs, eps, delta)
    d = torch.diagonal(packed, dim1=-2, dim2=-1)
    return torch.triu(packed, 1).mT, d


def _diag_factor(D, signs, eps, delta):
    """LDLᵀ of a batch of diagonal blocks: the hand-written kernel on a
    CUDA tensor (:func:`_diag_factor_ldl`), the pivot scan on a CPU tensor
    (:func:`_diag_factor_scan`, the JAX package's arithmetic)."""
    if D.is_cuda:
        return _diag_factor_ldl(D, signs, eps, delta)
    return _diag_factor_scan(D, signs, eps, delta)


def _panel_factor(panel, j0, signs, eps, delta, diag_fn=_diag_factor):
    """Factor pivot columns [j0, j0+w) of a front batch in place.

    ``panel``: [k, r, w] — full rows of the w pivot columns; pivot row of
    local column t is global front row j0 + t.  Returns (panel, d): the
    columns now hold unit-lower L entries (zero at and above the pivot
    row) and ``d`` the regularized pivots.

    Blocked so only the ``_BLOCK``-sized diagonal blocks run the
    sequential pivot elimination; the rows below each block come from one
    batched triangular solve (L21 = A21·L11⁻ᵀ·D⁻¹) and the update of later
    panel columns is one batched matrix product.
    """
    k, r, w = panel.shape
    d_parts = []
    for s0 in range(0, w, _BLOCK):
        s1 = min(s0 + _BLOCK, w)
        b = s1 - s0
        g0, g1 = j0 + s0, j0 + s1
        Ld, d = diag_fn(panel[:, g0:g1, s0:s1], signs[:, s0:s1], eps, delta)
        below = panel[:, g1:, s0:s1]  # [k, r-g1, b]
        # L21 stays a real triangular solve (the substitution form is the
        # stable one on ill-conditioned exp/pow Hessian blocks)
        X = torch.linalg.solve_triangular(Ld.mT, below, upper=True, left=False,
                                          unitriangular=True)
        L21 = X / d[:, None, :]
        Wcol = torch.cat(
            [torch.zeros((k, g0, b), dtype=panel.dtype, device=panel.device), Ld, L21], dim=1
        )
        panel[:, :, s0:s1] = Wcol
        d_parts.append(d)
        if s1 < w:
            # columns t' >= s1: F[:, i, t'] -= Σ_t L[:, i, t]·d_t·L[:, j0+t', t]
            R = Wcol[:, g1: j0 + w, :]  # [k, w-s1, b]
            panel[:, :, s1:] -= (Wcol * d[:, None, :]) @ R.mT
    return panel, torch.cat(d_parts, dim=1)


def partial_ldl(F, c, signs, eps, delta, diag_fn=_diag_factor):
    """Partial LDLᵀ of a batch of fronts.

    ``F``: [k, r, r] with valid data in the lower triangle; the first
    ``c`` rows/cols are the pivot block.  Returns (Lc, d, U, ok):
    Lc [k, r, c] unit-lower panel columns, d [k, c] pivots,
    U [k, r-c, r-c] the Schur complement (lower triangle valid), ok [k]
    whether each front's pivots and panel are finite.  ``F`` is factored in
    place; no front's arithmetic reads another's.
    """
    k, r, _ = F.shape
    d_parts = []
    for j0 in range(0, c, _PANEL):
        w = min(_PANEL, c - j0)
        j1 = j0 + w
        panel, d = _panel_factor(F[:, :, j0:j1], j0, signs[:, j0:j1], eps, delta,
                                 diag_fn=diag_fn)
        d_parts.append(d)
        if j1 < r:
            # trailing update: F[j1:, j1:] -= W D Wᵀ with W = L[j1:, j0:j1]
            W = panel[:, j1:, :]  # [k, r-j1, w]
            F[:, j1:, j1:] -= (W * d[:, None, :]) @ W.mT
    if d_parts:
        d = torch.cat(d_parts, dim=1)
    else:
        d = torch.zeros((k, 0), dtype=F.dtype, device=F.device)
    Lc = F[:, :, :c]
    U = F[:, c:, c:]
    ok = torch.isfinite(d).all(dim=-1) & torch.isfinite(Lc).flatten(1).all(dim=-1)
    return Lc, d, U, ok


def device_arrays(plan, dtype, device, extra=None):
    """The plan's index arrays (and ``extra``'s) as tensors on ``device``
    -- integers as int64, pivot signs in ``dtype`` -- plus, for each
    extend-add group, the fixed-order levels (``:levels``) that sum its
    children into their parent fronts."""
    out = {}
    for k, v in {**plan.arrays, **(extra or {})}.items():
        v = np.asarray(v)
        kind = dtype if v.dtype.kind == "f" else torch.long
        out[k] = torch.as_tensor(v, dtype=kind, device=device)
    for lvl in plan.levels:
        for B in lvl:
            for (_, _, akey) in B.asm:
                out[akey + ":levels"] = levels_to(
                    segment_levels(plan.arrays[akey + ":planes"], B.k), device)
    return out


def _init_fronts(plan, arrays, Kvals):
    """The flat assembly workspace: every front's cells from the KKT
    nonzeros ``Kvals`` (canonical order; ``[B, nnz]`` for a batch), one
    scatter with unique destinations."""
    kp = arrays.get("kperm_map")
    Kp = Kvals if kp is None else Kvals[..., kp]
    batch = Kvals.shape[:-1]
    finit = torch.zeros(batch + (plan.total_cells,), dtype=Kvals.dtype, device=Kvals.device)
    finit[..., arrays["init_dst_all"]] = Kp[..., arrays["init_src_all"]]
    return finit


def mf_factor(plan, arrays, Kvals, eps, delta, stable_inverse=False, finit=None,
              diag_fn=_diag_factor):
    """Numeric factorization.  ``Kvals`` is the canonical lower-triangle
    nonzero vector of K (original frame, the CSC order that was handed to
    :func:`mf_symbolic.analyze`), or None with ``finit``, the assembly
    workspace already filled (``kkt/sparse.factor_fused``).  ``arrays`` is
    the plan's device data (``kkt/sparse.SparseKKT.device_data``).  A
    batch of problems passes ``Kvals [B, nnz]`` (or ``finit [B, cells]``):
    its fronts factor lane by lane in the same launches.

    Returns (factors, ok); factors is a dict consumed by :func:`mf_solve`,
    ``ok`` a boolean per problem (0-d, or [B]).
    """
    if finit is None:
        # kkt/sparse.build composes the fill-reducing permutation into its
        # assembly maps and drops "kperm_map"; standalone plans (tests,
        # direct analyze() users) still carry canonical-order values
        finit = _init_fronts(plan, arrays, Kvals)
    dtype, device = finit.dtype, finit.device
    batch = finit.shape[:-1]
    dvec = torch.ones(batch + (plan.W,), dtype=dtype, device=device)
    out = []
    ustore = {}
    pstore = {}
    ok = torch.ones(batch, dtype=torch.bool, device=device)
    for li, lvl in enumerate(plan.levels):
        lvl_out = []
        for bi, B in enumerate(lvl):
            rp = B.r_pad
            F = finit[..., B.f_off: B.f_off + B.k * rp * rp].reshape(
                batch + (B.k, rp, rp)).clone()
            for (sl, sb, akey) in B.asm:
                # extend-add as P·U·Pᵀ: separable destination indices turn
                # the per-element scatter into two batched products --
                # exact, since each output cell receives at most one U
                # entry per child (0/1 P); overlapping children sum in
                # the lane sum.  Every problem of a batch shares P.
                U = ustore[(sl, sb)].index_select(-3, arrays[akey + ":clanes"])
                rowpos = arrays[akey + ":rowpos"]  # [kc, cup]
                P = (
                    rowpos[:, None, :] == torch.arange(rp, device=device)[None, :, None]
                ).to(dtype)  # [kc, rp, cup]
                pstore[akey] = P  # reused by every mf_solve on this factor
                upd = (P @ U) @ P.mT
                F = F + segment_apply(arrays[akey + ":levels"], upd, dim=-3)
            # the bucket's fronts of every problem as one [B·k, r, r]
            # batch, each lane with the plan's signs (tiled once here)
            signs = arrays[B.key + ":signs"]
            if batch:
                signs = signs.repeat(batch[0], 1)
            Lc, d, U, okb = partial_ldl(F.reshape(-1, rp, rp), B.c_pad, signs, eps, delta,
                                        diag_fn=diag_fn)
            if B.c_pad <= _INV_MAX_C:
                Linv = _unit_lower_inverse(Lc[:, : B.c_pad, :], stable=stable_inverse)
            else:
                Linv = None
            # back to [B, k, ...] (views, and no-ops for one problem)
            per_lane = lambda t: t.reshape(batch + (B.k,) + t.shape[1:])
            # store full-symmetric U (only its lower triangle is valid —
            # fronts initialize tril-only) so the P·U·Pᵀ extend-add sees
            # both triangles
            ustore[(li, bi)] = per_lane(torch.tril(U) + torch.tril(U, -1).mT)
            dvec[..., B.w_off: B.w_off + B.k * B.c_pad] = d.reshape(batch + (-1,))
            lvl_out.append((per_lane(Lc), per_lane(d), None if Linv is None else per_lane(Linv)))
            ok = ok & okb.reshape(batch + (B.k,)).all(dim=-1)
        out.append(lvl_out)
    return {"levels": out, "dvec": dvec, "P": pstore}, ok


def batch_shape(factors):
    """The problems' batch shape of :func:`mf_factor`'s factors: () for one
    problem, (B,) for a batch."""
    return factors["dvec"].shape[:-1]


def mf_solve(plan, arrays, factors, rhs):
    """Solve K x = rhs with the computed factors (levelized forward /
    diagonal / backward sweeps).  ``rhs``: [N] or [N, r] in the original
    frame — multiple right-hand sides ride the same sweeps (the IPM pairs
    the constant and affine solves this way).  The factors of a batch of
    problems take ``rhs [B, N, r]``, always three-dimensional (a [B, N]
    would read as one problem's [N, r]); each lane solves with its own.

    Works in the bucket-contiguous solve workspace (see mf_symbolic):
    each bucket's pivot block is one slice of ``x``.  Cross-level coupling
    propagates THROUGH fronts level by level with the factor's cached 0/1
    selection matrices: update vectors extend-add parent-ward on the
    forward sweep, final values push child-ward on the backward sweep —
    the classic multifrontal solve.
    """
    dtype, device = rhs.dtype, rhs.device
    batch = batch_shape(factors)
    if batch and (rhs.dim() != 3 or rhs.shape[0] != batch[0]):
        raise ValueError(f"the factors of {batch[0]} problems take rhs [B, N, r], "
                         f"got {tuple(rhs.shape)}")
    single = rhs.dim() == 1
    if single:
        rhs = rhs[:, None]
    r = rhs.shape[-1]
    rhs_ext = torch.cat([rhs, torch.zeros(batch + (1, r), dtype=dtype, device=device)], dim=-2)
    x = rhs_ext[..., arrays["solve_src"], :]  # [..., W, r]

    def blk(B):
        return x[..., B.w_off: B.w_off + B.k * B.c_pad, :].reshape(batch + (B.k, B.c_pad, r))

    def put(B, v):
        x[..., B.w_off: B.w_off + B.k * B.c_pad, :] = v.reshape(batch + (B.k * B.c_pad, r))

    pstore = factors["P"]

    # forward sweep: y = L11⁻¹ (b - incoming); update vector
    # u = L21 y + incoming-below-pivot extends to the parent front
    ustore = {}
    for li, lvl in enumerate(plan.levels):
        for bi, B in enumerate(lvl):
            Lc, _d, Linv = factors["levels"][li][bi]
            v = blk(B)
            inc_below = None
            for (sl, sb, akey) in B.asm:
                u_c = ustore[(sl, sb)].index_select(-3, arrays[akey + ":clanes"])  # [.., kc, cup, r]
                inc = segment_apply(arrays[akey + ":levels"], pstore[akey] @ u_c,
                                    dim=-3)  # [..., k, rp, r]
                v = v - inc[..., : B.c_pad, :]
                ib = inc[..., B.c_pad:, :]
                inc_below = ib if inc_below is None else inc_below + ib
            if Linv is not None:
                y = Linv @ v
            else:
                y = torch.linalg.solve_triangular(Lc[..., : B.c_pad, :], v, upper=False,
                                                  unitriangular=True)
            put(B, y)
            if B.u_pad:
                u = Lc[..., B.c_pad:, :] @ y
                if inc_below is not None:
                    u = u + inc_below
                ustore[(li, bi)] = u

    x = x / factors["dvec"][..., None]

    # backward sweep: parents push their full front value vector
    # w = [x_pivot ; x_rows] down; children read their row values from it
    rowvals = {}
    for li in range(len(plan.levels) - 1, -1, -1):
        for bi, B in enumerate(plan.levels[li]):
            Lc, _d, Linv = factors["levels"][li][bi]
            v = blk(B)
            rv = rowvals.get((li, bi))
            if B.u_pad and rv is not None:
                v = v - Lc[..., B.c_pad:, :].mT @ rv
            if Linv is not None:
                xc = Linv.mT @ v
            else:
                xc = torch.linalg.solve_triangular(Lc[..., : B.c_pad, :].mT, v, upper=True,
                                                   unitriangular=True)
            put(B, xc)
            if B.asm:
                if B.u_pad:
                    if rv is None:
                        rv = torch.zeros(batch + (B.k, B.u_pad, r), dtype=dtype, device=device)
                    w = torch.cat([xc, rv], dim=-2)  # [..., k, rp, r]
                else:
                    w = xc
                for (sl, sb, akey) in B.asm:
                    w_sel = w.index_select(-3, arrays[akey + ":planes"])
                    P = pstore[akey][:, : w.shape[-2], :]
                    vals = P.mT @ w_sel
                    tgt = rowvals.get((sl, sb))
                    if tgt is None:
                        child = plan.levels[sl][sb]
                        tgt = torch.zeros(batch + (child.k, child.u_pad, r), dtype=dtype,
                                          device=device)
                    tgt[..., arrays[akey + ":clanes"], :, :] = vals
                    rowvals[(sl, sb)] = tgt

    out = x[..., arrays["solve_out"], :]
    return out[:, 0] if single else out

"""Double-float (compensated f32) residuals for iterative refinement.

PyTorch port of ``clarabel_tpu/kkt/compensated.py``: the error-free
transformations, the double-float residual ``rhs - (K + K_lo) x`` of the
dense f32 KKT path, the double-float products of the small per-cone
matrices of the PSD scaling (:func:`df_matmul`, :func:`df_matmul_df`) and
the compensated segment sum of the sparse path's products
(:func:`seg_sum_df`, ``kkt/sparse.sym_matvec_df``).

Near convergence cond(K) ~ 1/μ, and an f32 residual bounds the refined
step's forward error at O(eps32 · cond(K)).  Classic mixed-precision
iterative refinement recovers it when the residual is computed in higher
precision (Moler 1967; Ogita-Rump Dot2).  Here, as in the JAX package, that
precision is double-float: Dekker's split makes each product K_ij x_j an
exact hi + lo pair, and a pairwise TwoSum tree sums each row with its
rounding errors carried in a lo stream.

Every function works elementwise over any leading batch dimensions and
reduces over the last one only (:func:`seg_sum_df` over the dimension it is
given, by fixed segments), so a problem inside a batch sums exactly as it
does alone.  Each operation is one PyTorch operation: nothing fuses a
product into a sum (an FMA would break the split).  The tree over N entries
costs about 10·log2 N launches per residual, and each double-float
product about 10·log2 l + 20 (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

#: Dekker's split constant for f32 (24-bit significand -> 12|12 halves)
_SPLIT_F32 = 4097.0  # 2**12 + 1


def _split(a):
    c = a * _SPLIT_F32
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Error-free product: a*b = p + err exactly (f32)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _two_sum(a, b):
    """Error-free sum: a+b = s + err exactly (Knuth's TwoSum)."""
    s = a + b
    z = s - a
    err = (a - (s - z)) + (b - z)
    return s, err


def _df_reduce_last(hi, lo):
    """Compensated pairwise reduction over the last dimension.

    Input: value/error pairs [..., n].  Returns ([...], [...]) with the
    sum's rounding errors carried in the lo part.  An odd length is padded
    with one zero, and entry 2i pairs with entry 2i + 1, level by level,
    as in the JAX package."""
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
        s, e = _two_sum(hi[..., 0::2], hi[..., 1::2])
        hi = s
        lo = lo[..., 0::2] + lo[..., 1::2] + e
    return hi[..., 0], lo[..., 0]


def df_matmul(A, B):
    """Matrix product in double-float: A[..., i, l] @ B[..., l, j] as a
    (hi, lo) pair with A @ B = hi + lo to ~eps².  It builds the
    [..., i, j, l] exact-product tensor: meant for the small per-cone
    matrices of the PSD scaling, not for K."""
    p, e = _two_prod(A[..., :, :, None], B[..., None, :, :])
    return _df_reduce_last(p.movedim(-2, -1), e.movedim(-2, -1))


def df_matmul_df(Ah, Al, Bh, Bl):
    """Double-float matrix product of double-float operands (hi/lo pairs)."""
    p, e = _two_prod(Ah[..., :, :, None], Bh[..., None, :, :])
    e = e + Ah[..., :, :, None] * Bl[..., None, :, :]
    e = e + Al[..., :, :, None] * Bh[..., None, :, :]
    return _df_reduce_last(p.movedim(-2, -1), e.movedim(-2, -1))


def seg_sum_df(p, e, seg_ids, levels, dim=0):
    """Compensated segment sum: Σ_seg (p + e) as a (hi, lo) pair, to ~2⁻³⁴
    of each segment's largest |p|.

    ``p`` carries exact products' hi parts and ``e`` their low parts (from
    :func:`_two_prod`), their entries along ``dim``; ``seg_ids`` the sorted
    segment of each entry and ``levels`` the fixed-order sums over those
    segments (``algebra.coo.segment_levels``).  A plain f32 sum of a long
    cancelling segment floors at eps·Σ|p|, so each segment is scaled by a
    power of two (exact), split into 11-bit limbs on a common grid -- partial
    sums of up to 2¹² such terms are exact in f32, in any order -- and each
    limb stream summed on its own.  Three limbs put the grid's floor at ~2⁻³⁴
    of the segment's max.  The JAX package's ``seg_sum_df``; its segment sums
    add here in the levels' fixed order (no scatter-add on the card)."""
    from ..algebra.coo import segment_apply, segment_max

    mag = torch.clamp(segment_max(levels, torch.abs(p), dim=dim), min=1e-30)
    # the exact power-of-two scale of each segment
    _, expo = torch.frexp(mag)
    s = torch.ldexp(torch.ones_like(mag), expo)
    t = p / s.index_select(dim, seg_ids)  # exact: |t| <= 1

    G = 2048.0  # the 2¹¹ limb grid
    u1 = torch.round(t * G) / G
    r1 = t - u1  # exact (aligned grids)
    u2 = torch.round(r1 * (G * G)) / (G * G)
    r2 = r1 - u2  # exact

    def seg(v):
        return segment_apply(levels, v, dim=dim)

    y1 = seg(u1)  # exact: multiples of 2⁻¹¹, |sum| <= 2¹²
    y2 = seg(u2)  # exact: multiples of 2⁻²², |sum| <= 1
    y3 = seg(r2)  # |terms| <= 2⁻²³: the plain sum's error ~ eps·2⁻²³·n
    hi, err = _two_sum(y1, y2)
    lo = err + y3
    # scale back (a power of two: exact) and fold in the products' low parts
    return hi * s, lo * s + seg(e)


def residual(K, x, rhs, K_lo=None):
    """rhs - (K + K_lo) x evaluated in double-float, f32 at the end.

    K: [..., N, N]; x and rhs: [..., N], or [..., N, R] for R right-hand
    sides (told apart by their dimension against K's).  Accurate to
    ~eps²·‖K‖‖x‖ instead of eps·‖K‖‖x‖.  ``K_lo`` optionally carries the lo
    part of a double-float K (the PSD Hs blocks' rounding remainder); its
    contribution is already eps-scaled, so a plain product serves."""
    multi = x.dim() == K.dim()
    if multi:
        xe = x.mT.unsqueeze(-2)  # [..., R, 1, N]
        rhs_e = rhs.mT  # [..., R, N]
        K = K.unsqueeze(-3)
        if K_lo is not None:
            K_lo = K_lo.unsqueeze(-3)
    else:
        xe = x.unsqueeze(-2)  # [..., 1, N]
        rhs_e = rhs
    p, e = _two_prod(K, xe)  # exact products
    if K_lo is not None:
        e = e + K_lo * xe
    s_hi, s_lo = _df_reduce_last(p, e)
    d_hi, d_err = _two_sum(rhs_e, -s_hi)
    out = d_hi + (d_err - s_lo)
    return out.mT if multi else out

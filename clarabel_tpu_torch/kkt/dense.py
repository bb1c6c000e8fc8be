"""Dense KKT solvers: assembly, factorization, refined solves.

PyTorch port of the dense paths of ``clarabel_tpu/kkt/dense.py`` at f64 and
f32, and of its Schur-complement engines
(reference: src/solver/core/kktsolvers/direct/quasidef/directldlkktsolver.rs).
The KKT matrix

    K = [ P   Aᵀ ]
        [ A  -Hs ]

is either assembled densely, and the *statically regularized*
K + ε·diag(Dsigns) factored once per IPM iteration by pivoted LU
(``torch.linalg``), by the quasidefinite LDLᵀ kernels of :mod:`.pallas_ldl`
or by a Schur-complement condensation (:func:`factor_schur`); or, on the
structured paths, never materialized: :func:`prepare_schur_diag` and
:func:`prepare_schur_lowrank` condense it through diag(Hs), or diag(Hs)
plus one rank-1 term per second-order cone, into one Cholesky factor of the
n×n Schur complement.  Iterative refinement against the unregularized K (a
dense matrix or a matvec) recovers the accuracy -- the reference's scheme
(static regularization: directldlkktsolver.rs:217-264; refinement:
:266-321).  At f32 the "lu" route factors with the double-float LU
(:func:`factor_df`, ``kkt/df_ldl.py``) up to ``DF_LU_MAX_DIM`` and with the
Jacobi-equilibrated f32 LU (:func:`factor_jacobi`) above it, and a dense K
refines with double-float residuals (``kkt/compensated.py``).  The
refinement loop is a host loop that reads one scalar per sweep from the
device.

Every function takes the data with leading batch dimensions or without
(K [..., N, N], right-hand sides [..., N]); ε, ``ok``, the capacitances and
the refinement's progress are then per problem, and a problem whose
refinement has stopped keeps its solution while the others sweep on, as
``jax.vmap`` of the JAX package's ``lax.while_loop`` keeps it.  A problem
whose matrix is not positive definite gets a NaN Cholesky factor, as
``jnp.linalg.cholesky`` gives it, and ``ok`` False; the others do not see it.
"""

from __future__ import annotations

import os

import torch

from . import compensated, df_ldl, multifrontal, pallas_ldl
from ..timers import host_read


def pairwise_sum(v):
    """The sum over the last dimension by a fixed pairwise tree (entry 2i
    with 2i + 1, level by level, an odd length padded with a zero): every
    problem of a batch sums in the same order whatever the batch's size,
    which neither the CPU's batched products nor ``sum`` guarantee."""
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.nn.functional.pad(v, (0, 1))
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _lane_exact(M):
    """Whether a batched f32 product on ``M`` takes elementwise products and
    :func:`pairwise_sum`: on the CPU, whose batched products round a
    problem's sums differently at other batch sizes.  Near the end of an
    f32 solve that decides its steps, and so a lane of an f32 batch computes
    there what it does as a batch of one (the JAX package makes Δτ
    batch-shape independent the same way).  On a card the products stay
    cuBLAS's: there the SVD and the eigenvalue solves depend on the batch
    shape anyway."""
    return M.dtype == torch.float32 and M.device.type == "cpu"


def matvec(M, v):
    """M v over any leading batch dimensions (M [..., r, c], v [..., c]);
    one problem takes PyTorch's matrix-vector product itself, a sparse
    ``algebra.coo.COOMat`` (one or a batch) its own, a batch at f32 on the
    CPU a :func:`pairwise_sum` of products (:func:`_lane_exact`)."""
    if v.dim() == 1 or not isinstance(M, torch.Tensor):
        return M @ v
    if _lane_exact(M):
        return pairwise_sum(M * v.unsqueeze(-2))
    return (M @ v.unsqueeze(-1)).squeeze(-1)


_mv = matvec  # the module's matvec, under a name the Schur closures keep


def matmul(M, V):
    """M V for M [..., r, c] and R right-hand sides V [..., c, R]; a batch
    at f32 on the CPU as a :func:`pairwise_sum` of products
    (:func:`_lane_exact`)."""
    if M.dim() == 2 or not _lane_exact(M):
        return M @ V
    return pairwise_sum(M.unsqueeze(-3) * V.mT.unsqueeze(-2)).mT


def dot(a, b):
    """aᵀb over any leading batch dimensions (a, b [..., k]); a batch at f32
    on the CPU as a :func:`pairwise_sum` of products (:func:`_lane_exact`)."""
    if a.dim() == 1:
        return a @ b
    if _lane_exact(a):
        return pairwise_sum(a * b)
    return (a.unsqueeze(-2) @ b.unsqueeze(-1))[..., 0, 0]


def assemble(P, A, Hs, settings):
    """Returns (K_true, K_reg).

    reference: kkt_assembly.rs:20-52 for the block structure;
    directldlkktsolver.rs:217-264 + _compute_regularizer for the static
    regularization ε = constant + proportional·max|diag(K)| applied with
    sign +1 on the first n entries and -1 on the last m.
    """
    n = P.shape[-1]
    m = A.shape[-2]
    K = torch.cat([torch.cat([P, A.mT], dim=-1), torch.cat([A, -Hs], dim=-1)], dim=-2)

    if settings.static_regularization_enable:
        diag = torch.diagonal(K, dim1=-2, dim2=-1)
        eps = (
            settings.static_regularization_constant
            + settings.static_regularization_proportional
            * torch.amax(torch.abs(diag), dim=-1, keepdim=True)
        )
        dsigns = torch.cat(
            [torch.ones(n, dtype=K.dtype, device=K.device),
             -torch.ones(m, dtype=K.dtype, device=K.device)]
        )
        K_reg = K + torch.diag_embed(dsigns * eps)
    else:
        K_reg = K
    return K, K_reg


def factor(K_reg):
    """Pivoted LU factorization of the regularized KKT matrix.  A singular
    matrix gives non-finite factors (``ok`` False for its problem), as
    LAPACK's getrf does for the JAX package, rather than an exception."""
    lu, piv, _ = torch.linalg.lu_factor_ex(K_reg)
    ok = torch.isfinite(lu).flatten(-2).all(dim=-1)
    return ("lu", (lu, piv)), ok


def _df_lu_max_dim():
    n = int(os.environ.get("CT_DF_LU_MAX_DIM", "512"))
    if n > df_ldl.MAX_DIM:
        raise ValueError(f"CT_DF_LU_MAX_DIM={n} exceeds {df_ldl.MAX_DIM}, the largest order "
                         "the double-float LU kernels take")
    return n


#: the largest N the f32 "lu" route factors with the double-float LU
#: (``kkt/df_ldl.py``); larger dense systems take :func:`factor_jacobi`, as
#: in the JAX package.  Env-overridable (CT_DF_LU_MAX_DIM=0 disables it) up
#: to the kernels' ceiling ``df_ldl.MAX_DIM`` = 512, which the JAX package
#: does not have: a larger value raises on import.
DF_LU_MAX_DIM = _df_lu_max_dim()


def factor_df(K_reg, K_reg_lo=None):
    """Double-float LU with partial pivoting (``kkt/df_ldl.py``): the f32
    factorization whose application error ~eps_df keeps iterative
    refinement contracting at cond(K) ~ 1e10, where every plain f32
    factorization's refinement stalls."""
    fac, ok = df_ldl.factor(K_reg, K_reg_lo)
    return ("df_lu", fac), ok


def factor_jacobi(K_reg, settings, n):
    """f32 pivoted LU of the Jacobi-equilibrated regularized KKT D·K·D,
    D = |diag K|^(-1/2).  Near convergence ‖K‖ grows like the largest NT
    weight (~1/μ); once eps32·‖K‖ ≳ 1 refinement against the unscaled
    factor diverges, and the scaling bounds the scaled norm at O(1).  The
    reference needs no equivalent: f64 keeps eps·‖K‖ ≪ 1
    (directldlkktsolver.rs:217-264)."""
    del n, settings
    diag = torch.abs(torch.diagonal(K_reg, dim1=-2, dim2=-1))
    d = 1.0 / torch.sqrt(torch.maximum(diag, diag.new_tensor(1e-30)))
    lu, piv, _ = torch.linalg.lu_factor_ex(K_reg * d.unsqueeze(-1) * d.unsqueeze(-2))
    return ("lu_jacobi", (lu, piv, d)), _finite(lu)


def _finite(M):
    """Per problem: every entry of M [..., r, c] finite."""
    return torch.isfinite(M).flatten(-2).all(dim=-1)


def _amax0(v):
    """``jnp.max(jnp.abs(v), initial=0.0)`` over the last dimension."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return torch.abs(v).amax(dim=-1)


def cholesky(S):
    """Lower Cholesky factor of the symmetric S [..., n, n], as
    ``jnp.linalg.cholesky`` computes it: of (S + Sᵀ)/2, and NaN throughout
    for a problem whose matrix is not positive definite (no exception, and
    no other problem sees it).  ``cholesky.calls`` counts the calls, one per
    batched factorization."""
    cholesky.calls += 1
    L, info = torch.linalg.cholesky_ex(0.5 * (S + S.mT))
    return torch.where((info == 0)[..., None, None], L, torch.nan)


cholesky.calls = 0


def _cho_solve(L, b):
    """S⁻¹ b for the Cholesky factor L of S, b [..., n]."""
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _static_eps(settings, maxdiag, otherwise):
    """The static regularization ε [...] per problem (constant +
    proportional·max|diag|), or ``otherwise`` when it is off."""
    if settings.static_regularization_enable:
        return (settings.static_regularization_constant
                + settings.static_regularization_proportional * maxdiag)
    return torch.full_like(maxdiag, otherwise)


def factor_schur(K_reg, n):
    """Schur-complement factorization of the regularized quasidefinite KKT.

    With K = [[P̃, Aᵀ], [A, -H̃]] (P̃ = P + εI, H̃ = Hs + εI ≻ 0), solving
    K [x1; x2] = [b1; b2] reduces to two SPD Cholesky solves:

        x2 = H̃⁻¹ (A x1 - b2)
        (P̃ + Aᵀ H̃⁻¹ A) x1 = b1 + Aᵀ H̃⁻¹ b2

    and iterative refinement against the full K recovers the accuracy lost
    to the condensation (directldlkktsolver.rs:266-321).
    """
    Pt = K_reg[..., :n, :n]
    A = K_reg[..., n:, :n]
    LH = cholesky(-K_reg[..., n:, n:])  # of Hs + εI
    S = Pt + A.mT @ torch.cholesky_solve(A, LH)
    LS = cholesky(S)
    ok = _finite(LH) & _finite(LS)
    return ("schur", (LH, LS, A, n)), ok


def prepare_schur_diag(P, A, hs_diag, settings, eq_mask=None):
    """Fully structured KKT preparation for diagonal-Hs layouts (zero and
    nonnegative cones): H⁻¹ is an elementwise reciprocal and S builds with
    one weighted Gram product.  Neither Hs nor the (n+m)² K is ever
    materialized.  Returns (factors, matvec, ok), ``matvec`` applying the
    *unregularized* K over any leading batch dimensions.

    Zero-cone (equality) rows have only the tiny static regularization on
    their H diagonal; ``eq_mask`` ([m], 1 on them) adds the heavier proxy
    δ = 1e-3·max|diag| there, which keeps the condensation well conditioned
    in f32 -- refinement against the true K recovers full accuracy in 2-3
    sweeps (directldlkktsolver.rs:266-321).
    """
    n = P.shape[-1]
    # (diag Hs ≥ 0, so its largest entry is its largest magnitude)
    h, eps = _schur_diag_h(P, hs_diag, settings, eq_mask)
    hinv = 1.0 / h
    S = P + eps[..., None, None] * _eye(n, P) + A.mT @ (hinv.unsqueeze(-1) * A)
    LS = cholesky(S)
    ok = _finite(LS) & torch.all(h > 0, dim=-1)

    def matvec(v):
        v1, v2 = v[..., :n], v[..., n:]
        return torch.cat([_mv(P, v1) + _mv(A.mT, v2), _mv(A, v1) - hs_diag * v2], dim=-1)

    return ("schur_diag", (hinv, LS, A, n)), matvec, ok


def prepare_schur_lowrank(P, A, h, U, settings, n_eq=0):
    """Woodbury extension of :func:`prepare_schur_diag` to zero/NN/SOC
    layouts, with Hs = diag(h) + U Uᵀ (``cones.ops.hs_diag_lowrank``): the
    condensation over the inequality rows

        S = P̃ + A_iᵀ H̃_i⁻¹ A_i,    H̃_i = diag(h̃_i) + U_i U_iᵀ

    applies H̃_i⁻¹ through the Woodbury identity -- one product with U plus
    one *scalar* capacitance 1 + cᵀD⁻¹c ≈ −1 per cone (disjoint cone
    supports make the capacitance matrix diagonal); ``ok`` is False for a
    problem with a capacitance of magnitude 0.1 or less.  The static ε takes
    the sign of each diagonal entry, so the SOC head entries move away from
    zero, not across it.

    The equality rows -- the leading ``n_eq`` rows of A -- are not condensed
    through their tiny diagonal: they are eliminated exactly at a second
    level through the p×p Schur complement E = A_e S⁻¹ A_eᵀ + εI, where ε
    is the machine epsilon when static regularization is off.  Refinement
    against the exact K recovers what the product form loses
    (directldlkktsolver.rs:266-321).

    Returns (factors, matvec, ok); ``matvec`` applies the unregularized K.
    """
    n = P.shape[-1]
    p = int(n_eq)
    A_e, A_i = A[..., :p, :], A[..., p:, :]
    h_i = h[..., p:]
    k = U.shape[-1]
    U_i = U[..., p:, :]

    # the true Hs diagonal, for the regularization's magnitude
    hs_full_diag = h + torch.sum(U**2, dim=-1) if k else h
    maxdiag = torch.maximum(_amax0(torch.diagonal(P, dim1=-2, dim2=-1)), _amax0(hs_full_diag))
    # the equality block's elimination needs ε > 0
    eps = _static_eps(settings, maxdiag, torch.finfo(P.dtype).eps)

    d = h_i + torch.where(h_i < 0, -eps.unsqueeze(-1), eps.unsqueeze(-1))
    dinv = 1.0 / d

    if k:
        # scalar capacitances m_c = 1 + c_cᵀ D⁻¹ c_c (≈ −1 analytically)
        caps = 1.0 + (U_i * (dinv.unsqueeze(-1) * U_i)).sum(dim=-2)
        capinv = 1.0 / caps
        ok_lr = torch.all(torch.abs(caps) > 0.1, dim=-1) & torch.all(torch.isfinite(capinv), dim=-1)
    else:
        ok_lr = torch.ones(maxdiag.shape, dtype=torch.bool, device=P.device)

    def hinv_apply(V):
        """(H̃_i)⁻¹ V for V [..., m - p, r]."""
        Wv = dinv.unsqueeze(-1) * V
        if k:
            t = capinv.unsqueeze(-1) * (U_i.mT @ Wv)
            Wv = Wv - dinv.unsqueeze(-1) * (U_i @ t)
        return Wv

    S = P + eps[..., None, None] * _eye(n, P) + A_i.mT @ hinv_apply(A_i)
    LS = cholesky(S)
    ok = _finite(LS) & torch.all(d != 0, dim=-1) & ok_lr

    LE = None
    if p:
        # the second-level equality Schur complement (exact elimination)
        E = A_e @ torch.cholesky_solve(A_e.mT, LS) + eps[..., None, None] * _eye(p, P)
        LE = cholesky(E)
        ok = ok & _finite(LE)

    def matvec(v):
        v1, v2 = v[..., :n], v[..., n:]
        hs_v2 = h * v2
        if k:
            hs_v2 = hs_v2 + _mv(U, _mv(U.mT, v2))
        return torch.cat([_mv(P, v1) + _mv(A.mT, v2), _mv(A, v1) - hs_v2], dim=-1)

    return ("schur_lr", (hinv_apply, LS, LE, A_e, A_i, n, p)), matvec, ok


def _schur_diag_h(P, hs_diag, settings, eq_mask):
    """The regularized H diagonal of :func:`prepare_schur_diag` and its ε:
    (h, ε) per problem."""
    maxdiag = torch.maximum(_amax0(torch.diagonal(P, dim1=-2, dim2=-1)), _amax0(hs_diag))
    eps = _static_eps(settings, maxdiag, 0.0)
    h = hs_diag + eps.unsqueeze(-1)
    if eq_mask is not None:
        h = h + eq_mask * (1e-3 * maxdiag).unsqueeze(-1)
    return h, eps


def _prepare_rowsharded(P, A, hs_diag, settings, eq_mask):
    """:func:`prepare_schur_diag` over a row-sharded A (``algebra/ell.py``):
    each rank forms its rows' weighted Gram tile A_kᵀ H_k⁻¹ A_k from its
    dense row block, one all-reduce sums S = P̃ + Σ_k A_kᵀ H_k⁻¹ A_k on
    every rank, and the [n, n] Cholesky factor is computed whole on each.
    Aᵀv and A·v go through A's own collectives."""
    from ..parallel import comm

    n = P.shape[-1]
    h, eps = _schur_diag_h(P, hs_diag, settings, eq_mask)
    hinv = 1.0 / h
    Ab = A.densify_sharded()
    gram = comm.all_reduce(Ab.mT @ (A.row_block(hinv).unsqueeze(-1) * Ab), A.group)
    S = P + eps[..., None, None] * _eye(n, P) + gram
    LS = cholesky(S)
    ok = _finite(LS) & torch.all(h > 0, dim=-1)
    at_v = lambda v: A.T @ v
    a_v = lambda v: A @ v

    def matvec(v):
        v1, v2 = v[..., :n], v[..., n:]
        return torch.cat([_mv(P, v1) + at_v(v2), a_v(v1) - hs_diag * v2], dim=-1)

    return ("schur_diag_sh", (hinv, LS, at_v, a_v, n)), matvec, ok


def prepare_schur_diag_rowsharded(P, A, hs_diag, settings, eq_mask, mesh, axis):
    """Row-sharded :func:`prepare_schur_diag` with the communication fixed
    by construction (the JAX package's, there through ``shard_map``):

      - S = P̃ + Σ_k A_kᵀ H_k⁻¹ A_k assembles as one weighted Gram product
        of each rank's rows plus one all-reduce of [..., n, n] over the
        row axis ``axis`` of ``mesh`` (SURVEY §5.8: the Schur-complement
        reduction across KKT blocks);
      - Aᵀv all-reduces each rank's partial [..., n]; A·v all-gathers the
        ranks' [..., m_loc] into [..., m];
      - A is NEVER gathered: each rank holds only its row block.

    ``A`` is this rank's block ``[..., m_loc, n]`` of rows (leading batch
    dimensions are independent problems); P, ``hs_diag`` [..., m] and
    ``eq_mask`` [m] are whole on every rank.  The [n, n] factorization runs
    whole on every rank, in the same bits."""
    from ..algebra.ell import DenseRowMat

    A = DenseRowMat.from_mesh(A, hs_diag.shape[-1], mesh, axis)
    return _prepare_rowsharded(P, A, hs_diag, settings, eq_mask)


def prepare_schur_diag_rowsharded_ell(P, A, hs_diag, settings, eq_mask):
    """Sparse (ELL) variant of :func:`prepare_schur_diag_rowsharded`: A
    arrives as an ``algebra.ell.ELLRowMat`` (tall problems without a dense
    host A).  The Gram reduction needs a dense operand, so each rank
    scatters its ELL rows into a dense [m_loc, n] block on its device, once
    per matrix (``densify_sharded``, the JAX package's loop-invariant that
    XLA hoists), and the reduction stays one product of each rank's rows
    plus one all-reduce.  The refinement's products keep the sparse
    gather/segment-sum form; A, in either form, is never gathered."""
    return _prepare_rowsharded(P, A, hs_diag, settings, eq_mask)


def _lu_solve(lu, piv, rhs):
    vec = rhs.dim() == lu.dim() - 1
    b = rhs.unsqueeze(-1) if vec else rhs
    x = torch.linalg.lu_solve(lu, piv, b)
    return x.squeeze(-1) if vec else x


def _raw_solve(factors, rhs):
    kind, data = factors
    if kind == "lu":
        return _lu_solve(*data, rhs)
    if kind == "lu_jacobi":
        lu, piv, d = data
        ds = d if rhs.dim() == lu.dim() - 1 else d.unsqueeze(-1)
        return ds * _lu_solve(lu, piv, ds * rhs)
    if kind == "df_lu":
        return df_ldl.solve(data, rhs)
    if kind == "mf":
        from . import sparse as kkt_sparse

        ctx, sdata, mff = data
        return kkt_sparse.solve(ctx, sdata, mff, rhs)
    if kind == "pldl":
        packed, N = data
        return pallas_ldl.ldl_solve(packed, N, rhs)
    if kind == "pldl_lower":
        packed, N = data
        return pallas_ldl.ldl_solve_lower(packed, N, rhs)
    # the Schur branches solve one right-hand side per problem, rhs [..., N]
    if kind == "schur_diag":
        hinv, LS, A, n = data
        b1, b2 = rhs[..., :n], rhs[..., n:]
        x1 = _cho_solve(LS, b1 + _mv(A.mT, hinv * b2))
        x2 = hinv * (_mv(A, x1) - b2)
        return torch.cat([x1, x2], dim=-1)
    if kind == "schur_diag_sh":
        hinv, LS, at_v, a_v, n = data
        b1, b2 = rhs[..., :n], rhs[..., n:]
        x1 = _cho_solve(LS, b1 + at_v(hinv * b2))
        x2 = hinv * (a_v(x1) - b2)
        return torch.cat([x1, x2], dim=-1)
    if kind == "schur_lr":
        hinv_apply, LS, LE, A_e, A_i, n, p = data
        hinv_vec = lambda v: hinv_apply(v.unsqueeze(-1)).squeeze(-1)
        b1 = rhs[..., :n]
        b2e, b2i = rhs[..., n : n + p], rhs[..., n + p :]
        t = _cho_solve(LS, b1 + _mv(A_i.mT, hinv_vec(b2i)))
        if p:
            y_e = _cho_solve(LE, _mv(A_e, t) - b2e)
            x1 = t - _cho_solve(LS, _mv(A_e.mT, y_e))
        else:
            y_e = b2e  # empty
            x1 = t
        y_i = hinv_vec(_mv(A_i, x1) - b2i)
        return torch.cat([x1, y_e, y_i], dim=-1)
    if kind == "schur":
        LH, LS, A, n = data
        b1, b2 = rhs[..., :n], rhs[..., n:]
        w = _cho_solve(LH, b2)
        x1 = _cho_solve(LS, b1 + _mv(A.mT, w))
        x2 = _cho_solve(LH, _mv(A, x1) - b2)
        return torch.cat([x1, x2], dim=-1)
    raise NotImplementedError(
        f"KKT factors of kind {kind!r} are not ported (ROADMAP.md Queue 1)"
    )


def solve_refined(factors, K_true, rhs, settings, want_lo=False):
    """Solve K x = rhs with iterative refinement against the true
    (unregularized) KKT matrix ``K_true``: a dense matrix, or a matvec
    callable (the structured Schur paths and the sparse path).

    Returns (x, ok), or ((x, x_lo), ok) with ``want_lo``.  A dense f32 K
    (N ≤ 4096) refines in mixed precision, as in the JAX package: the
    residual is evaluated in double-float (``kkt/compensated.py``) and the
    corrections are TwoSummed into a double-float solution (x, x_lo), so the
    refinement floor is not the f32 representation of x.  So does an f32
    system whose matvec ``K_true`` carries a compensated product ``.df``
    (v, v_lo) -> (hi, lo) (the sparse path's, ``kkt/sparse.py``), matrix-free.
    x_lo is None on every other path.  Each problem of a batch sweeps until its own
    refinement stops; the host reads once per sweep whether any problem
    still sweeps.  A problem's right-hand sides refine together, one norm
    over all of them, as in the JAX package: a dense K's [..., N, R], and on
    the multifrontal factors (``"mf"``) one problem's [N] or [N, r] or, for
    a batch of factors, each lane's [N, r] of ``rhs [B, N, r]``.
    ``K_true`` may also be a (K, K_lo) pair (f32 PSD layouts): K_lo holds
    the PSD Hs blocks' double-float rounding remainder
    (``loop._kkt_prepare``), the factor is of K, and the refinement refines
    against K + K_lo, so the solved Δz is consistent to ~eps² with the exact
    NT geometry the Δs recovery and the step length use.
    reference: directldlkktsolver.rs:266-321 — bounded refinement loop
    with stall detection.
    """
    solve_refined.calls += 1
    K_lo = None
    if isinstance(K_true, tuple):
        K_true, K_lo = K_true
    x0 = _raw_solve(factors, rhs)
    dense = not callable(K_true)
    if (factors[0] == "mf" and multifrontal.batch_shape(factors[1][2])) or (
            dense and rhs.dim() == K_true.dim()):
        # several right-hand sides per problem: reduce over each problem's
        amax = lambda v: torch.abs(v).flatten(-2).amax(dim=-1)
        all_ = lambda v: v.flatten(-2).all(dim=-1)
        per_problem = lambda mask: mask[..., None, None]
    elif factors[0] == "mf":
        # one problem: reduce over every right-hand side at once
        amax = lambda v: torch.abs(v).amax()
        all_ = torch.all
        per_problem = lambda mask: mask
    else:
        amax = lambda v: torch.amax(torch.abs(v), dim=-1)
        all_ = lambda v: torch.all(v, dim=-1)
        per_problem = lambda mask: mask.unsqueeze(-1)

    if not settings.iterative_refinement_enable:
        ok = all_(torch.isfinite(x0))
        return ((x0, None), ok) if want_lo else (x0, ok)
    if not dense:
        k_matvec = K_true
        lo_matvec = None
    elif rhs.dim() == K_true.dim():
        k_matvec = lambda v: matmul(K_true, v)
        lo_matvec = lambda v: matmul(K_lo, v)
    else:
        k_matvec = lambda v: matvec(K_true, v)
        lo_matvec = lambda v: matvec(K_lo, v)

    reltol = settings.iterative_refinement_reltol
    abstol = settings.iterative_refinement_abstol
    maxiter = settings.iterative_refinement_max_iter
    stopratio = settings.iterative_refinement_stop_ratio
    # f32 + dense K: the refinement residual in double-float.  A plain f32
    # residual bounds the step's forward error at O(eps32·cond(K)) ~ 0.1
    # near convergence (cond ~ 1/μ); the compensated one restores mixed
    # precision refinement's forward convergence, so refinement runs to the
    # arithmetic floor and the stall detector bounds the sweeps.
    compensate_dense = dense and K_true.dtype == torch.float32 and K_true.shape[-1] <= 4096
    # the sparse path's matvecs advertise a compensated product as ``.df``:
    # the same mixed-precision refinement, matrix-free
    df_mv = None if dense else getattr(K_true, "df", None)
    compensate_sparse = df_mv is not None and rhs.dtype == torch.float32
    compensate = compensate_dense or compensate_sparse
    if factors[0] == "schur_lr" or compensate:
        # (schur_lr: the Woodbury condensation leaves a larger one-pass
        # error than a backward-stable pivoted LU, so it refines to the
        # floor rather than the preset target)
        reltol = min(reltol, 1e-9)
        abstol = min(abstol, 1e-8)
    if compensate:
        # near μ → 0 the per-sweep contraction degrades toward 1; with the
        # compensated residual each sweep is trustworthy, so keep refining
        # while there is any monotone progress
        stopratio = min(stopratio, 1.05)
        maxiter = max(maxiter, 25)
    if factors[0] == "df_lu":
        # the double-float factor already applies with ~eps² error: one
        # polish sweep reaches the floor, and each df solve is two N-step
        # substitutions
        maxiter = min(maxiter, 2)

    normb = amax(rhs)
    tol = abstol + reltol * normb

    if compensate:
        if compensate_sparse:
            def error_norm(x, x_lo):
                hi, lo = df_mv(x, x_lo)
                d, derr = compensated._two_sum(rhs, -hi)
                e = d + (derr - lo)
                return e, amax(e)
        else:
            def error_norm(x, x_lo):
                # the residual against the double-float solution: x_lo's
                # contribution is eps-scaled, a plain product of it suffices
                e = compensated.residual(K_true, x, rhs, K_lo=K_lo) - k_matvec(x_lo)
                if K_lo is not None:
                    e = e - lo_matvec(x_lo)
                return e, amax(e)

        def accumulate(x, x_lo, dx):
            # TwoSum the correction into the double-float solution
            s, err = compensated._two_sum(x, dx)
            return s, x_lo + err
    else:
        def error_norm(x, x_lo):
            e = rhs - k_matvec(x)
            return e, amax(e)

        def accumulate(x, x_lo, dx):
            return x + dx, x_lo

    x, x_lo = x0, torch.zeros_like(x0)
    e, norme = error_norm(x, x_lo)
    ok = torch.isfinite(norme)
    done = torch.zeros_like(ok)
    k = 0
    # a problem sweeps while it has not stopped; every problem that sweeps
    # has swept k times, so the sweep cap is the host's k
    active = (~done) & ~(norme <= tol)
    # one device read per sweep: the loop condition
    while k < maxiter and host_read(active.any()):
        solve_refined.sweeps += 1
        dx = _raw_solve(factors, e)
        xnew, xnew_lo = accumulate(x, x_lo, dx)
        enew, normenew = error_norm(xnew, xnew_lo)
        isfin = torch.isfinite(normenew)

        improved_ratio = norme / normenew
        # stalling: keep the better iterate and stop
        # (directldlkktsolver.rs:305-315)
        stalled = improved_ratio < stopratio
        take_new = active & isfin & ((~stalled) | (improved_ratio > 1.0))

        x = torch.where(per_problem(take_new), xnew, x)
        if compensate:
            x_lo = torch.where(per_problem(take_new), xnew_lo, x_lo)
        e = torch.where(per_problem(take_new), enew, e)
        norme = torch.where(take_new, normenew, norme)
        done = torch.where(active, stalled | (~isfin), done)
        ok = torch.where(active, ok & isfin, ok)
        active = (~done) & ~(norme <= tol)
        k += 1
    ok = ok & all_(torch.isfinite(x))
    if want_lo:
        return (x, x_lo if compensate else None), ok
    return x, ok


#: refined solves, and refinement sweeps over them (host counters)
solve_refined.calls = 0
solve_refined.sweeps = 0

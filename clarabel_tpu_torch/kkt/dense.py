"""Dense KKT solvers: assembly, factorization, refined solves.

PyTorch port of the f64 paths of ``clarabel_tpu/kkt/dense.py`` and of its
Schur-complement engines at f64 and f32
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
:266-321).  The refinement loop is a host loop that reads one scalar per
sweep from the device.

Every function takes the data with leading batch dimensions or without
(K [..., N, N], right-hand sides [..., N]); ε, ``ok``, the capacitances and
the refinement's progress are then per problem, and a problem whose
refinement has stopped keeps its solution while the others sweep on, as
``jax.vmap`` of the JAX package's ``lax.while_loop`` keeps it.  A problem
whose matrix is not positive definite gets a NaN Cholesky factor, as
``jnp.linalg.cholesky`` gives it, and ``ok`` False; the others do not see it.
"""

from __future__ import annotations

import torch

from . import pallas_ldl
from ..timers import host_read


def matvec(M, v):
    """M v over any leading batch dimensions (M [..., r, c], v [..., c]);
    one problem takes PyTorch's matrix-vector product itself."""
    return M @ v if v.dim() == 1 else (M @ v.unsqueeze(-1)).squeeze(-1)


_mv = matvec  # the module's matvec, under a name the Schur closures keep


def dot(a, b):
    """aᵀb over any leading batch dimensions (a, b [..., k])."""
    return a @ b if a.dim() == 1 else (a.unsqueeze(-2) @ b.unsqueeze(-1))[..., 0, 0]


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
    maxdiag = torch.maximum(_amax0(torch.diagonal(P, dim1=-2, dim2=-1)), _amax0(hs_diag))
    eps = _static_eps(settings, maxdiag, 0.0)

    h = hs_diag + eps.unsqueeze(-1)
    if eq_mask is not None:
        h = h + eq_mask * (1e-3 * maxdiag).unsqueeze(-1)
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


def _raw_solve(factors, rhs):
    kind, data = factors
    if kind == "lu":
        lu, piv = data
        vec = rhs.dim() == lu.dim() - 1
        b = rhs.unsqueeze(-1) if vec else rhs
        x = torch.linalg.lu_solve(lu, piv, b)
        return x.squeeze(-1) if vec else x
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
    callable (the structured Schur paths).

    Returns (x, ok), or ((x, None), ok) with ``want_lo`` — the JAX
    package's double-float remainder, which is None on every path that is
    not compensated (every path ported).  Each problem of a batch sweeps
    until its own refinement stops; the host reads once per sweep whether
    any problem still sweeps.
    reference: directldlkktsolver.rs:266-321 — bounded refinement loop
    with stall detection.
    """
    x0 = _raw_solve(factors, rhs)

    if not settings.iterative_refinement_enable:
        ok = torch.all(torch.isfinite(x0), dim=-1)
        return ((x0, None), ok) if want_lo else (x0, ok)
    if callable(K_true):
        k_matvec = K_true
    elif K_true.dtype == torch.float32:
        # the JAX package refines a dense f32 K in double-float
        raise NotImplementedError(
            "the compensated f32 refinement of a dense KKT matrix is not ported "
            "(ROADMAP.md Queue 1 item 12b)"
        )
    else:
        k_matvec = lambda v: matvec(K_true, v)

    reltol = settings.iterative_refinement_reltol
    abstol = settings.iterative_refinement_abstol
    maxiter = settings.iterative_refinement_max_iter
    stopratio = settings.iterative_refinement_stop_ratio
    if factors[0] == "schur_lr":
        # the Woodbury condensation leaves a larger one-pass error than a
        # backward-stable pivoted LU, so it refines to the floor rather
        # than the preset target
        reltol = min(reltol, 1e-9)
        abstol = min(abstol, 1e-8)

    normb = torch.amax(torch.abs(rhs), dim=-1)
    tol = abstol + reltol * normb

    def error_norm(x):
        e = rhs - k_matvec(x)
        return e, torch.amax(torch.abs(e), dim=-1)

    x = x0
    e, norme = error_norm(x0)
    ok = torch.isfinite(norme)
    done = torch.zeros_like(ok)
    k = 0
    # a problem sweeps while it has not stopped; every problem that sweeps
    # has swept k times, so the sweep cap is the host's k
    active = (~done) & ~(norme <= tol)
    # one device read per sweep: the loop condition
    while k < maxiter and host_read(active.any()):
        dx = _raw_solve(factors, e)
        xnew = x + dx
        enew, normenew = error_norm(xnew)
        isfin = torch.isfinite(normenew)

        improved_ratio = norme / normenew
        # stalling: keep the better iterate and stop
        # (directldlkktsolver.rs:305-315)
        stalled = improved_ratio < stopratio
        take_new = active & isfin & ((~stalled) | (improved_ratio > 1.0))

        x = torch.where(take_new.unsqueeze(-1), xnew, x)
        e = torch.where(take_new.unsqueeze(-1), enew, e)
        norme = torch.where(take_new, normenew, norme)
        done = torch.where(active, stalled | (~isfin), done)
        ok = torch.where(active, ok & isfin, ok)
        active = (~done) & ~(norme <= tol)
        k += 1
    ok = ok & torch.all(torch.isfinite(x), dim=-1)
    return ((x, None), ok) if want_lo else (x, ok)

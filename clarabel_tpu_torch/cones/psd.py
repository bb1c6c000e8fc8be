"""PSD triangle cones, batched by matrix dimension.

PyTorch port of ``clarabel_tpu/cones/psd.py``, name for name, at f64 and
f32 (reference: src/solver/core/cones/psdtrianglecone.rs).  All cones of
equal matrix dimension n batch into [..., k, n, n] tensors, leading
dimensions being batch dimensions as everywhere in the port, and go through
batched linear algebra (Cholesky, SVD, symmetric eigenvalues): the
reference's per-cone LAPACK calls (xpotrf/xgesdd/xsyevr) become one batched
call per bucket.

The symmetric Kronecker product skron(A) (reference:
psdtrianglecone.rs:467-509) is materialized without loops via the closed
form  skron(A)[(ij),(kl)] = (A_ik A_jl + A_il A_jk) · f(i=j) · f(k=l)
with f(true) = 1/√2, from the bucket's svec index arrays: rows of A are
gathered first and columns second, so no tri x tri index tensor is made.

svec packing follows the reference convention: column-major upper triangle
with √2-scaled off-diagonals (algebra/dense/matrix_math.rs:165-202).

Semantics the JAX package's linear algebra gives and this port keeps:

- ``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
  definite; :func:`_cholesky` does the same from ``cholesky_ex``, which does
  not make the host wait for the device (``update_scaling``'s ``ok`` flag
  and ``compute_barrier``'s ``inf`` read those NaNs);
- ``jnp.linalg.eigvalsh`` symmetrizes its input; ``torch.linalg.eigvalsh``
  reads one triangle, so ``step_length`` symmetrizes its (rounding-level
  asymmetric) matrix first, and the other inputs are built exactly
  symmetric by ``_to_mat``.  It returns NaN for a matrix that is not finite
  (a NaN direction's step length); torch's may raise, so :func:`_eigvalsh`
  gives it the identity and NaN after;
- an SVD's singular vectors are defined up to sign (and a rotation within
  repeated singular values), so R and R⁻¹ from ``update_scaling`` match the
  JAX package's only up to those; RRᵀ, R⁻ᵀR⁻¹, λ and every quantity built
  from them do not depend on the choice.

At f32 the JAX package runs its f32 robustness stack here, and so does
this port (the JAX package's psd.py:28-36, 68-121, 160-183, 224-450):

- the NT scaling factors L with S = L Lᵀ come from ``eigh`` with the
  spectrum floored at 4·eps32·max|w|, not from Cholesky, which breaks down
  on rounding near strict complementarity (eig_min(S) ~ μ < eps32·‖S‖).  S
  and Z of a bucket go through one ``eigh`` call; a matrix that is not
  finite takes the identity there and NaN after, with ``ok`` False, as the
  JAX package's ``eigh`` of a NaN matrix returns NaN (torch's may raise);
- on buckets of order n ≤ ``_DF_AXA_MAX_N`` the congruences A·X·A, RᵀXR and
  RXRᵀ, the svec conversions and the KKT's skron blocks are evaluated in
  double-float (``kkt/compensated.py``): with ‖Hs‖ ~ 1/μ the plain f32
  products' rounding is the whole f32 error budget.  ``hs_dense`` then
  writes the skron blocks' rounding remainder into ``H_lo`` and stashes the
  (hi, lo) blocks in the scaling state (``psd{bi}_skron``), so that
  ``ops.mul_hs_df`` applies to Δz the very blocks the KKT solve saw.

The 1/√2 constants of the double-float sites are the f32-rounded ones,
treated as exact (``_EXACT_SQRT2`` False, as in the JAX package): the whole
PSD pipeline then lives in one self-consistent rounded frame.

``torch.linalg.svd``, ``torch.linalg.eigh`` and ``torch.linalg.eigvalsh``
check their results on the host, so on a CUDA device each call makes the
host wait for the device: one SVD per bucket in ``update_scaling`` (and at
f32 one ``eigh``), two ``eigvalsh`` per bucket in ``step_length`` and one in
``margins``.  These waits do not go through ``timers.host_read``.  A call
that does not converge at f32 is repeated in f64 (:func:`_converged`).

Scaling-state entries produced here, per bucket ``bi``:
    psd{bi}_R      [..., k, n, n]   NT scaling factor R (W = R⁻¹ form)
    psd{bi}_Rinv   [..., k, n, n]   its inverse
    psd{bi}_lam    [..., k, n]      the scaled point λ's eigenvalues
    psd{bi}_skron  ([..., k, tri, tri], [..., k, tri, tri])  the KKT's
                   double-float skron blocks (f32, n ≤ _DF_AXA_MAX_N; set by
                   ``hs_dense(H_lo=)`` on the iteration's own state)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import api
from .layout import ConeLayout
from .ops import _min_init
from ..kkt import compensated as dfc
from ..kkt.dense import _lane_exact, pairwise_sum

_RSQRT2 = 1.0 / math.sqrt(2.0)

#: the frame of the double-float sites' 1/√2 constants: False (as in the JAX
#: package) treats the f32-rounded constant as exact at every svec and skron
#: site; True adds each constant's lo part, at the double-float sites only
#: (the JAX package measured it worse: 46/64 against 64/64 lanes Solved on
#: its batched SDP bench)
_EXACT_SQRT2 = False

#: the largest bucket order whose congruences run in double-float at f32:
#: the exact-product tensors take [..., k, n, n, n]; larger buckets keep the
#: plain f32 products
_DF_AXA_MAX_N = 32

#: the f32 eigh floor, a multiple of eps32 times the largest |eigenvalue|
_EIGH_FLOOR = 4.0 * float(np.finfo(np.float32).eps)


def _psd_slice(layout):
    return layout.slice_of(api.PSD)


def _buckets(layout: ConeLayout, like):
    """(index, bucket, its tensors) of each nonempty PSD bucket, the
    tensors in ``like``'s dtype and on its device.  An empty cone (n = 0)
    has no rows and adds nothing to any function here."""
    tensors = layout.psd_tensors(like.dtype, like.device)
    return [(bi, b, t) for bi, (b, t) in enumerate(zip(layout.psd_buckets, tensors)) if b.n]


def _gather(layout, t, v):
    """[..., m] -> the bucket's svec vectors [..., k, tri]."""
    return v[..., _psd_slice(layout)][..., t["gather"]]


def _to_mat(t, x):
    """[..., k, tri] svec -> [..., k, n, n] symmetric matrices."""
    return x[..., t["mat_pos"]] * t["mat_scale"]


def _to_svec(t, M):
    """[..., k, n, n] (possibly nonsymmetric) -> [..., k, tri] svec,
    symmetrizing."""
    up = M[..., t["I"], t["J"]]
    lo = M[..., t["J"], t["I"]]
    return torch.where(t["is_diag"], up, (up + lo) * _RSQRT2)


def _diag_rows(layout, t):
    """The rows of the bucket's matrix diagonals in the m-vector."""
    return _psd_slice(layout).start + t["gather"][:, t["diag_pos"]].reshape(-1)


def _cholesky(M):
    """Lower Cholesky factors of ``M [..., n, n]``, NaN where a matrix is not
    positive definite (``jnp.linalg.cholesky``), without a device wait."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _converged(fn, M):
    """``fn(M)``, a batched eigenvalue solve or SVD.  Where it does not
    converge at f32 -- cuSOLVER's batched Jacobi, which torch takes for
    batches of small matrices on a card, can fail where LAPACK does not
    (the chordal max-cut's cliques at f32) -- the same call in f64 on the
    same device, rounded back to f32."""
    try:
        return fn(M)
    except torch.linalg.LinAlgError:
        if M.dtype != torch.float32:
            raise
        return tuple(v.to(M.dtype) for v in fn(M.double()))


def _eigvalsh(M):
    """Eigenvalues of the symmetric ``M [..., n, n]``, NaN for a matrix that
    is not finite, as ``jnp.linalg.eigvalsh`` gives them (torch's may raise
    there: it takes the identity in its place)."""
    finite = torch.isfinite(M).flatten(-2).all(-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    (w,) = _converged(lambda A: (torch.linalg.eigvalsh(A),),
                      torch.where(finite[..., None, None], M, eye))
    return torch.where(finite[..., None], w, torch.nan)


def _per_problem(flags, dims):
    """All of ``flags`` over its last ``dims`` dimensions."""
    return flags.flatten(-dims).all(dim=-1)


def _use_df(bucket, dtype):
    """Whether a bucket's congruences run in double-float: f32, n ≤ 32."""
    return dtype == torch.float32 and bucket.n <= _DF_AXA_MAX_N


def _f32_split(v64):
    """The f32-rounded value of the f64 array ``v64`` and its f32 remainder."""
    hi = v64.astype(np.float32)
    return hi, (v64 - hi.astype(np.float64)).astype(np.float32)


def _df_tensors(b, t):
    """The double-float sites' constants of bucket ``b``, added to its
    tensors ``t`` at first use: the svec unpack scale per svec position and
    the skron's factor per (row, column) pair, each as an f32 hi/lo split
    (the JAX package's ``PSDBucket.unpack_scale_h/_l``, psd.py:234-242)."""
    if "unpack_h" not in t:
        kw = dict(dtype=t["mat_scale"].dtype, device=t["mat_scale"].device)
        uh, ul = _f32_split(np.where(b.is_diag, 1.0, 1.0 / np.sqrt(2.0)))
        f = np.where(b.is_diag, 1.0 / np.sqrt(2.0), 1.0)
        fh, fl = _f32_split(f[:, None] * f[None, :])
        rh, rl = _f32_split(np.float64(_RSQRT2))
        t.update(unpack_h=torch.as_tensor(uh, **kw), unpack_l=torch.as_tensor(ul, **kw),
                 ff_h=torch.as_tensor(fh, **kw), ff_l=torch.as_tensor(fl, **kw),
                 rsqrt2_h=torch.as_tensor(rh, **kw), rsqrt2_l=torch.as_tensor(rl, **kw))
    return t


def _to_mat_df(b, t, x, x_lo=None):
    """Double-float svec -> mat, (M_hi, M_lo) [..., k, n, n]: the plain
    :func:`_to_mat` rounds x/√2 at eps, and a congruence with ‖A‖² ~ ‖Hs‖
    amplifies that by the scaling's condition number, inconsistent with the
    KKT matrix, whose skron entries absorb the √2 factors exactly."""
    t = _df_tensors(b, t)
    vh, ve = dfc._two_prod(x, t["unpack_h"])
    if _EXACT_SQRT2:
        ve = ve + x * t["unpack_l"]
    if x_lo is not None:
        ve = ve + x_lo * t["unpack_h"]
    # the diagonals take x and x_lo themselves
    ve = torch.where(t["is_diag"], 0.0 if x_lo is None else x_lo, ve)
    return vh[..., t["mat_pos"]], ve[..., t["mat_pos"]]


def _to_svec_df(b, t, Yh, Yl):
    """Double-float svec of a double-float matrix, (hi, lo) [..., k, tri]:
    the plain :func:`_to_svec` rounds (up + lo)/√2 to f32, an eps·|Y| loss
    that would undo the compensated products feeding it."""
    t = _df_tensors(b, t)
    I, J = t["I"], t["J"]
    uph, loh = Yh[..., I, J], Yh[..., J, I]
    s, e = dfc._two_sum(uph, loh)
    # a tensor, not a Python float: the split of a Python float runs in f64
    fh = t["rsqrt2_h"]
    ph, pe = dfc._two_prod(s, fh)
    low = (Yl[..., I, J] + Yl[..., J, I]) * fh + e * fh + pe
    if _EXACT_SQRT2:
        low = low + s * t["rsqrt2_l"]
    return torch.where(t["is_diag"], uph, ph), torch.where(t["is_diag"], Yl[..., I, J], low)


def _scatter(layout, parts, like):
    """The PSD group [..., m_psd] from each bucket's [..., k, tri] part."""
    out = torch.zeros(like.shape[:-1] + (layout.m_psd,), dtype=like.dtype, device=like.device)
    for t, v in parts:
        out[..., t["gather"]] = v
    return out


# -----------------------------------------------------------------
# composite hooks
# -----------------------------------------------------------------


def unit_initialization(layout: ConeLayout, z, s):
    """Identity matrices (psdtrianglecone.rs:131-136)."""
    for _, _, t in _buckets(layout, z):
        rows = _diag_rows(layout, t)
        z[..., rows] = 1.0
        s[..., rows] = 1.0
    return z, s


def set_identity_scaling(layout: ConeLayout, dtype, device, batch=()):
    """psdtrianglecone.rs:138-142"""
    state = {}
    for bi, b in enumerate(layout.psd_buckets):
        eye = torch.eye(b.n, dtype=dtype, device=device).expand(tuple(batch) + (b.count, b.n, b.n))
        state[f"psd{bi}_R"] = eye.clone()
        state[f"psd{bi}_Rinv"] = eye.clone()
        state[f"psd{bi}_lam"] = torch.ones(tuple(batch) + (b.count, b.n), dtype=dtype,
                                           device=device)
    return state


def _matmul_df_frame(A, B):
    """A @ B [..., n, n] as elementwise products and a fixed pairwise sum:
    on the double-float buckets at f32 on the CPU, whose batched products
    would round a cone's sums differently at other batch sizes
    (``kkt.dense._lane_exact``); the [..., n, n, n] products are as large as
    the double-float sites' own."""
    return pairwise_sum((A.unsqueeze(-1) * B.unsqueeze(-3)).movedim(-2, -1))


def _sqrt_factor(M):
    """U·√max(w, floor) of ``eigh(M) = (w, U)`` [..., n, n], the floor
    ``_EIGH_FLOOR``·max|w| per matrix (the JAX package's psd.py:170-182): a
    factor L with L Lᵀ = M, its spectrum floored.  A matrix that is not
    finite takes the identity here and gives NaN, as the JAX package's
    ``eigh`` of a NaN matrix does."""
    finite = torch.isfinite(M).flatten(-2).all(-1)[..., None, None]
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    w, U = _converged(torch.linalg.eigh, torch.where(finite, M, eye))
    floor = _EIGH_FLOOR * torch.abs(w).amax(dim=-1, keepdim=True)
    L = U * torch.sqrt(torch.maximum(w, floor))[..., None, :]
    return torch.where(finite, L, torch.nan)


def update_scaling(layout: ConeLayout, state, s, z):
    """NT scaling via chol(S), chol(Z) (at f32 the floored eigh square
    roots), SVD of L2ᵀL1.  Returns (state, ok), ``ok`` a bool per problem.

    reference: psdtrianglecone.rs:144-204
    """
    ok = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)
    for bi, b, t in _buckets(layout, s):
        S = _to_mat(t, _gather(layout, t, s))
        Z = _to_mat(t, _gather(layout, t, z))
        if s.dtype == torch.float32:
            # near strict complementarity eig_min(S) ~ μ drops below
            # eps32·‖S‖ and Cholesky breaks down on rounding; any S = L Lᵀ
            # serves the NT construction, so take the eigh square root with
            # the spectrum floored at a few ulps of ‖S‖ (an O(eps) inward
            # shift of the iterate).  f64 keeps Cholesky (reference
            # semantics, psdtrianglecone.rs:144-204)
            L1, L2 = _sqrt_factor(torch.stack([S, Z])).unbind(0)
        else:
            L1, L2 = _cholesky(S), _cholesky(Z)
        finite = torch.isfinite(L1).flatten(-2).all(-1) & torch.isfinite(L2).flatten(-2).all(-1)
        ok = ok & finite.all(dim=-1)

        # SVD of L2ᵀ L1 gives the NT geometric mean factors.  A cone whose
        # factor is not finite takes the identity here and NaN below, as
        # the JAX package's SVD of a NaN matrix returns NaN (torch's raises)
        mm = _matmul_df_frame if _use_df(b, s.dtype) and _lane_exact(s) else torch.matmul
        M = mm(L2.mT, L1)
        eye = torch.eye(b.n, dtype=M.dtype, device=M.device)
        U, lam, Vt = _converged(lambda A: torch.linalg.svd(A, full_matrices=False),
                                torch.where(finite[..., None, None], M, eye))
        lam_isqrt = 1.0 / torch.sqrt(lam)

        # R = L1 V Λ^{-1/2},  Rinv = Λ^{-1/2} Uᵀ L2ᵀ
        R = mm(L1, Vt.mT) * lam_isqrt[..., None, :]
        Rinv = lam_isqrt[..., :, None] * mm(U.mT, L2.mT)
        R = torch.where(finite[..., None, None], R, torch.nan)
        Rinv = torch.where(finite[..., None, None], Rinv, torch.nan)
        lam = torch.where(finite[..., None], lam, torch.nan)

        # λ = 0 (exactly singular NT mean) or a non-finite R must read as
        # a scaling failure, not poison the KKT with inf·0 = NaN
        ok = (
            ok
            & _per_problem(lam > 0, 2)
            & _per_problem(torch.isfinite(R), 3)
            & _per_problem(torch.isfinite(Rinv), 3)
        )
        state[f"psd{bi}_R"] = R
        state[f"psd{bi}_Rinv"] = Rinv
        state[f"psd{bi}_lam"] = lam
    return state, ok


def _skron(t, A):
    """Batched symmetric Kronecker product: [..., k, n, n] -> [..., k, tri, tri]."""
    I, J = t["I"], t["J"]
    rows_i, rows_j = A[..., I, :], A[..., J, :]
    term1 = rows_i[..., I] * rows_j[..., J]
    term2 = rows_i[..., J] * rows_j[..., I]
    f = t["skron_f"]
    return (term1 + term2) * (f[:, None] * f[None, :])


def _skron_df(b, t, Ah, Al):
    """skron of a double-float A, (hi, lo) [..., k, tri, tri], its 1/√2
    factors applied as double-float constants (an f32-rounded factor would
    perturb every off-diagonal entry by eps32, at ‖Hs‖ ~ 1/μ the whole f32
    error budget: the JAX package measured 6e-8·‖Hs‖ pair errors)."""
    t = _df_tensors(b, t)
    I, J = t["I"], t["J"]
    pick = lambda M, r, c: M[..., r, :][..., c]

    def df_prod(xh, xl, yh, yl):
        ph, pe = dfc._two_prod(xh, yh)
        return ph, pe + xh * yl + xl * yh

    t1h, t1l = df_prod(pick(Ah, I, I), pick(Al, I, I), pick(Ah, J, J), pick(Al, J, J))
    t2h, t2l = df_prod(pick(Ah, I, J), pick(Al, I, J), pick(Ah, J, I), pick(Al, J, I))
    sh, se = dfc._two_sum(t1h, t2h)
    slo = t1l + t2l + se
    ph, pe = dfc._two_prod(sh, t["ff_h"])
    lo = pe + slo * t["ff_h"]
    if _EXACT_SQRT2:
        lo = lo + sh * t["ff_l"]
    return ph, lo


def hs_dense(layout: ConeLayout, state, H, H_lo=None):
    """Hs = skron(RRᵀ) per cone, written into ``H [..., m, m]`` in place
    (psdtrianglecone.rs:190-204).  Returns (H, H_lo).

    With ``H_lo`` given (the f32 KKT), the blocks of buckets of order
    n ≤ ``_DF_AXA_MAX_N`` are evaluated in double-float, their rounding
    remainder written into ``H_lo``, and both stashed in ``state`` as
    ``psd{bi}_skron``: ``ops.mul_hs_df`` applies those very blocks, so the
    Δs recovery is consistent with the solved K by construction (two
    separately rounded skron evaluations differ at eps·‖Hs‖, near μ → 0 the
    whole error budget).  ``state`` is the iteration's own scaling state,
    rebuilt by every ``update_scaling``, so a stash never outlives it."""
    start = _psd_slice(layout).start
    for bi, b, t in _buckets(layout, H):
        R = state[f"psd{bi}_R"]
        g = start + t["gather"]
        rows, cols = g[:, :, None], g[:, None, :]
        if H_lo is not None and _use_df(b, H.dtype):
            bh, bl = _skron_df(b, t, *dfc.df_matmul(R, R.mT))
            H[..., rows, cols] = bh
            H_lo[..., rows, cols] = bl
            state[f"psd{bi}_skron"] = (bh, bl)
        else:
            H[..., rows, cols] = _skron(t, R @ R.mT)
    return H, H_lo


def _df_axa(R, X, Xl=None):
    """A·X·A with A = RRᵀ in double-float, (Y_hi, Y_lo).  Near convergence
    ‖Hs‖ ~ 1/μ, so the plain f32 product's rounding O(eps·‖A‖²·‖X‖) reaches
    ~1e-4 relative and lands in Δs; the error-free products keep it at
    ~eps².  ``Xl`` optionally carries X's lo part."""
    Ah, Al = dfc.df_matmul(R, R.mT)
    Th, Tl = dfc.df_matmul_df(Ah, Al, X, torch.zeros_like(X) if Xl is None else Xl)
    return dfc.df_matmul_df(Th, Tl, Ah, Al)


def _mul_w_mat_df(R, X, transpose: bool, Xl=None):
    """The congruence W-product on matrices in double-float, (Y_hi, Y_lo):
    N: Y = Rᵀ X R ;  T: Y = R X Rᵀ.  ``Xl`` optionally carries X's lo part.
    The rounding of the product chain is ~eps²·norms instead of
    eps·‖R‖²·‖X‖, the f32 noise floor that stalls PSD problems near μ → 0."""
    Lm, Rr = (R, R.mT) if transpose else (R.mT, R)
    if Xl is None:
        Th, Tl = dfc.df_matmul(Lm, X)
    else:
        Th, Tl = dfc.df_matmul_df(Lm, torch.zeros_like(Lm), X, Xl)
    return dfc.df_matmul_df(Th, Tl, Rr, torch.zeros_like(Rr))


def mul_hs(layout: ConeLayout, state, x, y):
    """y = Hs x = svec(A·mat(x)·A) with A = RRᵀ (psdtrianglecone.rs:214-218)."""
    parts = []
    for bi, b, t in _buckets(layout, x):
        R = state[f"psd{bi}_R"]
        X = _to_mat(t, _gather(layout, t, x))
        if _use_df(b, x.dtype):
            Yh, Yl = _df_axa(R, X)
            parts.append((t, _to_svec(t, Yh) + _to_svec(t, Yl)))
        else:
            A = R @ R.mT
            parts.append((t, _to_svec(t, A @ X @ A.mT)))
    y[..., _psd_slice(layout)] = _scatter(layout, parts, x)
    return y


def affine_ds(layout: ConeLayout, state, ds):
    """λ∘λ = diag(λ²) in svec form (psdtrianglecone.rs:220-225)."""
    di = torch.zeros(ds.shape[:-1] + (layout.m_psd,), dtype=ds.dtype, device=ds.device)
    for bi, _, t in _buckets(layout, ds):
        di[..., t["gather"][:, t["diag_pos"]]] = state[f"psd{bi}_lam"] ** 2
    ds[..., _psd_slice(layout)] = di
    return ds


def _mul_w(t, R, x, transpose: bool):
    """W-products on svec vectors (psdtrianglecone.rs:363-396):
    N: Y = Rᵀ X R ;  T: Y = R X Rᵀ  (pass Rinv for the inverse forms)."""
    X = _to_mat(t, x)
    Y = R @ X @ R.mT if transpose else R.mT @ X @ R
    return _to_svec(t, Y)


def combined_ds_shift(layout: ConeLayout, state, shift, step_z, step_s, sigma_mu):
    """W⁻¹Δs ∘ WΔz − σμe (symmetric_common.rs:53-84); ``sigma_mu`` is a
    per-problem scalar."""
    sm = sigma_mu[..., None, None]
    parts = []
    for bi, b, t in _buckets(layout, shift):
        R, Rinv = state[f"psd{bi}_R"], state[f"psd{bi}_Rinv"]
        if _use_df(b, shift.dtype):
            Zh, Zl = _mul_w_mat_df(R, _to_mat(t, _gather(layout, t, step_z)), transpose=False)
            Yh, Yl = _mul_w_mat_df(Rinv, _to_mat(t, _gather(layout, t, step_s)), transpose=True)
            c1h, c1l = dfc.df_matmul_df(Yh, Yl, Zh, Zl)
            c2h, c2l = dfc.df_matmul_df(Zh, Zl, Yh, Yl)
            v = _to_svec(t, 0.5 * ((c1h + c2h) + (c1l + c2l)))
        else:
            wz = _mul_w(t, R, _gather(layout, t, step_z), transpose=False)
            wis = _mul_w(t, Rinv, _gather(layout, t, step_s), transpose=True)
            Y, Z = _to_mat(t, wis), _to_mat(t, wz)
            v = _to_svec(t, 0.5 * (Y @ Z + Z @ Y))
        parts.append((t, torch.where(t["is_diag"], v + (-sm), v)))
    shift[..., _psd_slice(layout)] = _scatter(layout, parts, shift)
    return shift


def ds_from_dz_offset(layout: ConeLayout, state, out_full, ds):
    """Wᵀ(λ \\ ds) (symmetric_common.rs:89-96, psdtrianglecone.rs:317-332)."""
    parts = []
    for bi, b, t in _buckets(layout, ds):
        R, lam = state[f"psd{bi}_R"], state[f"psd{bi}_lam"]
        Z = _to_mat(t, _gather(layout, t, ds))
        X = 2.0 * Z / (lam[..., :, None] + lam[..., None, :])
        if _use_df(b, ds.dtype):
            Yh, Yl = _mul_w_mat_df(R, X, transpose=True)
            parts.append((t, _to_svec(t, Yh) + _to_svec(t, Yl)))
        else:
            parts.append((t, _mul_w(t, R, _to_svec(t, X), transpose=True)))
    out_full[..., _psd_slice(layout)] = _scatter(layout, parts, ds)
    return out_full


def step_length(layout: ConeLayout, state, dz, ds, z, s, alpha, big):
    """Min eigenvalue of Λ^{-1/2} W(Δ) Λ^{-1/2} (psdtrianglecone.rs:235-279,
    437-463), per problem."""
    del z, s
    for bi, b, t in _buckets(layout, dz):
        lam_isqrt = 1.0 / torch.sqrt(state[f"psd{bi}_lam"])
        pairs = ((dz, state[f"psd{bi}_R"], False), (ds, state[f"psd{bi}_Rinv"], True))
        for dv, Rx, transpose in pairs:
            if _use_df(b, dz.dtype):
                Mh, Ml = _mul_w_mat_df(Rx, _to_mat(t, _gather(layout, t, dv)), transpose)
                scale = lam_isqrt[..., :, None] * lam_isqrt[..., None, :]
                M = Mh * scale + Ml * scale
            else:
                M = _to_mat(t, _mul_w(t, Rx, _gather(layout, t, dv), transpose))
                M = lam_isqrt[..., :, None] * M * lam_isqrt[..., None, :]
            # the W-product is symmetric in exact arithmetic; eigvalsh
            # reads one triangle
            gamma = _eigvalsh((M + M.mT) / 2).amin(dim=-1)
            lim = torch.where(gamma < 0, -1.0 / torch.where(gamma < 0, gamma, -1.0), big)
            alpha = torch.minimum(alpha, _min_init(lim, big))
    return alpha


def compute_barrier(layout: ConeLayout, z, s, dz, ds, alpha):
    """-logdet barrier at the shifted point (psdtrianglecone.rs:281-306),
    summed per problem; ``alpha`` is a column that broadcasts over
    ``[..., m]``, as in ``ops.compute_barrier``."""
    sl = _psd_slice(layout)
    barrier = torch.zeros((), dtype=z.dtype, device=z.device)
    for _, _, t in _buckets(layout, z):
        for v, dv in ((z, dz), (s, ds)):
            Q = _to_mat(t, (v[..., sl] + alpha * dv[..., sl])[..., t["gather"]])
            L = _cholesky(Q)
            diag = torch.diagonal(L, dim1=-2, dim2=-1)
            logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-300)), dim=-1)
            good = torch.isfinite(L).flatten(-2).all(-1) & torch.all(diag > 0, dim=-1)
            barrier = barrier + torch.sum(torch.where(good, -logdet, torch.inf), dim=-1)
    return barrier


def margins(layout: ConeLayout, z, mn, total):
    """Min eigenvalue / sum of positive eigenvalues, per problem
    (psdtrianglecone.rs:104-121)."""
    for _, _, t in _buckets(layout, z):
        e = _eigvalsh(_to_mat(t, _gather(layout, t, z))).flatten(-2)
        mn = torch.minimum(mn, e.amin(dim=-1))
        total = total + torch.sum(torch.clamp(e, min=0.0), dim=-1)
    return mn, total


def scaled_unit_shift(layout: ConeLayout, z, alpha):
    """z += α·svec(I) (psdtrianglecone.rs:123-129); ``alpha`` is a column
    that broadcasts over ``[..., m]``."""
    for _, _, t in _buckets(layout, z):
        rows = _diag_rows(layout, t)
        z[..., rows] = z[..., rows] + alpha
    return z

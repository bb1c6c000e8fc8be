"""PSD triangle cones, batched by matrix dimension.

PyTorch port of the f64 functions of ``clarabel_tpu/cones/psd.py``, name for
name (reference: src/solver/core/cones/psdtrianglecone.rs).  All cones of
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
  symmetric by ``_to_mat``;
- an SVD's singular vectors are defined up to sign (and a rotation within
  repeated singular values), so R and R⁻¹ from ``update_scaling`` match the
  JAX package's only up to those; RRᵀ, R⁻ᵀR⁻¹, λ and every quantity built
  from them do not depend on the choice.

``torch.linalg.svd`` and ``torch.linalg.eigvalsh`` check their results on
the host, so on a CUDA device each call makes the host wait for the device:
one SVD per bucket in ``update_scaling``, two ``eigvalsh`` per bucket in
``step_length`` and one in ``margins``.  These waits do not go through
``timers.host_read``.

Scaling-state entries produced here, per bucket ``bi``:
    psd{bi}_R     [..., k, n, n]   NT scaling factor R (W = R⁻¹ form)
    psd{bi}_Rinv  [..., k, n, n]   its inverse
    psd{bi}_lam   [..., k, n]      the scaled point λ's eigenvalues
"""

from __future__ import annotations

import math

import torch

from . import api
from .layout import ConeLayout
from .ops import _min_init

_RSQRT2 = 1.0 / math.sqrt(2.0)


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


def _per_problem(flags, dims):
    """All of ``flags`` over its last ``dims`` dimensions."""
    return flags.flatten(-dims).all(dim=-1)


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


def update_scaling(layout: ConeLayout, state, s, z):
    """NT scaling via chol(S), chol(Z), SVD of L2ᵀL1.  Returns (state, ok),
    ``ok`` a bool per problem.

    reference: psdtrianglecone.rs:144-204
    """
    ok = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)
    for bi, b, t in _buckets(layout, s):
        L1 = _cholesky(_to_mat(t, _gather(layout, t, s)))
        L2 = _cholesky(_to_mat(t, _gather(layout, t, z)))
        finite = torch.isfinite(L1).flatten(-2).all(-1) & torch.isfinite(L2).flatten(-2).all(-1)
        ok = ok & finite.all(dim=-1)

        # SVD of L2ᵀ L1 gives the NT geometric mean factors.  A cone whose
        # factor is not finite takes the identity here and NaN below, as
        # the JAX package's SVD of a NaN matrix returns NaN (torch's raises)
        M = L2.mT @ L1
        eye = torch.eye(b.n, dtype=M.dtype, device=M.device)
        U, lam, Vt = torch.linalg.svd(torch.where(finite[..., None, None], M, eye),
                                      full_matrices=False)
        lam_isqrt = 1.0 / torch.sqrt(lam)

        # R = L1 V Λ^{-1/2},  Rinv = Λ^{-1/2} Uᵀ L2ᵀ
        R = (L1 @ Vt.mT) * lam_isqrt[..., None, :]
        Rinv = lam_isqrt[..., :, None] * (U.mT @ L2.mT)
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


def hs_dense(layout: ConeLayout, state, H):
    """Hs = skron(RRᵀ) per cone, written into ``H [..., m, m]`` in place
    (psdtrianglecone.rs:190-204)."""
    start = _psd_slice(layout).start
    for bi, _, t in _buckets(layout, H):
        R = state[f"psd{bi}_R"]
        g = start + t["gather"]
        H[..., g[:, :, None], g[:, None, :]] = _skron(t, R @ R.mT)
    return H


def mul_hs(layout: ConeLayout, state, x, y):
    """y = Hs x = svec(A·mat(x)·A) with A = RRᵀ (psdtrianglecone.rs:214-218)."""
    parts = []
    for bi, _, t in _buckets(layout, x):
        R = state[f"psd{bi}_R"]
        X = _to_mat(t, _gather(layout, t, x))
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
    for bi, _, t in _buckets(layout, shift):
        R, Rinv = state[f"psd{bi}_R"], state[f"psd{bi}_Rinv"]
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
    for bi, _, t in _buckets(layout, ds):
        R, lam = state[f"psd{bi}_R"], state[f"psd{bi}_lam"]
        Z = _to_mat(t, _gather(layout, t, ds))
        X = 2.0 * Z / (lam[..., :, None] + lam[..., None, :])
        parts.append((t, _mul_w(t, R, _to_svec(t, X), transpose=True)))
    out_full[..., _psd_slice(layout)] = _scatter(layout, parts, ds)
    return out_full


def step_length(layout: ConeLayout, state, dz, ds, z, s, alpha, big):
    """Min eigenvalue of Λ^{-1/2} W(Δ) Λ^{-1/2} (psdtrianglecone.rs:235-279,
    437-463), per problem."""
    del z, s
    for bi, _, t in _buckets(layout, dz):
        lam_isqrt = 1.0 / torch.sqrt(state[f"psd{bi}_lam"])
        pairs = ((dz, state[f"psd{bi}_R"], False), (ds, state[f"psd{bi}_Rinv"], True))
        for dv, Rx, transpose in pairs:
            M = _to_mat(t, _mul_w(t, Rx, _gather(layout, t, dv), transpose))
            M = lam_isqrt[..., :, None] * M * lam_isqrt[..., None, :]
            gamma = torch.linalg.eigvalsh((M + M.mT) / 2).amin(dim=-1)
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
        e = torch.linalg.eigvalsh(_to_mat(t, _gather(layout, t, z))).flatten(-2)
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

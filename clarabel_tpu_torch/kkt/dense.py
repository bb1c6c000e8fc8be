"""Dense KKT solver: assembly, factorization, refined solves.

PyTorch port of the f64 paths of ``clarabel_tpu/kkt/dense.py``
(reference: src/solver/core/kktsolvers/direct/quasidef/directldlkktsolver.rs).
The KKT matrix

    K = [ P   Aᵀ ]
        [ A  -Hs ]

is assembled densely; the *statically regularized* K + ε·diag(Dsigns) is
factored once per IPM iteration, by pivoted LU (``torch.linalg``) or by the
quasidefinite LDLᵀ kernels of :mod:`.pallas_ldl`, and iterative refinement
against the unregularized K recovers the accuracy — the reference's scheme
(static regularization: directldlkktsolver.rs:217-264; refinement:
:266-321).  The refinement loop is a host loop that reads one scalar per
sweep from the device.

Every function takes the data with leading batch dimensions or without
(K [..., N, N], right-hand sides [..., N]); ε, ``ok`` and the refinement's
progress are then per problem, and a problem whose refinement has stopped
keeps its solution while the others sweep on, as ``jax.vmap`` of the JAX
package's ``lax.while_loop`` keeps it.
"""

from __future__ import annotations

import torch

from . import pallas_ldl


def matvec(M, v):
    """M v over any leading batch dimensions (M [..., r, c], v [..., c]);
    one problem takes PyTorch's matrix-vector product itself."""
    return M @ v if v.dim() == 1 else (M @ v.unsqueeze(-1)).squeeze(-1)


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
    raise NotImplementedError(
        f"KKT factors of kind {kind!r} are not ported (ROADMAP.md Queue 1)"
    )


def solve_refined(factors, K_true, rhs, settings, want_lo=False):
    """Solve K x = rhs with iterative refinement against the true
    (unregularized) dense KKT matrix ``K_true``.

    Returns (x, ok), or ((x, None), ok) with ``want_lo`` — the JAX
    package's double-float remainder, which is None on every path that is
    not compensated (all f64 paths).  Each problem of a batch sweeps until
    its own refinement stops; the host reads once per sweep whether any
    problem still sweeps.
    reference: directldlkktsolver.rs:266-321 — bounded refinement loop
    with stall detection.
    """
    x0 = _raw_solve(factors, rhs)

    if not settings.iterative_refinement_enable:
        ok = torch.all(torch.isfinite(x0), dim=-1)
        return ((x0, None), ok) if want_lo else (x0, ok)
    if K_true.dtype == torch.float32:
        raise NotImplementedError(
            "the compensated f32 refinement is not ported (ROADMAP.md Queue 1 item 12)"
        )

    reltol = settings.iterative_refinement_reltol
    abstol = settings.iterative_refinement_abstol
    maxiter = settings.iterative_refinement_max_iter
    stopratio = settings.iterative_refinement_stop_ratio

    normb = torch.amax(torch.abs(rhs), dim=-1)
    tol = abstol + reltol * normb

    def error_norm(x):
        e = rhs - matvec(K_true, x)
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
    while k < maxiter and bool(active.any()):
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

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
"""

from __future__ import annotations

import torch

from . import pallas_ldl


def assemble(P, A, Hs, settings):
    """Returns (K_true, K_reg).

    reference: kkt_assembly.rs:20-52 for the block structure;
    directldlkktsolver.rs:217-264 + _compute_regularizer for the static
    regularization ε = constant + proportional·max|diag(K)| applied with
    sign +1 on the first n entries and -1 on the last m.
    """
    n = P.shape[0]
    m = A.shape[0]
    K = torch.cat([torch.cat([P, A.T], dim=1), torch.cat([A, -Hs], dim=1)], dim=0)

    if settings.static_regularization_enable:
        diag = torch.diagonal(K)
        eps = (
            settings.static_regularization_constant
            + settings.static_regularization_proportional * torch.max(torch.abs(diag))
        )
        dsigns = torch.cat(
            [torch.ones(n, dtype=K.dtype, device=K.device),
             -torch.ones(m, dtype=K.dtype, device=K.device)]
        )
        K_reg = K + torch.diag(dsigns * eps)
    else:
        K_reg = K
    return K, K_reg


def factor(K_reg):
    """Pivoted LU factorization of the regularized KKT matrix.  A singular
    matrix gives non-finite factors (``ok`` False), as LAPACK's getrf does
    for the JAX package, rather than an exception."""
    lu, piv, _ = torch.linalg.lu_factor_ex(K_reg)
    ok = torch.all(torch.isfinite(lu))
    return ("lu", (lu, piv)), ok


def _raw_solve(factors, rhs):
    kind, data = factors
    if kind == "lu":
        lu, piv = data
        vec = rhs.dim() == 1
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
    not compensated (all f64 paths).
    reference: directldlkktsolver.rs:266-321 — bounded refinement loop
    with stall detection.
    """
    x0 = _raw_solve(factors, rhs)

    if not settings.iterative_refinement_enable:
        ok = torch.all(torch.isfinite(x0))
        return ((x0, None), ok) if want_lo else (x0, ok)
    if K_true.dtype == torch.float32:
        raise NotImplementedError(
            "the compensated f32 refinement is not ported (ROADMAP.md Queue 1 item 12)"
        )

    reltol = settings.iterative_refinement_reltol
    abstol = settings.iterative_refinement_abstol
    maxiter = settings.iterative_refinement_max_iter
    stopratio = settings.iterative_refinement_stop_ratio

    normb = torch.max(torch.abs(rhs))
    tol = abstol + reltol * normb

    def error_norm(x):
        e = rhs - K_true @ x
        return e, torch.max(torch.abs(e))

    x = x0
    e, norme = error_norm(x0)
    ok = torch.isfinite(norme)
    done = torch.zeros((), dtype=torch.bool, device=rhs.device)
    k = 0
    # one device read per sweep: the loop condition
    while k < maxiter and bool((~done) & ~(norme <= tol)):
        dx = _raw_solve(factors, e)
        xnew = x + dx
        enew, normenew = error_norm(xnew)
        isfin = torch.isfinite(normenew)

        improved_ratio = norme / normenew
        # stalling: keep the better iterate and stop
        # (directldlkktsolver.rs:305-315)
        stalled = improved_ratio < stopratio
        take_new = isfin & ((~stalled) | (improved_ratio > 1.0))

        x = torch.where(take_new, xnew, x)
        e = torch.where(take_new, enew, e)
        norme = torch.where(take_new, normenew, norme)
        done = stalled | (~isfin)
        ok = ok & isfin
        k += 1
    ok = ok & torch.all(torch.isfinite(x))
    return ((x, None), ok) if want_lo else (x, ok)

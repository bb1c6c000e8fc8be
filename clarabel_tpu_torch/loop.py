"""The interior-point iteration as a host loop over device tensors.

PyTorch port of ``clarabel_tpu/loop.py`` at f64 and f32 on the dense KKT
backends and on the sparse multifrontal one (``sparse_kkt``): the
reference predictor-corrector loop and its strategy-checkpoint state machine
(reference: src/solver/core/solver.rs:242-465, 525-666), the residual/info
bookkeeping (implementations/default/residuals.rs, info.rs) and the
homogeneous-embedding KKT reduction (implementations/default/kktsystem.rs).
At f32 on a dense KKT matrix, and on the sparse path through its
compensated matvecs, the refined solves carry a double-float lo stream, and
the direction's recovery uses it (``kkt_solve_finish``), as in the JAX
package; f32 "lu" factors with the double-float LU.

The JAX package runs the loop as one ``lax.while_loop``.  Here the state is a
``SolverState`` of tensors on the problem's device, every data-dependent
choice inside an iteration stays a ``torch.where`` as in the JAX package, and
the host reads the device twice per iteration: for the loop condition and for
whether the iteration takes a step (with nonsymmetric cones the second read
also brings back whether any problem runs under dual scaling).  A
termination callback adds one read per iteration, of the progress values it
is given.  The iterative refinement inside each KKT solve reads one scalar
per sweep (``kkt.dense.solve_refined``); the Newton-Raphson primal
gradients of the power cones one every few steps
(``cones.nonsymmetric._newton_raphson``).  Every read goes through
``timers.host_read``, which counts them.

The data may carry one leading batch dimension (P [B, n, n], q [B, n],
A [B, m, n], b [B, m]): every vector is then [B, k] and every per-problem
scalar [B], and the loop solves the B problems at once, as ``jax.vmap`` of
the JAX package's loop does.  A problem whose status stops being Unsolved
at the top of an iteration is frozen: it computes along with the others and
keeps none of it.  The two device reads per iteration stay two, for the
whole batch: whether any problem is unsolved, and whether any takes a step.

On the sparse path P and A are ``algebra.coo.COOMat`` and the KKT system
is never densified: the constant-term and affine solves of an iteration,
and the two solves of the LP start, share one 2-RHS refined solve through
the multifrontal sweeps, as in the JAX package.  The sparse path takes one
problem, or a batch of one sparsity pattern (COO values [B, nnz], as
``parallel.sparse_batch`` builds them) whose lanes share the plan and each
factor's launches and freeze one by one as the dense batch's do.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from .cones import nonsymmetric as _ns
from .cones import ops as cone_ops
from .cones.ops import _col
from .kkt import compensated as _dfc, dense as kkt_dense, multifrontal
from .kkt.dense import dot as _dot, matvec as _mv
from .statuses import SCALING_DUAL, SCALING_PRIMAL_DUAL, SolverStatus
from .timers import host_read

_UNSOLVED = int(SolverStatus.Unsolved)


class SolverState(NamedTuple):
    # variables (x, s, z, τ, κ) and the saved previous iterate
    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    tau: torch.Tensor
    kappa: torch.Tensor
    px: torch.Tensor
    ps: torch.Tensor
    pz: torch.Tensor
    ptau: torch.Tensor
    pkappa: torch.Tensor

    # progress scalars (DefaultInfo; info.rs:13-64)
    mu: torch.Tensor
    sigma: torch.Tensor
    step_length: torch.Tensor
    iterations: torch.Tensor
    cost_primal: torch.Tensor
    cost_dual: torch.Tensor
    res_primal: torch.Tensor
    res_dual: torch.Tensor
    res_primal_inf: torch.Tensor
    res_dual_inf: torch.Tensor
    gap_abs: torch.Tensor
    gap_rel: torch.Tensor
    ktratio: torch.Tensor

    # previous-iteration info scalars
    prev_cost_primal: torch.Tensor
    prev_cost_dual: torch.Tensor
    prev_res_primal: torch.Tensor
    prev_res_dual: torch.Tensor
    prev_gap_abs: torch.Tensor
    prev_gap_rel: torch.Tensor

    # residual inner products needed by infeasibility certificates
    dot_qx: torch.Tensor
    dot_bz: torch.Tensor

    status: torch.Tensor
    scaling: torch.Tensor

    # consecutive iterations the insufficient-progress condition held
    ip_pending: torch.Tensor

    # per-iteration progress table [..., max_iter+1, 9]:
    # (pcost, dcost, gap_abs, gap_rel, pres, dres, k/t, μ, step)
    history: torch.Tensor


class Residuals(NamedTuple):
    rx: torch.Tensor
    rz: torch.Tensor
    rtau: torch.Tensor
    rx_inf: torch.Tensor
    rz_inf: torch.Tensor
    Px: torch.Tensor
    dot_qx: torch.Tensor
    dot_bz: torch.Tensor
    dot_sz: torch.Tensor
    dot_xPx: torch.Tensor


def compute_residuals(P, q, A, b, x, s, z, tau, kappa) -> Residuals:
    """reference: src/solver/implementations/default/residuals.rs:69-111"""
    qx = _dot(q, x)
    bz = _dot(b, z)
    sz = _dot(s, z)
    Px = _mv(P, x)
    xPx = _dot(x, Px)

    rx_inf = -_mv(A.mT, z)
    rz_inf = _mv(A, x) + s

    rx = rx_inf - Px - _col(tau) * q
    rz = rz_inf - _col(tau) * b
    rtau = qx + bz + kappa + xPx / tau

    return Residuals(rx, rz, rtau, rx_inf, rz_inf, Px, qx, bz, sz, xPx)


def _norm_scaled(v, w):
    """||diag(w) v||_2  (reference: VectorMath::norm_scaled)"""
    return torch.sqrt(torch.sum((v * w) ** 2, dim=-1))


def _max1(v):
    """``jnp.maximum(1.0, v)`` (NaN propagates)."""
    return torch.clamp(v, min=1.0)


def update_info(st: SolverState, r: Residuals, equil, normq, normb):
    """Unscaled costs / residual norms / gaps through the equilibration
    inverses.  reference: info.rs:112-180"""
    d, e, dinv, einv, cinv = equil
    tinv = 1.0 / st.tau

    xPx_half = r.dot_xPx * tinv * tinv / 2.0
    cost_primal = (r.dot_qx * tinv + xPx_half) * cinv
    cost_dual = (-r.dot_bz * tinv - xPx_half) * cinv

    normx = _norm_scaled(st.x, d)
    normz = _norm_scaled(st.z, e) * cinv
    norms = _norm_scaled(st.s, einv)

    res_primal_inf = (_norm_scaled(r.rx_inf, dinv) * cinv) / _max1(normz)
    res_dual_inf = torch.maximum(
        _norm_scaled(r.Px, dinv) / _max1(normx),
        _norm_scaled(r.rz_inf, einv) / _max1(normx + norms),
    )

    normx = normx * tinv
    normz = normz * tinv
    norms = norms * tinv

    res_primal = _norm_scaled(r.rz, einv) * tinv / _max1(normb + normx + norms)
    res_dual = (
        _norm_scaled(r.rx, dinv) * tinv * cinv / _max1(normq + normx + normz)
    )

    gap_abs = torch.abs(cost_primal - cost_dual)
    gap_rel = gap_abs / _max1(
        torch.minimum(torch.abs(cost_primal), torch.abs(cost_dual))
    )
    ktratio = st.kappa * tinv

    return st._replace(
        cost_primal=cost_primal,
        cost_dual=cost_dual,
        res_primal=res_primal,
        res_dual=res_dual,
        res_primal_inf=res_primal_inf,
        res_dual_inf=res_dual_inf,
        gap_abs=gap_abs,
        gap_rel=gap_rel,
        ktratio=ktratio,
        dot_qx=r.dot_qx,
        dot_bz=r.dot_bz,
    )


def _status(cond, status_if_true, otherwise):
    """int32 status tensor ``where(cond, status_if_true, otherwise)``."""
    return torch.where(cond, status_if_true, otherwise).to(torch.int32)


def check_convergence(st: SolverState, tols, statuses):
    """Shared convergence check for the full and the reduced ("almost")
    tolerance tiers.  reference: info.rs:340-389"""
    (gap_abs, gap_rel, feas, infeas_abs, infeas_rel, ktratio_tol) = tols
    solved_st, pinf_st, dinf_st = statuses

    solved = (
        (st.ktratio <= 1.0)
        & ((st.gap_abs < gap_abs) | (st.gap_rel < gap_rel))
        & (st.res_primal < feas)
        & (st.res_dual < feas)
    )
    kt_diverged = st.ktratio > (1000.0 / ktratio_tol)
    primal_inf = (st.dot_bz < -infeas_abs) & (
        st.res_primal_inf < -infeas_rel * st.dot_bz
    )
    dual_inf = (st.dot_qx < -infeas_abs) & (st.res_dual_inf < -infeas_rel * st.dot_qx)

    return _status(
        solved,
        solved_st,
        _status(
            kt_diverged & primal_inf,
            pinf_st,
            _status(kt_diverged & dual_inf, dinf_st, _UNSOLVED),
        ),
    )


def check_termination(st: SolverState, settings, dtype):
    """reference: info.rs:182-231"""
    full_tols = (
        settings.tol_gap_abs,
        settings.tol_gap_rel,
        settings.tol_feas,
        settings.tol_infeas_abs,
        settings.tol_infeas_rel,
        settings.tol_ktratio,
    )
    status = check_convergence(
        st,
        full_tols,
        (
            int(SolverStatus.Solved),
            int(SolverStatus.PrimalInfeasible),
            int(SolverStatus.DualInfeasible),
        ),
    )

    eps = float(torch.finfo(dtype).eps)
    going_backwards = (st.res_dual > st.prev_res_dual) | (
        st.res_primal > st.prev_res_primal
    )
    poor_progress_hi = (st.ktratio < eps * 100.0) & (
        (st.prev_gap_abs < settings.tol_gap_abs)
        | (st.prev_gap_rel < settings.tol_gap_rel)
    )
    diverging = (st.ktratio < 1.0) & (
        (
            (st.res_dual > settings.tol_feas * 100.0)
            & (st.res_dual > st.prev_res_dual * 100.0)
        )
        | (
            (st.res_primal > settings.tol_feas * 100.0)
            & (st.res_primal > st.prev_res_primal * 100.0)
        )
    )
    insufficient_now = (
        (status == _UNSOLVED)
        & (st.iterations > 1)
        & going_backwards
        & (poor_progress_hi | diverging)
    )
    # f32 requires the condition on two consecutive iterations; f64 keeps
    # the reference's immediate trigger (solver.rs:586-609)
    strikes = 2 if dtype == torch.float32 else 1
    insufficient = insufficient_now & (st.ip_pending >= strikes - 1)
    status = _status(insufficient, int(SolverStatus.InsufficientProgress), status)

    status = _status(
        (status == _UNSOLVED) & (st.iterations == settings.max_iter),
        int(SolverStatus.MaxIterations),
        status,
    )
    ip_pending = torch.where(insufficient_now, st.ip_pending + 1, 0).to(torch.int32)
    return status, ip_pending


def calc_mu(layout, r: Residuals, tau, kappa):
    """reference: variables.rs:62-65"""
    return (r.dot_sz + tau * kappa) / (layout.degree + 1)


def calc_step_length(layout, state, step, variables, settings, is_combined, scaling,
                     any_dual=True):
    """reference: variables.rs:117-154 + solver.rs:547-584

    ``scaling`` is each problem's strategy; ``any_dual`` (a host bool) says
    whether any problem that takes this step runs under dual scaling, the
    only problems the barrier backtracking changes."""
    x, s, z, tau, kappa = variables
    dx, ds, dz, dtau, dkappa = step

    big = cone_ops._big(z)
    a_tau = torch.where(dtau < 0, -tau / torch.where(dtau < 0, dtau, -1.0), big)
    a_kappa = torch.where(dkappa < 0, -kappa / torch.where(dkappa < 0, dkappa, -1.0), big)
    alpha_max = torch.clamp(torch.minimum(a_tau, a_kappa), max=1.0)

    alpha = cone_ops.step_length(layout, state, dz, ds, z, s, settings, alpha_max)

    if is_combined:
        alpha = alpha * settings.max_step_fraction

    # additional barrier limit for asymmetric cones under dual-only scaling
    # (solver.rs:560-584).  The JAX package backtracks every problem in a
    # while loop of at most 50 steps and keeps the result on the problems
    # under dual scaling.  Here the 51 candidate α of each problem are
    # built as that loop builds them and their barriers evaluated at once;
    # each problem takes its first candidate whose barrier is below 1 (the
    # last one if none is), with no device read.
    if not layout.is_symmetric and is_combined and any_dual:
        a = _ns.backtrack_candidates(alpha, settings.linesearch_backtrack_step, 50)
        cur_tau = tau.unsqueeze(-1) + a * dtau.unsqueeze(-1)
        cur_kappa = kappa.unsqueeze(-1) + a * dkappa.unsqueeze(-1)
        row = lambda v: v.unsqueeze(-2)  # [..., 1, m]: broadcasts over the candidates
        ac = a.unsqueeze(-1)
        sz = _dot(row(z) + ac * row(dz), row(s) + ac * row(ds))
        mu = (sz + cur_tau * cur_kappa) / (layout.degree + 1)
        barrier = (
            (layout.degree + 1) * cone_ops._logsafe(mu)
            - cone_ops._logsafe(cur_tau)
            - cone_ops._logsafe(cur_kappa)
        )
        barrier = barrier + cone_ops.compute_barrier(
            layout, state, row(z), row(s), row(dz), row(ds), a)
        backtracked = _ns.take(a, _ns.first_stop(~(barrier >= 1.0)))
        alpha = torch.where(scaling == SCALING_DUAL, backtracked, alpha)
    return alpha


def solve_kkt_refined(factors, K_true, rhs, settings, want_lo=False, keep_ext=False):
    """Refined KKT solve, lifting to the sparse-cone-expanded system when
    the multifrontal backend carries extension rows: the augmented system
    [K  E; Eᵀ D][x; y] = [rhs; 0] solves the original K_hs x = rhs exactly
    (reference: datamaps.rs expansion semantics).

    ``rhs`` may be [N] or [N, r] on the multifrontal backend of one problem
    (multi-RHS solves share the levelized sweeps); on a batch's, [B, N]
    (one right-hand side per lane) or [B, N, r] -- the layout follows the
    factors, not the shape, so a [B, N] with B = r is never misread.
    ``keep_ext`` returns the extension components instead of slicing them
    off; ``kkt_solve_finish`` reads Δz from the first m entries.  The
    refinement runs against the assembled K, extension rows included (at
    f32 through its compensated ``.df`` product), and with ``want_lo`` the
    solution's lo stream comes back shaped as the solution.  The JAX
    package's loop.py:338-370."""
    if factors[0] == "mf":
        ctx, _, mff = factors[1]
        batched = bool(multifrontal.batch_shape(mff))
        vec = batched and rhs.dim() == 2
        if vec:
            rhs = rhs.unsqueeze(-1)  # [B, N, 1]: the batched solves' layout
        rows = 1 if batched else 0  # the dimension of the N entries
        base = rhs.shape[rows]
        pad = ctx.N - base
        if pad > 0:
            zshape = list(rhs.shape)
            zshape[rows] = pad
            rhs = torch.cat([rhs, torch.zeros(zshape, dtype=rhs.dtype, device=rhs.device)],
                            dim=rows)
        out, ok = kkt_dense.solve_refined(factors, K_true, rhs, settings, want_lo=want_lo)

        def finish(v):
            if v is None:
                return None
            if pad > 0 and not keep_ext:
                v = v.narrow(rows, 0, base)
            return v.squeeze(-1) if vec else v

        if want_lo:
            return (finish(out[0]), finish(out[1])), ok
        return finish(out), ok
    return kkt_dense.solve_refined(factors, K_true, rhs, settings, want_lo=want_lo)


def kkt_solve_rhs(layout, scaling_state, rhs, variables, is_combined):
    """Assemble the reduced KKT right-hand side [rx; ds_const - rz].

    reference: kktsystem.rs:127-158.  Returns (stacked_rhs, ds_const)."""
    x, s, z, tau, kappa = variables
    rx, rs, rz, rtau, rkappa = rhs

    # constant term c in HₛΔz + Δs = -c (kktsystem.rs:146-158)
    if is_combined:
        ds_const = cone_ops.ds_from_dz_offset(layout, scaling_state, rs, z)
    else:
        ds_const = s

    return torch.cat([rx, ds_const - rz], dim=-1), ds_const


def _df_dot(u, v):
    """uᵀv over the last dimension as a compensated (hi, lo) pair."""
    p, e = _dfc._two_prod(u, v)
    return _dfc._df_reduce_last(p, e)


def _df_matvec(P, v):
    """P v as a compensated (hi, lo) pair: elementwise products and a fixed
    reduction tree over the last dimension, so a problem sums the same alone
    and inside a batch, to ~eps²."""
    p, e = _dfc._two_prod(P, v.unsqueeze(-2))
    return _dfc._df_reduce_last(p, e)


def _df_dot_mv(u, vh, vl):
    h, l = _df_dot(u, vh)
    return h, l + _dot(u, vl)


def _df_acc(pairs, like):
    """The sum of (hi, lo) pairs, TwoSummed, rounded once."""
    th, tl = torch.zeros_like(like), torch.zeros_like(like)
    for h, l in pairs:
        th, e = _dfc._two_sum(th, h)
        tl = tl + e + l
    return th + tl


def _dtau_terms_df(P, q, b, m, xi, x1, z1f, x2, z2, sol_lo, x2_lo, z2_lo, rtau, rkappa,
                   tau, kappa):
    """The Δτ numerator and denominator of :func:`kkt_solve_finish` in
    double-float (the JAX package's loop.py:416-522, dense P).  Both are
    cancellation-prone dot products of homogeneous solutions of size
    ~1/σ_min(K); the lo streams of those solutions are part of the sum (the
    JAX package measured a 1000 % Δτ error at cond(K) ~ 1e12 without them)."""
    n = x1.shape[-1]
    x1_lo, z1_lo = sol_lo[..., :n], sol_lo[..., n:]
    qx1 = _df_dot(q, x1)
    bz1 = _df_dot(b, z1f[..., :m])
    xiPx1 = _df_dot_mv(xi, *_df_matvec(P, x1))
    tau_num = _df_acc([
        (rtau, torch.zeros_like(rtau)), (-rkappa / tau, 0.0), qx1, bz1,
        (2.0 * xiPx1[0], 2.0 * xiPx1[1]),
        (_dot(q, x1_lo), 0.0), (_dot(b, z1_lo[..., :m]), 0.0),
        (2.0 * _dot(xi, _mv(P, x1_lo)), 0.0),
    ], rtau)
    xi_m_x2 = xi - x2
    qx2 = _df_dot(q, x2)
    bz2 = _df_dot(b, z2[..., :m])
    t1 = _df_dot_mv(xi_m_x2, *_df_matvec(P, xi_m_x2))
    t2 = _df_dot_mv(x2, *_df_matvec(P, x2))
    den_pairs = [
        (kappa / tau, 0.0), (-qx2[0], -qx2[1]), (-bz2[0], -bz2[1]), t1, (-t2[0], -t2[1]),
    ]
    if x2_lo is not None:
        # first-order lo corrections of the quadratic forms
        Px2_lo = _mv(P, x2_lo)
        den_pairs += [
            (-_dot(q, x2_lo), 0.0), (-_dot(b, z2_lo[..., :m]), 0.0),
            (-2.0 * _dot(xi_m_x2, Px2_lo), 0.0), (-2.0 * _dot(x2, Px2_lo), 0.0),
        ]
    return tau_num, _df_acc(den_pairs, rtau)


def kkt_solve_finish(
    layout, scaling_state, P, q, A, b, x2, z2, sol, ds_const, rhs, variables, K_true=None,
):
    """Recover the full direction from the reduced solve: Δτ closed form
    with P-quadratic terms, then Δx/Δz/Δs/Δκ (kktsystem.rs:160-207).

    ``sol``, ``x2`` and ``z2`` are (hi, lo) pairs; lo is None unless the
    refinement was compensated (an f32 system).  Then, as in the JAX
    package (its loop.py:389-598): on a dense P, Δτ's numerator and
    denominator are summed in double-float (the sparse path's COO P keeps
    the plain dots); the recombinations x1 + Δτ·x2 and z1 + Δτ·z2,
    cancellations near convergence, are TwoProd/TwoSum'd with their lo
    parts; and Δs = -(HₛΔz + c) carries HₛΔz as a double-float pair through
    the cancellation with c.  Where ``K_true`` is a matvec with a
    compensated ``.df`` (the sparse path), HₛΔz is the z-block rows of
    K [0; Δz] as the refined solve saw them, the sparse-cone expansion's
    extension columns included (the z-parts of ``sol`` and ``z2`` then
    carry the extension components, m + p long; Δz is their first m).
    Every reduction is over the last dimension, so a problem in a batch
    computes what it does alone."""
    n = q.shape[-1]
    m = b.shape[-1]
    x, s, z, tau, kappa = variables
    rx, rs, rz, rtau, rkappa = rhs
    sol, sol_lo = sol
    (x2, x2_lo), (z2, z2_lo) = x2, z2
    x1, z1f = sol[..., :n], sol[..., n:]

    # Δτ (kktsystem.rs:168-190)
    xi = x / _col(tau)
    if sol_lo is not None and sol.dtype == torch.float32 and isinstance(P, torch.Tensor):
        tau_num, tau_den = _dtau_terms_df(P, q, b, m, xi, x1, z1f, x2, z2, sol_lo, x2_lo,
                                          z2_lo, rtau, rkappa, tau, kappa)
    else:
        tau_num = (
            rtau - rkappa / tau + _dot(q, x1) + _dot(b, z1f[..., :m])
            + 2.0 * _dot(xi, _mv(P, x1))
        )
        xi_m_x2 = xi - x2
        tau_den = (
            kappa / tau
            - _dot(q, x2)
            - _dot(b, z2[..., :m])
            + _dot(xi_m_x2, _mv(P, xi_m_x2))
            - _dot(x2, _mv(P, x2))
        )
    dtau = tau_num / tau_den

    if sol_lo is None:
        dx = x1 + _col(dtau) * x2
        dzf = z1f + _col(dtau) * z2
        dz = dzf[..., :m]
        # Δs = -(HₛΔz + c)  (kktsystem.rs:195-199)
        ds = -(cone_ops.mul_hs(layout, scaling_state, dz) + ds_const)
    else:
        # the homogeneous solutions grow ~1/σ_min(K) while their
        # combination is the O(step) direction: TwoProd/TwoSum recover the
        # cancelled bits; dz keeps its lo stream for the Hₛ product, dx
        # collapses to f32
        ph, pe = _dfc._two_prod(_col(dtau), z2)
        dzf, e2 = _dfc._two_sum(z1f, ph)
        dz_lo = sol_lo[..., n:] + pe + e2
        if z2_lo is not None:
            dz_lo = dz_lo + _col(dtau) * z2_lo
        pxh, pxe = _dfc._two_prod(_col(dtau), x2)
        dx, ex = _dfc._two_sum(x1, pxh)
        dx_lo = sol_lo[..., :n] + pxe + ex
        if x2_lo is not None:
            dx_lo = dx_lo + _col(dtau) * x2_lo
        dx = dx + dx_lo
        dz = dzf[..., :m]
        # Δs through Hₛ, with HₛΔz + c TwoSummed before its one rounding.
        # The product must agree with the Hₛ the refined solve saw to better
        # than eps·‖Hₛ‖, else the primal residual absorbs (ΔHₛ)Δz ~ eps/μ
        df_mv = getattr(K_true, "df", None) if callable(K_true) else None
        if df_mv is not None:
            # K-consistent: the z-block rows of K [0; Δz; Δy] are exactly
            # -(HₛΔz) as the refined solve saw it, extension elimination
            # included (the JAX package's loop.py:567-580)
            zn = dzf.new_zeros(dzf.shape[:-1] + (n,))
            vh, vl = torch.cat([zn, dzf], dim=-1), torch.cat([zn, dz_lo], dim=-1)
            if vh.dim() == 2:  # a batch's [B, N]: the sparse matvecs take [B, N, r]
                hi, lo2 = df_mv(vh.unsqueeze(-1), vl.unsqueeze(-1))
                hi, lo2 = hi.squeeze(-1), lo2.squeeze(-1)
            else:
                hi, lo2 = df_mv(vh, vl)
            hs_hi, hs_lo = -hi[..., n:n + m], -lo2[..., n:n + m]
        else:
            hs_hi, hs_lo = cone_ops.mul_hs_df(layout, scaling_state, dz, dz_lo[..., :m])
        sh, se = _dfc._two_sum(hs_hi, ds_const)
        ds = -(sh + (se + hs_lo))

    # Δκ (kktsystem.rs:202-203)
    dkappa = -(rkappa + kappa * dtau) / tau

    return (dx, ds, dz, dtau, dkappa)


def kkt_solve(
    layout, scaling_state, factors, K_true, P, q, A, b, x2, z2,
    rhs, variables, settings, is_combined,
):
    """Reduced 2-solve strategy for the homogeneous KKT system.

    reference: kktsystem.rs:127-209 — solve for (x1, z1), recover Δτ from the
    closed form with P-quadratic terms, then Δx/Δz/Δs/Δκ.
    """
    stacked, ds_const = kkt_solve_rhs(
        layout, scaling_state, rhs, variables, is_combined
    )
    sol, ok = solve_kkt_refined(
        factors, K_true, stacked, settings, want_lo=True, keep_ext=True
    )
    step = kkt_solve_finish(
        layout, scaling_state, P, q, A, b, x2, z2, sol, ds_const, rhs,
        variables, K_true=K_true,
    )
    return step, ok


def _resolved_kkt_method(layout, settings, dtype, n, use_pallas=False):
    """Resolve the KKT backend name from settings + problem structure,
    exactly as the JAX package resolves it (``use_pallas`` means "the
    device is a CUDA device" here, "a TPU" there)."""
    method = settings.direct_solve_method
    is_f32 = dtype == torch.float32
    if method == "auto":
        no_nonsym_no_psd = (
            layout.num_exp == 0
            and layout.num_pow == 0
            and layout.num_genpow == 0
            and layout.num_psd == 0
        )
        diag_hs = no_nonsym_no_psd and layout.m_soc == 0
        if is_f32 and diag_hs:
            method = "schur_diag"
        elif is_f32 and no_nonsym_no_psd:
            method = "schur_lr"
        elif (
            is_f32
            and use_pallas
            and layout.is_symmetric
            and layout.num_psd == 0
            and (n + layout.m) <= 1024
        ):
            method = "pallas"
        else:
            method = "lu"
    return method


def _demoted_kkt_method(layout, method):
    """The method ``_kkt_prepare`` runs: the structured Schur paths only
    represent zero/NN (and, for "schur_lr", SOC) scalings, so an explicit
    request on another layout falls back to "lu", as the JAX package's
    ``_kkt_prepare`` does (clarabel_tpu/loop.py:715-723)."""
    has_nonsym_or_psd = (
        layout.num_exp or layout.num_pow or layout.num_genpow or layout.num_psd
    )
    if method == "schur_lr" and has_nonsym_or_psd:
        return "lu"
    if method == "schur_diag" and (has_nonsym_or_psd or layout.m_soc):
        return "lu"
    return method


def _kkt_prepare(layout, settings, dtype, n, use_pallas, P, A, scaling_state,
                 sparse_kkt=None):
    """Build KKT factors for the current scaling state.

    Returns (factors, K_true, ok) with K_true the unregularized KKT matrix
    for iterative refinement: dense, or a matvec callable on the structured
    Schur paths and the sparse path, which never materialize it.

    With ``sparse_kkt = (ctx, data)`` (``kkt.sparse``) the Hs block values
    scatter into the KKT's lower-triangle nonzero vector and the
    multifrontal engine refactors it (reference: qdldl.rs:468-700,
    kkt_assembly.rs:20-183); the JAX package's loop.py:679-712.
    """
    if sparse_kkt is not None:
        from .kkt import sparse as kkt_sparse

        ctx, data = sparse_kkt
        device = P.data.device
        batch = P.data.shape[:-1]
        hs_vals = cone_ops.hs_lower_vals(layout, scaling_state, dtype, device, batch,
                                         ctx.soc_expanded, ctx.genpow_expanded)
        exp_vals = cone_ops.expansion_vals(layout, scaling_state, dtype, device, batch,
                                           ctx.soc_expanded, ctx.genpow_expanded)
        if ctx.dia_recipe and P.kd is not None and A.kd is not None:
            # zero/NN layouts: the Kvals vector is never materialized --
            # sources scatter straight into the multifrontal assembly
            # workspace (fused factor) and K's DIA lanes assemble from the
            # predia'd P/A lanes + the Hs diagonal
            mff, ok = kkt_sparse.factor_fused(ctx, data, P, A, hs_vals, exp_vals, settings)
            K_true = kkt_sparse.make_matvec_sources(ctx, P, A, hs_vals)
        else:
            Kvals, Kreg = kkt_sparse.assemble(ctx, data, P, A, hs_vals, exp_vals, settings)
            mff, ok = kkt_sparse.factor(ctx, data, Kreg, settings)
            K_true = kkt_sparse.make_matvec(ctx, data, Kvals)
        return ("mf", (ctx, data, mff)), K_true, ok

    method = _demoted_kkt_method(
        layout, _resolved_kkt_method(layout, settings, dtype, n, use_pallas)
    )
    batch = P.shape[:-2]
    if method == "schur_diag":
        # diag(Hs) feeds the weighted Gram Schur factor; the zero cones
        # lead the row order
        hs_d = cone_ops.hs_diag(layout, scaling_state, dtype, P.device, batch)
        eq_mask = layout.zero_row_mask(dtype, P.device) if layout.n_zero else None
        return kkt_dense.prepare_schur_diag(P, A, hs_d, settings, eq_mask)
    if method == "schur_lr":
        h, U = cone_ops.hs_diag_lowrank(layout, scaling_state, dtype, P.device, batch)
        return kkt_dense.prepare_schur_lowrank(P, A, h, U, settings, n_eq=layout.n_zero)

    Hs, Hs_lo = cone_ops.hs_dense(layout, scaling_state, dtype, P.device, batch,
                                  want_lo=True)
    K, K_reg = kkt_dense.assemble(P, A, Hs, settings)
    # f32 PSD layouts: K is a double-float (K, K_lo) pair, K_lo the PSD Hs
    # blocks' rounding remainder (the JAX package's loop.py:763-789); the
    # factor is of the hi part, the refinement refines against hi + lo
    K_lo = None
    if Hs_lo is not None:
        K_lo = torch.zeros_like(K)
        K_lo[..., n:, n:] = -Hs_lo
    if method == "lu" and dtype == torch.float32:
        # f32 "lu" (and only that name; its aliases take the plain pivoted
        # LU with the compensated refinement): the double-float LU, the only
        # f32 dense factorization whose refinement still contracts at the
        # cond(K) ~ 1/μ² reached at strict complementarity, factoring
        # K_reg + K_lo; above DF_LU_MAX_DIM the Jacobi-equilibrated LU (the
        # JAX package's loop.py:764-781)
        if K.shape[-1] <= kkt_dense.DF_LU_MAX_DIM:
            factors, ok = kkt_dense.factor_df(K_reg, K_lo)
        else:
            factors, ok = kkt_dense.factor_jacobi(K_reg, settings, n)
    else:
        factors, ok = _make_factor_fn(layout, settings, dtype, n, use_pallas, method)(K_reg)
    return factors, (K if K_lo is None else (K, K_lo)), ok


def _make_factor_fn(layout, settings, dtype, n, use_pallas=False, method=None):
    """Select the dense factorization backend: the quasidefinite LDLᵀ
    kernels for "pallas", the Schur-complement Cholesky for "schur", pivoted
    LU otherwise ("lu" and its aliases "dense", "qdldl" and "faer")."""
    if method is None:
        method = _resolved_kkt_method(layout, settings, dtype, n, use_pallas)
    if method == "pallas":
        from .kkt import pallas_ldl

        return pallas_ldl.make_ldl_factor(n, layout.m, settings, dtype)
    if method == "schur":
        return lambda K_reg: kkt_dense.factor_schur(K_reg, n)
    return kkt_dense.factor


def default_start(layout, settings, P, q, A, b, p_is_zero, dtype, use_pallas=False,
                  sparse_kkt=None):
    """Initial iterate.  reference: solver.rs:525-541, kktsystem.rs:211-259,
    variables.rs:164-178, 231-256."""
    n, m = q.shape[-1], b.shape[-1]
    batch = q.shape[:-1]
    kw = dict(dtype=dtype, device=q.device)
    one = torch.ones(batch, **kw)

    if not layout.is_symmetric:
        z, s = cone_ops.unit_initialization(layout, dtype, q.device, batch)
        return torch.zeros(batch + (n,), **kw), s, z, one, one.clone()

    # symmetric: solve the KKT system with identity scalings
    state0 = cone_ops.set_identity_scaling(layout, dtype, q.device, batch)
    factors, K, _ = _kkt_prepare(layout, settings, dtype, n, use_pallas, P, A, state0,
                                 sparse_kkt=sparse_kkt)

    if p_is_zero:
        # LP initialization (kktsystem.rs:219-245)
        rhs1 = torch.cat([torch.zeros(batch + (n,), **kw), b], dim=-1)
        rhs2 = torch.cat([-q, torch.zeros(batch + (m,), **kw)], dim=-1)
        if sparse_kkt is not None:  # share the levelized sweeps
            joint, _ = solve_kkt_refined(factors, K, torch.stack([rhs1, rhs2], dim=-1), settings)
            sol1, sol2 = joint[..., 0], joint[..., 1]
        else:
            sol1, _ = solve_kkt_refined(factors, K, rhs1, settings)
            sol2, _ = solve_kkt_refined(factors, K, rhs2, settings)
        x = sol1[..., :n]
        s = -sol1[..., n:]
        z = sol2[..., n:]
    else:
        # QP initialization (kktsystem.rs:246-257)
        sol, _ = solve_kkt_refined(factors, K, torch.cat([-q, b], dim=-1), settings)
        x = sol[..., :n]
        z = sol[..., n:]
        s = -z

    # shift (s, z) into the cone interior (variables.rs:231-256)
    s = _shift_to_cone_interior(layout, s, cone_ops.PRIMAL)
    z = _shift_to_cone_interior(layout, z, cone_ops.DUAL)

    return x, s, z, one, one.clone()


def _shift_to_cone_interior(layout, v, pd, floor=1.0):
    """reference: variables.rs:231-256.  ``floor`` is the minimum shift
    target: 1.0 for cold starts (the reference's unit-distance rule for an
    arbitrary iterate), small for warm starts -- a converged iterate sits on
    the cone boundary, and a unit shift would erase what the warm start
    carries (the JAX package's loop.py:872-879)."""
    mn, pos = cone_ops.margins(layout, v, pd)
    degree = max(layout.degree, 1)
    target = torch.clamp(0.1 * pos / degree, min=floor)

    # two-stage shift to avoid catastrophic cancellation for large margins
    shift1 = torch.where(mn <= 0, -mn, 0.0)
    shift2 = torch.where(
        mn <= 0, target, torch.where(mn < target, target - mn, 0.0)
    )
    v = cone_ops.scaled_unit_shift(layout, v, shift1, pd)
    v = cone_ops.scaled_unit_shift(layout, v, shift2, pd)
    return v


def _centering_recovery(layout, settings, scaling_state, factors, K, P, q, A, b, x2, z2, r,
                        mu, affine_rhs, variables, scaling, any_dual, comb, alpha, alpha_aff,
                        fail_ne, retry_ne):
    """The f32 PSD recovery of the JAX package (its loop.py:1180-1223): at
    cond(K) ~ 1/μ² the Mehrotra corrector is the noisiest part of the
    combined direction, so where the combined step collapses while the
    affine step was healthy (α < 0.3·α_aff, α < 0.7), a pure centering
    direction (σ = 1, no second-order term), solved on the same factors,
    replaces it if its step is more than twice as long.  Per problem.
    Returns (direction, α, fail_ne); ``centering_steps`` counts on the
    device the problems that took it."""
    z = variables[2]
    cent_shift = cone_ops.combined_ds_shift(
        layout, scaling_state, torch.zeros_like(comb[2]), torch.zeros_like(comb[1]), mu, z)
    tau, kappa = variables[3], variables[4]
    cent_rhs = (
        torch.zeros_like(r.rx),
        affine_rhs[1] + cent_shift,
        torch.zeros_like(r.rz),
        torch.zeros_like(r.rtau),
        -mu + tau * kappa,
    )
    cent, ok_cent = kkt_solve(
        layout, scaling_state, factors, K, P, q, A, b, x2, z2,
        cent_rhs, variables, settings, is_combined=True,
    )
    alpha_cent = calc_step_length(
        layout, scaling_state, cent, variables, settings,
        is_combined=True, scaling=scaling, any_dual=any_dual,
    )
    use_cent = (alpha < 0.3 * alpha_aff) & (alpha < 0.7) & (alpha_cent > 2.0 * alpha)
    _centering_recovery.centering_steps = (
        _centering_recovery.centering_steps + use_cent.sum())
    comb = tuple(_select(use_cent, c, d) for c, d in zip(cent, comb))
    alpha = torch.where(use_cent, alpha_cent, alpha)
    fail_ne = fail_ne | (use_cent & (~ok_cent) & (~retry_ne))
    return comb, alpha, fail_ne


#: the problems that took the centering direction, summed over solves on
#: the device (an int until the first f32 PSD iteration); set it to 0 to count
_centering_recovery.centering_steps = 0


def _select(mask, new, old):
    """``new`` where the per-problem ``mask`` holds, else ``old``; the mask
    broadcasts over each tensor's own trailing dimensions."""
    if new is old:
        return new
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def _select_state(mask, new: SolverState, old: SolverState) -> SolverState:
    return SolverState(*(_select(mask, a, b) for a, b in zip(new, old)))


def _write_history_row(history, iterations, row, active):
    """``history[..., iterations, :] = row`` in place, on the problems that
    are ``active`` only (each at its own iteration count)."""
    h = history.view(-1, *history.shape[-2:])
    lanes = torch.arange(h.shape[0], device=h.device)
    at = iterations.reshape(-1).long()
    h[lanes, at] = torch.where(active.reshape(-1, 1), row.reshape(h.shape[0], -1), h[lanes, at])


#: the progress values a termination callback receives, in this order
CALLBACK_KEYS = ("iterations", "cost_primal", "cost_dual", "gap_abs", "gap_rel",
                 "res_primal", "res_dual", "ktratio", "mu", "step_length")


def run_ipm(layout, settings, P, q, A, b, equil, normq, normb, p_is_zero, dtype,
            use_pallas=False, warm_start=None, callback=None, sparse_kkt=None):
    """The main loop.  Returns the final SolverState.

    ``warm_start``, when given, is an (x0, s0, z0) triple in the internal
    (equilibrated, permuted) frame used as the initial iterate, after
    shifting (s0, z0) strictly into the cone interior with a small floor;
    τ = κ = 1.  The reference always cold starts; the JAX package adds this
    for re-solve loops (its loop.py:911-927).

    ``callback``, when given, is a host function (dict of the progress
    values named in ``CALLBACK_KEYS``) -> bool, called once per iteration
    of a single problem (no batch dimension); returning True ends the solve
    with CallbackTerminated, whatever status the iteration reached
    (reference: callbacks.rs:93-96, solver.rs:311-314).  It costs one
    device read per iteration.

    ``sparse_kkt``, when given, is the ``(kkt.sparse.SparseKKT, device
    data)`` pair of the problem's sparsity pattern, whose P and A are
    COOMat (one problem, or a batch with values [B, nnz]): every KKT solve
    runs through the multifrontal engine.

    reference: solver.rs:242-465
    """
    n = q.shape[-1]
    batch = q.shape[:-1]
    asym = not layout.is_symmetric
    device = q.device
    if callback is not None and batch:
        raise ValueError("a termination callback runs on a single problem, not a batch")

    if warm_start is not None:
        x = warm_start[0]
        # small interiority floor: a warm iterate lives near the boundary
        wfloor = 1e-2
        s = _shift_to_cone_interior(layout, warm_start[1], cone_ops.PRIMAL, floor=wfloor)
        z = _shift_to_cone_interior(layout, warm_start[2], cone_ops.DUAL, floor=wfloor)
        # κ stays at the cold value, as in the JAX package
        tau = torch.ones(batch, dtype=dtype, device=device)
        kappa = torch.ones(batch, dtype=dtype, device=device)
    else:
        x, s, z, tau, kappa = default_start(
            layout, settings, P, q, A, b, p_is_zero, dtype, use_pallas,
            sparse_kkt=sparse_kkt,
        )

    f = lambda v: torch.full(batch, v, dtype=dtype, device=device)
    i32 = lambda v: torch.full(batch, v, dtype=torch.int32, device=device)
    init_scaling = (
        SCALING_PRIMAL_DUAL
        if layout.allows_primal_dual_scaling
        else SCALING_DUAL
    )
    timed = settings.time_limit != float("inf")
    time_start = time.monotonic() if timed else None

    st = SolverState(
        x=x, s=s, z=z, tau=tau, kappa=kappa,
        px=x, ps=s, pz=z, ptau=tau, pkappa=kappa,
        mu=f(0.0), sigma=f(1.0), step_length=f(0.0),
        iterations=i32(0),
        cost_primal=f(torch.inf), cost_dual=f(-torch.inf),
        res_primal=f(torch.inf), res_dual=f(torch.inf),
        res_primal_inf=f(torch.inf), res_dual_inf=f(torch.inf),
        gap_abs=f(torch.inf), gap_rel=f(torch.inf), ktratio=f(1.0),
        prev_cost_primal=f(torch.inf), prev_cost_dual=f(-torch.inf),
        prev_res_primal=f(torch.inf), prev_res_dual=f(torch.inf),
        prev_gap_abs=f(torch.inf), prev_gap_rel=f(torch.inf),
        dot_qx=f(0.0), dot_bz=f(0.0),
        status=i32(_UNSOLVED),
        scaling=i32(init_scaling),
        ip_pending=i32(0),
        history=torch.full(batch + (settings.max_iter + 1, 9), torch.nan,
                           dtype=dtype, device=device),
    )

    def body(st_in: SolverState):
        # a problem no longer Unsolved at the top of the iteration is frozen
        active = st_in.status == _UNSOLVED
        r = compute_residuals(P, q, A, b, st_in.x, st_in.s, st_in.z, st_in.tau, st_in.kappa)
        mu = calc_mu(layout, r, st_in.tau, st_in.kappa)
        st = update_info(st_in._replace(mu=mu), r, equil, normq, normb)

        # record the progress row for this iterate (info_print.rs per-iter
        # table); α/σ are the values from the step that produced it
        row = torch.stack(
            [
                st.cost_primal, st.cost_dual, st.gap_abs, st.gap_rel,
                st.res_primal, st.res_dual, st.ktratio, mu, st.step_length,
            ],
            dim=-1,
        )
        _write_history_row(st.history, st.iterations, row, active)

        status, ip_pending = check_termination(st, settings, dtype)
        st = st._replace(ip_pending=ip_pending)

        # wall-clock time limit (info.rs:224-226), read on the host
        if timed and (time.monotonic() - time_start) > settings.time_limit:
            status = _status(status == _UNSOLVED, int(SolverStatus.MaxTime), status)

        # user termination callback, checked before the internal statuses
        # win (solver.rs:310-314): one device read of its progress values
        if callback is not None:
            progress = dict(st._asdict(), mu=mu)
            values = host_read(torch.stack([progress[k].to(dtype) for k in CALLBACK_KEYS]))
            snapshot = dict(zip(CALLBACK_KEYS, values))
            snapshot["iterations"] = int(snapshot["iterations"])
            if callback(snapshot):
                status = torch.full_like(status, int(SolverStatus.CallbackTerminated))

        # --- strategy checkpoint: insufficient progress (solver.rs:586-609)
        is_ip = status == int(SolverStatus.InsufficientProgress)
        retry_ip = is_ip & asym & (st.scaling == SCALING_PRIMAL_DUAL)

        restored = dict(
            x=st.px, s=st.ps, z=st.pz, tau=st.ptau, kappa=st.pkappa,
            cost_primal=st.prev_cost_primal, cost_dual=st.prev_cost_dual,
            res_primal=st.prev_res_primal, res_dual=st.prev_res_dual,
            gap_abs=st.prev_gap_abs, gap_rel=st.prev_gap_rel,
        )
        st = st._replace(**{
            k: _select(is_ip, v, getattr(st, k)) for k, v in restored.items()
        })
        status = torch.where(retry_ip, _UNSOLVED, status).to(torch.int32)
        scaling = torch.where(retry_ip, SCALING_DUAL, st.scaling).to(torch.int32)
        st = st._replace(status=status, scaling=scaling)

        # the JAX package's lax.cond(proceed, do_step, ...), per problem;
        # with nonsymmetric cones the same read says whether any problem
        # that steps runs under dual scaling
        proceed = active & (status == _UNSOLVED) & ~retry_ip
        if asym:
            any_step, any_dual = host_read(torch.stack(
                [proceed.any(), (proceed & (scaling == SCALING_DUAL)).any()]))
        else:
            any_step, any_dual = host_read(proceed.any()), False
        if any_step:
            st = _select_state(proceed, _step(st, r, mu, any_dual), st)
        return _select_state(active, st, st_in)

    def _step(st: SolverState, r: Residuals, mu, any_dual):
        # --- cone scaling update (solver.rs:327-338)
        scaling_state, ok_scale = cone_ops.update_scaling(
            layout, cone_ops.set_identity_scaling(layout, dtype, device, batch),
            st.s, st.z, mu, st.scaling,
        )
        # iterations only count successful KKT updates (solver.rs:340-342)
        st = st._replace(iterations=st.iterations + ok_scale.to(torch.int32))

        # --- KKT update + constant-term solve (kktsystem.rs:108-125)
        factors, K, ok_f = _kkt_prepare(
            layout, settings, dtype, n, use_pallas, P, A, scaling_state,
            sparse_kkt=sparse_kkt,
        )
        variables = (st.x, st.s, st.z, st.tau, st.kappa)

        # --- affine step rhs (variables.rs:67-78)
        affine_rhs = (
            r.rx,
            cone_ops.affine_ds(layout, scaling_state, st.s),
            r.rz,
            r.rtau,
            st.tau * st.kappa,
        )
        rhs_const = torch.cat([-q, b], dim=-1)
        rhs_aff, dsc_aff = kkt_solve_rhs(
            layout, scaling_state, affine_rhs, variables, is_combined=False,
        )
        if sparse_kkt is not None or factors[0] == "df_lu":
            # the constant-term and affine reduced solves are independent:
            # they ride one 2-RHS solve, the multifrontal engine's levelized
            # sweeps or the double-float LU's two N-step substitutions
            (j_hi, j_lo), ok_c = solve_kkt_refined(
                factors, K, torch.stack([rhs_const, rhs_aff], dim=-1), settings,
                want_lo=True, keep_ext=True,
            )
            col = lambda v, i: None if v is None else v[..., i]
            sol_c, sol_a = (j_hi[..., 0], col(j_lo, 0)), (j_hi[..., 1], col(j_lo, 1))
            ok_a = ok_c
        else:
            sol_c, ok_c = kkt_dense.solve_refined(factors, K, rhs_const, settings, want_lo=True)
            sol_a, ok_a = kkt_dense.solve_refined(factors, K, rhs_aff, settings, want_lo=True)
        # the constant-term solution with its lo stream, for every finish
        c_hi, c_lo = sol_c
        x2 = (c_hi[..., :n], None if c_lo is None else c_lo[..., :n])
        z2 = (c_hi[..., n:], None if c_lo is None else c_lo[..., n:])
        aff = kkt_solve_finish(
            layout, scaling_state, P, q, A, b, x2, z2, sol_a, dsc_aff,
            affine_rhs, variables, K_true=K,
        )

        alpha_aff = calc_step_length(
            layout, scaling_state, aff, variables, settings,
            is_combined=False, scaling=st.scaling,
        )
        sigma = (1.0 - alpha_aff) ** 3  # solver.rs:543-545
        if dtype == torch.float32:
            # the JAX package's f32 centering floor: Mehrotra's σ can aim
            # at a σμ below both what tol_gap needs and what f32 iterates
            # can represent, and the steps then collapse.  Aim no lower
            # than a quarter of tol_gap_abs/(deg+1), on converging
            # problems only (ktratio < 0.1: an infeasible one diverges to
            # its certificate).  f64 keeps the reference's σ.
            mu_floor = settings.tol_gap_abs / (layout.degree + 1) * 0.25
            sigma_clamped = torch.clamp(
                torch.maximum(sigma, torch.clamp(mu_floor / mu, max=1.0)), max=1.0
            )
            sigma = torch.where(st.ktratio < 0.1, sigma_clamped, sigma)

        # reduced Mehrotra correction on the first iteration
        # (solver.rs:380-382)
        m_corr = torch.where(st.iterations > 1, 1.0, alpha_aff)

        # --- combined step rhs (variables.rs:80-115)
        dx_a, ds_a, dz_a, dtau_a, dkappa_a = aff
        sigma_mu = sigma * mu
        shift = cone_ops.combined_ds_shift(
            layout, scaling_state, _col(m_corr) * dz_a, ds_a, sigma_mu, st.z
        )
        comb_rhs = (
            _col(1.0 - sigma) * r.rx,
            affine_rhs[1] + shift,
            _col(1.0 - sigma) * r.rz,
            (1.0 - sigma) * r.rtau,
            -sigma_mu + m_corr * dtau_a * dkappa_a + st.tau * st.kappa,
        )
        comb, ok_cb = kkt_solve(
            layout, scaling_state, factors, K, P, q, A, b, x2, z2,
            comb_rhs, variables, settings, is_combined=True,
        )

        kkt_ok = ok_scale & ok_f & ok_c & ok_a & ok_cb

        # --- strategy checkpoint: numerical error (solver.rs:611-630)
        retry_ne = (~kkt_ok) & asym & (st.scaling == SCALING_PRIMAL_DUAL)
        fail_ne = (~kkt_ok) & (~retry_ne)
        # scaling failure is always fatal (solver.rs:654-665)
        fail_ne = fail_ne | (~ok_scale)
        retry_ne = retry_ne & ok_scale

        alpha = calc_step_length(
            layout, scaling_state, comb, variables, settings,
            is_combined=True, scaling=st.scaling, any_dual=any_dual,
        )

        if dtype == torch.float32 and layout.num_psd:
            comb, alpha, fail_ne = _centering_recovery(
                layout, settings, scaling_state, factors, K, P, q, A, b, x2, z2, r, mu,
                affine_rhs, variables, st.scaling, any_dual, comb, alpha, alpha_aff,
                fail_ne, retry_ne)

        # direction finiteness: a non-finite direction or step length is a
        # KKT numerical error (reference analog: solver.rs:611-630)
        dir_ok = torch.isfinite(alpha)
        for leaf in comb:
            fin = torch.isfinite(leaf)
            dir_ok = dir_ok & (torch.all(fin, dim=-1) if fin.dim() > alpha.dim() else fin)
        retry_dir = (~dir_ok) & asym & (st.scaling == SCALING_PRIMAL_DUAL)
        fail_ne = fail_ne | ((~dir_ok) & (~retry_dir))
        retry_ne = retry_ne | (retry_dir & ok_scale)

        # --- strategy checkpoint: small step (solver.rs:632-652)
        retry_ss = (
            asym
            & (st.scaling == SCALING_PRIMAL_DUAL)
            & (alpha < settings.min_switch_step_length)
        )
        fail_ss = (~retry_ss) & (
            alpha <= max(0.0, settings.min_terminate_step_length)
        )

        retry = (retry_ne | retry_ss) & (~fail_ne)
        fail = fail_ne | (fail_ss & ~retry)
        take = (~retry) & (~fail)

        status = _status(
            fail_ne,
            int(SolverStatus.NumericalError),
            _status(
                fail_ss & ~retry_ne,
                int(SolverStatus.InsufficientProgress),
                _UNSOLVED,
            ),
        )
        scaling = torch.where(retry, SCALING_DUAL, st.scaling).to(torch.int32)

        dx, ds, dz, dtau, dkappa = comb
        a = torch.where(take, alpha, 0.0)

        # homogeneous renormalization (variables.rs:219-228)
        new_tau = st.tau + a * dtau
        new_kappa = st.kappa + a * dkappa
        invscale = 1.0 / torch.maximum(new_tau, new_kappa)
        keep = lambda new, old: _select(take, new, old)
        return st._replace(
            # save previous iterate before stepping (solver.rs:429-432)
            px=keep(st.x, st.px),
            ps=keep(st.s, st.ps),
            pz=keep(st.z, st.pz),
            ptau=keep(st.tau, st.ptau),
            pkappa=keep(st.kappa, st.pkappa),
            prev_cost_primal=keep(st.cost_primal, st.prev_cost_primal),
            prev_cost_dual=keep(st.cost_dual, st.prev_cost_dual),
            prev_res_primal=keep(st.res_primal, st.prev_res_primal),
            prev_res_dual=keep(st.res_dual, st.prev_res_dual),
            prev_gap_abs=keep(st.gap_abs, st.prev_gap_abs),
            prev_gap_rel=keep(st.gap_rel, st.prev_gap_rel),
            x=(st.x + _col(a) * dx) * _col(invscale),
            s=(st.s + _col(a) * ds) * _col(invscale),
            z=(st.z + _col(a) * dz) * _col(invscale),
            tau=new_tau * invscale,
            kappa=new_kappa * invscale,
            sigma=sigma,
            step_length=a,
            status=status,
            scaling=scaling,
        )

    while host_read((st.status == _UNSOLVED).any()):
        st = body(st)

    # "almost solved" tier on error / iteration-limit exits
    # (info.rs:95-105, 308-337)
    errored = (
        (st.status == int(SolverStatus.NumericalError))
        | (st.status == int(SolverStatus.InsufficientProgress))
        | (st.status == int(SolverStatus.MaxIterations))
        | (st.status == int(SolverStatus.MaxTime))
    )
    reduced_tols = (
        settings.reduced_tol_gap_abs,
        settings.reduced_tol_gap_rel,
        settings.reduced_tol_feas,
        settings.reduced_tol_infeas_abs,
        settings.reduced_tol_infeas_rel,
        settings.reduced_tol_ktratio,
    )
    almost = check_convergence(
        st,
        reduced_tols,
        (
            int(SolverStatus.AlmostSolved),
            int(SolverStatus.AlmostPrimalInfeasible),
            int(SolverStatus.AlmostDualInfeasible),
        ),
    )
    return st._replace(
        status=_status(errored & (almost != _UNSOLVED), almost, st.status)
    )

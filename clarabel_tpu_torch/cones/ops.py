"""Composite-cone operations for the zero, nonnegative, second-order,
exponential, power, generalized power and PSD triangle cones.

PyTorch port of ``clarabel_tpu/cones/ops.py``, without its f32
double-float PSD paths (``mul_hs_df``).
Every operation is a plain function over the full permuted slack vector:
contiguous group slices handle the per-kind math and heterogeneous
second-order cones are vectorized with segment sums, so the same code serves
one cone or thousands.  A segment sum gathers each cone's rows into a padded
[..., cones, widest] tensor and sums its last dimension in a fixed order, so
a solve on the card repeats bit for bit (an ``index_add_`` on CUDA adds in
no fixed order).  Branches are ``torch.where``, as in the JAX package, so
nothing here waits for the device.

Every function takes vectors ``[..., k]`` over any leading batch dimensions
(none for one problem, ``[B]`` for a batch): the cone index is always the
last dimension, and a per-problem scalar has the batch shape itself (0-d
for one problem, ``[B]`` for a batch).

The exponential, power and generalized power cones' branches call into
``cones.nonsymmetric``, the PSD cones' into ``cones.psd``, as the JAX
package's do, and at the same places.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import api
from .layout import ConeLayout

# primal/dual cone selector for margins / unit shifts
PRIMAL = 0
DUAL = 1


def _logsafe(x):
    """log with -inf for nonpositive arguments.

    reference: src/algebra/scalarmath.rs (logsafe)
    """
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), -torch.inf)


def _big(v):
    """The largest finite value of ``v``'s dtype, as a 0-d tensor."""
    return torch.full((), torch.finfo(v.dtype).max, dtype=v.dtype, device=v.device)


def _min_init(v, big):
    """``jnp.min(v, initial=big)`` over the last dimension."""
    if v.shape[-1] == 0:
        return big.expand(v.shape[:-1])
    return torch.minimum(v.amin(dim=-1), big)


def _col(a):
    """A per-problem scalar as a column that broadcasts over ``[..., k]``."""
    return a.unsqueeze(-1)


def _idx(layout: ConeLayout, device):
    return layout.index_tensors(device)


def _has_nonsym(layout: ConeLayout) -> bool:
    return bool(layout.num_exp or layout.num_pow or layout.num_genpow)


# =================================================================
# segment helpers over the SOC group
# =================================================================


def _segment_sum(x, idx, mask):
    """Sum of each padded segment's entries of ``x`` over its last
    dimension, ``x [..., k]`` -> ``[..., segments]``, in a fixed order: on
    the card one reduction over the padded dimension; on the CPU left to
    right, as a sequential scatter-add sums, which keeps the CPU results
    within the parity tests' bounds of the JAX package's."""
    g = torch.where(mask, x[..., idx], 0.0)
    if g.is_cuda:
        return g.sum(dim=-1)
    out = torch.zeros(g.shape[:-1], dtype=g.dtype, device=g.device)
    for j in range(g.shape[-1]):
        out = out + g[..., j]
    return out


def _soc_sum(layout, x):
    ix = _idx(layout, x.device)
    return _segment_sum(x, ix["soc_pad_idx"], ix["soc_pad_mask"])


def _heads(layout, x):
    return x[..., _idx(layout, x.device)["soc_head_idx"]]


def _tail(layout, x):
    """Zero out the leading (t) component of each cone."""
    return torch.where(_idx(layout, x.device)["soc_head_mask"], 0.0, x)


def _set_heads(layout, x, head):
    """x with each cone's leading component replaced by ``head``."""
    ix = _idx(layout, x.device)
    return torch.where(ix["soc_head_mask"], head[..., ix["soc_seg"]], x)


def _soc_residual(layout, x):
    """Per-cone residual (x0 - ||x1||)(x0 + ||x1||).

    reference: src/solver/core/cones/socone.rs:388-394
    """
    x0 = _heads(layout, x)
    n1 = torch.sqrt(_soc_sum(layout, _tail(layout, x) ** 2))
    return (x0 - n1) * (x0 + n1)


def _soc_circ(layout, y, z):
    """Jordan product y ∘ z for the SOC algebra.

    reference: src/solver/core/cones/socone.rs:360-367
    """
    seg = _idx(layout, y.device)["soc_seg"]
    y0 = _heads(layout, y)
    z0 = _heads(layout, z)
    head = _soc_sum(layout, y * z)
    out = y0[..., seg] * _tail(layout, z) + z0[..., seg] * _tail(layout, y)
    return _set_heads(layout, out, head)


def _soc_mul_w(layout, w, eta, x, inverse: bool):
    """Products with the NT scaling point W (ECOS-style fast form).

    reference: src/solver/core/cones/socone.rs:503-530
    """
    seg = _idx(layout, x.device)["soc_seg"]
    w0 = _heads(layout, w)
    x0 = _heads(layout, x)
    zeta = _soc_sum(layout, _tail(layout, w) * _tail(layout, x))
    if not inverse:
        c = x0 + zeta / (1.0 + w0)
        head = eta * (w0 * x0 + zeta)
        tail = (eta[..., seg]) * (_tail(layout, x) + c[..., seg] * _tail(layout, w))
    else:
        c = -x0 + zeta / (1.0 + w0)
        head = (w0 * x0 - zeta) / eta
        tail = (_tail(layout, x) + c[..., seg] * _tail(layout, w)) / eta[..., seg]
    return _set_heads(layout, tail, head)


# =================================================================
# composite cone interface
# =================================================================


def unit_initialization(layout: ConeLayout, dtype, device, batch=()):
    """(z, s) unit initial point per cone, for each problem of the batch
    shape ``batch``.

    reference: per-cone ``unit_initialization`` (zerocone.rs:72-75,
    nonnegativecone.rs:68-71, socone.rs:114-119)
    """
    z = torch.zeros(tuple(batch) + (layout.m,), dtype=dtype, device=device)
    nn = layout.slice_of(api.NONNEGATIVE)
    z[..., nn] = 1.0
    if layout.num_soc:
        z[..., _idx(layout, device)["soc_head_idx"] + layout.slice_of(api.SOC).start] = 1.0
    s = z.clone()
    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        z, s = _ns.unit_initialization(layout, z, s)
    if layout.num_psd:
        from . import psd as _psd

        z, s = _psd.unit_initialization(layout, z, s)
    return z, s


def set_identity_scaling(layout: ConeLayout, dtype, device, batch=()):
    """Identity NT scalings for the symmetric initial KKT solve, for each
    problem of the batch shape ``batch``.

    reference: per-cone ``set_identity_scaling`` (nonnegativecone.rs:73-75,
    socone.rs:121-132)
    """
    kw = dict(dtype=dtype, device=device)
    shape = lambda k: tuple(batch) + (k,)
    state = {}
    if layout.n_nn:
        state["nn_w"] = torch.ones(shape(layout.n_nn), **kw)
        state["nn_lam"] = torch.zeros(shape(layout.n_nn), **kw)
    if layout.num_soc:
        w = torch.zeros(shape(layout.m_soc), **kw)
        w[..., _idx(layout, device)["soc_head_idx"]] = 1.0
        state["soc_w"] = w
        state["soc_eta"] = torch.ones(shape(layout.num_soc), **kw)
        state["soc_lam"] = torch.zeros(shape(layout.m_soc), **kw)
    if layout.num_psd:
        from . import psd as _psd

        state.update(_psd.set_identity_scaling(layout, dtype, device, batch))
    # nonsymmetric cones never take the symmetric initialization path
    return state


def update_scaling(layout: ConeLayout, state, s, z, mu, strategy):
    """Update all scaling-point data from the current (s, z).

    Returns (new_state, ok) with ``ok`` a bool per problem.  reference:
    compositecone.rs:226-243 and the per-cone ``update_scaling`` impls.
    ``mu`` and ``strategy`` (per problem) only matter to the nonsymmetric
    cones.
    """
    state = dict(state)
    ok = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        si, zi = s[..., sl], z[..., sl]
        # reference: nonnegativecone.rs:77-90
        state["nn_lam"] = torch.sqrt(si * zi)
        state["nn_w"] = torch.sqrt(si / zi)

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        si, zi = s[..., sl], z[..., sl]
        ix = _idx(layout, s.device)
        seg = ix["soc_seg"]
        # reference: socone.rs:134-211
        zres = _soc_residual(layout, zi)
        sres = _soc_residual(layout, si)
        ok = ok & torch.all(zres > 0, dim=-1) & torch.all(sres > 0, dim=-1)
        zscale = torch.sqrt(torch.clamp(zres, min=1e-300))
        sscale = torch.sqrt(torch.clamp(sres, min=1e-300))

        eta = torch.sqrt(sscale / zscale)

        sgn = torch.where(ix["soc_head_mask"], 1.0, -1.0).to(s.dtype)
        w = si / sscale[..., seg] + sgn * zi / zscale[..., seg]
        wres = _soc_residual(layout, w)
        ok = ok & torch.all(wres > 0, dim=-1)
        wscale = torch.sqrt(torch.clamp(wres, min=1e-300))
        w = w / wscale[..., seg]

        # force w to come out normalized (socone.rs:170-172)
        w1sq = _soc_sum(layout, _tail(layout, w) ** 2)
        w = _set_heads(layout, w, torch.sqrt(1.0 + w1sq))

        # scaled point λ satisfying λ = Wz = W^{-T}s (socone.rs:174-184)
        gamma = 0.5 * wscale
        z0, s0 = _heads(layout, zi), _heads(layout, si)
        cs = (gamma + z0 / zscale) / sscale
        cz = (gamma + s0 / sscale) / zscale
        den = s0 / sscale + z0 / zscale + 2.0 * gamma
        lam = (cs[..., seg] * _tail(layout, si) + cz[..., seg] * _tail(layout, zi)) / den[..., seg]
        lam = _set_heads(layout, lam, gamma)
        lam = lam * torch.sqrt(sscale * zscale)[..., seg]

        state["soc_w"] = w
        state["soc_eta"] = eta
        state["soc_lam"] = lam

    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        state, ok_ns = _ns.update_scaling(layout, state, s, z, mu, strategy)
        ok = ok & ok_ns

    if layout.num_psd:
        from . import psd as _psd

        state, ok_psd = _psd.update_scaling(layout, state, s, z)
        ok = ok & ok_psd

    return state, ok


def hs_dense(layout: ConeLayout, state, dtype, device, batch=(), want_lo=False):
    """Dense [..., m, m] block-diagonal scaling matrices Hs = WᵀW for KKT
    assembly (zero cones contribute zero rows), one per problem of the
    batch shape ``batch``.  reference: per-cone ``get_Hs``.

    With ``want_lo`` returns (H, H_lo): on f32 PSD layouts H_lo holds the
    PSD blocks' double-float rounding remainder (and the blocks are stashed
    in ``state``, ``psd.hs_dense``), else it is None."""
    H = torch.zeros(tuple(batch) + (layout.m, layout.m), dtype=dtype, device=device)
    H_lo = (torch.zeros_like(H)
            if want_lo and layout.num_psd and dtype == torch.float32 else None)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        idx = torch.arange(sl.start, sl.stop, device=device)
        # reference: nonnegativecone.rs:96-101 (diag Hs = w²)
        H[..., idx, idx] = state["nn_w"] ** 2

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        ix = _idx(layout, device)
        seg = ix["soc_seg"]
        w, eta = state["soc_w"], state["soc_eta"]
        # dense form Hs = η²(2wwᵀ - J), J = diag(1, -I)
        # (reference: socone.rs:227-245)
        u = eta[..., seg] * w
        same = seg[:, None] == seg[None, :]
        blk = 2.0 * torch.where(same, u[..., :, None] * u[..., None, :], 0.0)
        diag = torch.where(ix["soc_head_mask"], -(eta[..., seg] ** 2), eta[..., seg] ** 2)
        blk = blk + torch.diag_embed(diag)
        H[..., sl, sl] = blk

    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        H = _ns.hs_dense(layout, state, H)

    if layout.num_psd:
        from . import psd as _psd

        H, H_lo = _psd.hs_dense(layout, state, H, H_lo)

    return (H, H_lo) if want_lo else H


def hs_diag(layout: ConeLayout, state, dtype, device, batch=()):
    """diag(Hs) [..., m] for diagonal-Hs layouts (zero/NN cones only) --
    the structured Schur path needs no other Hs data.  reference:
    nonnegativecone.rs:96-101 (diag Hs = w²), zerocone.rs (Hs = 0)."""
    h = torch.zeros(tuple(batch) + (layout.m,), dtype=dtype, device=device)
    if layout.n_nn:
        h[..., layout.slice_of(api.NONNEGATIVE)] = state["nn_w"] ** 2
    return h


def hs_diag_lowrank(layout: ConeLayout, state, dtype, device, batch=()):
    """Diagonal plus per-SOC rank-1 form of Hs for the Woodbury Schur path
    (zero/NN/SOC layouts): ``(h [..., m], U [..., m, k])`` with
    Hs = diag(h) + U Uᵀ exactly, k = ``layout.num_soc``.

    Each SOC's NT block WᵀW = η²(2wwᵀ − J) (socone.rs:227-245) is the signed
    diagonal η²·(−1, +1, …, +1) plus (√2ηw)(√2ηw)ᵀ: U's column c is √2·η_c·w_c
    on cone c's rows and zero elsewhere.  Each cone's Woodbury capacitance
    1 + cᵀD⁻¹c = −1 analytically (w is normalized), so the correction is
    perfectly conditioned.
    """
    h = hs_diag(layout, state, dtype, device, batch)
    k = layout.num_soc
    U = torch.zeros(tuple(batch) + (layout.m, k), dtype=dtype, device=device)
    if k:
        sl = layout.slice_of(api.SOC)
        ix = _idx(layout, device)
        seg = ix["soc_seg"]
        w, eta = state["soc_w"], state["soc_eta"]
        eta2 = (eta**2)[..., seg]
        h[..., sl] = torch.where(ix["soc_head_mask"], -eta2, eta2)
        rows = torch.arange(sl.start, sl.stop, device=device)
        U[..., rows, seg] = math.sqrt(2.0) * eta[..., seg] * w
    return h, U


def mul_hs(layout: ConeLayout, state, x, psd=True):
    """y = Hs x without materializing Hs.  reference: per-cone ``mul_Hs``.
    ``psd=False`` leaves the PSD rows of y zero."""
    y = torch.zeros_like(x)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        y[..., sl] = state["nn_w"] ** 2 * x[..., sl]

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        xi = x[..., sl]
        ix = _idx(layout, x.device)
        seg = ix["soc_seg"]
        w, eta = state["soc_w"], state["soc_eta"]
        # reference: socone.rs:248-256
        c = 2.0 * _soc_sum(layout, w * xi)
        out = torch.where(ix["soc_head_mask"], -xi, xi) + c[..., seg] * w
        y[..., sl] = eta[..., seg] ** 2 * out

    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        y = _ns.mul_hs(layout, state, x, y)

    if layout.num_psd and psd:
        from . import psd as _psd

        y = _psd.mul_hs(layout, state, x, y)

    return y


def mul_hs_df(layout: ConeLayout, state, x, x_lo=None):
    """y = Hs (x + x_lo) as a double-float (hi, lo) pair, x [..., m].

    Near convergence |Hs·x|_i dwarfs the Δs it feeds (Δs = -(HsΔz + c) is
    a cancellation), so the f32 rounding of the product dominates the step's
    primal consistency; keeping the product's rounding remainder in a lo
    stream until after the cancellation removes it.  NN takes an exact
    TwoProd; SOC, exp, pow and genpow the plain product (their hi image)
    with only the x_lo image compensated; a PSD bucket applies the skron
    blocks ``hs_dense`` stashed for the solved K with a compensated matvec,
    else (no stash) the double-float congruence of n ≤ 32 buckets, else the
    plain product, as in the JAX package (clarabel_tpu/cones/ops.py:
    313-401)."""
    from ..kkt import compensated as dfc

    hi = torch.zeros_like(x)
    lo = torch.zeros_like(x)
    xr, xr_lo = x, x_lo
    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        w2 = state["nn_w"] ** 2
        ph, pe = dfc._two_prod(w2, x[..., sl])
        if x_lo is not None:
            pe = pe + w2 * x_lo[..., sl]
        hi[..., sl] = ph
        lo[..., sl] = pe
        # the NN slice zeroed, so the generic product below does not add it again
        xr = x.clone()
        xr[..., sl] = 0.0
        if x_lo is not None:
            xr_lo = x_lo.clone()
            xr_lo[..., sl] = 0.0

    if layout.num_soc or _has_nonsym(layout):
        hi = hi + mul_hs(layout, state, xr, psd=False)
        if xr_lo is not None:
            lo = lo + mul_hs(layout, state, xr_lo, psd=False)

    if layout.num_psd:
        from . import psd as _psd

        sl = layout.slice_of(api.PSD)
        parts_h, parts_l = [], []
        for bi, b, t in _psd._buckets(layout, x):
            R = state[f"psd{bi}_R"]
            xv = _psd._gather(layout, t, x)
            xlv = None if x_lo is None else _psd._gather(layout, t, x_lo)
            if f"psd{bi}_skron" in state:
                # the blocks of the solved K, by a compensated matvec
                Sh, Sl = state[f"psd{bi}_skron"]
                p, e = dfc._two_prod(Sh, xv.unsqueeze(-2))
                e = e + Sl * xv.unsqueeze(-2)
                if xlv is not None:
                    e = e + Sh * xlv.unsqueeze(-2)
                vh, vl = dfc._df_reduce_last(p, e)
            elif _psd._use_df(b, x.dtype):
                Yh, Yl = _psd._df_axa(R, *_psd._to_mat_df(b, t, xv, xlv))
                vh, vl = _psd._to_svec_df(b, t, Yh, Yl)
            else:
                A = R @ R.mT
                vh = _psd._to_svec(t, A @ _psd._to_mat(t, xv) @ A.mT)
                vl = (torch.zeros_like(vh) if xlv is None
                      else _psd._to_svec(t, A @ _psd._to_mat(t, xlv) @ A.mT))
            parts_h.append((t, vh))
            parts_l.append((t, vl))
        hi[..., sl] = hi[..., sl] + _psd._scatter(layout, parts_h, x)
        lo[..., sl] = lo[..., sl] + _psd._scatter(layout, parts_l, x)
    return hi, lo


def affine_ds(layout: ConeLayout, state, s):
    """RHS ds for the affine step: λ∘λ for symmetric cones, s for
    nonsymmetric ones.  reference: per-cone ``affine_ds``."""
    ds = torch.zeros_like(s)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        ds[..., sl] = state["nn_lam"] ** 2

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        lam = state["soc_lam"]
        ds[..., sl] = _soc_circ(layout, lam, lam)

    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        ds = _ns.affine_ds(layout, ds, s)

    if layout.num_psd:
        from . import psd as _psd

        ds = _psd.affine_ds(layout, state, ds)

    return ds


def combined_ds_shift(layout: ConeLayout, state, step_z, step_s, sigma_mu, z):
    """Mehrotra shift term for the combined step RHS.

    Symmetric cones: W⁻¹Δs ∘ WΔz − σμe  (reference:
    symmetric_common.rs:53-84).  Nonsymmetric cones: σμ·g(z) plus the
    third-order correction (reference: expcone.rs:131-151).  ``sigma_mu``
    is a per-problem scalar.
    """
    shift = torch.zeros_like(step_z)
    sm = _col(sigma_mu)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        w = state["nn_w"]
        wz = w * step_z[..., sl]
        wis = step_s[..., sl] / w
        shift[..., sl] = wis * wz - sm

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        w, eta = state["soc_w"], state["soc_eta"]
        wz = _soc_mul_w(layout, w, eta, step_z[..., sl], inverse=False)
        wis = _soc_mul_w(layout, w, eta, step_s[..., sl], inverse=True)
        out = _soc_circ(layout, wis, wz)
        head_mask = _idx(layout, step_z.device)["soc_head_mask"]
        shift[..., sl] = torch.where(head_mask, out - sm, out)

    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        shift = _ns.combined_ds_shift(layout, state, shift, step_z, step_s, sigma_mu, z)

    if layout.num_psd:
        from . import psd as _psd

        shift = _psd.combined_ds_shift(layout, state, shift, step_z, step_s, sigma_mu)

    return shift


def ds_from_dz_offset(layout: ConeLayout, state, ds, z):
    """Constant part of Δs as a function of Δz: Wᵀ(λ \\ ds) for symmetric
    cones, ds itself for nonsymmetric ones.  reference: per-cone
    ``Δs_from_Δz_offset``."""
    out = torch.zeros_like(ds)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        # reference: nonnegativecone.rs:122-126 (out = ds / z)
        out[..., sl] = ds[..., sl] / z[..., sl]

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        dsi, zi = ds[..., sl], z[..., sl]
        ix = _idx(layout, ds.device)
        seg, head_mask = ix["soc_seg"], ix["soc_head_mask"]
        w, eta, lam = state["soc_w"], state["soc_eta"], state["soc_lam"]
        # reference: socone.rs:266-287 (stabilized Wᵀ(λ \ ds))
        resz = _soc_residual(layout, zi)
        lam0, ds0 = _heads(layout, lam), _heads(layout, dsi)
        w0 = _heads(layout, w)
        lam1ds1 = _soc_sum(layout, _tail(layout, lam) * _tail(layout, dsi))
        w1ds1 = _soc_sum(layout, _tail(layout, w) * _tail(layout, dsi))

        v = torch.where(head_mask, zi, -zi)
        c = lam0 * ds0 - lam1ds1
        v = v * (c / resz)[..., seg]
        v = torch.where(head_mask, v + (eta * w1ds1)[..., seg], v)
        tail_add = eta[..., seg] * (
            _tail(layout, dsi) + (w1ds1 / (1.0 + w0))[..., seg] * _tail(layout, w)
        )
        v = v + _tail(layout, tail_add)
        v = v / lam0[..., seg]
        out[..., sl] = v

    # nonsymmetric cones pass ds through unchanged (expcone.rs:149-151,
    # powcone.rs:142-144, genpowcone.rs:215-217); zero cones contribute zero
    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        for sl in _ns._present_slices(layout):
            out[..., sl] = ds[..., sl]

    if layout.num_psd:
        from . import psd as _psd

        out = _psd.ds_from_dz_offset(layout, state, out, ds)

    return out


# -----------------------------------------------------------------
# step length
# -----------------------------------------------------------------


def _nn_step_component(x, dx, big):
    """max α with x + α dx >= 0 (reference: nonnegativecone.rs:128-153)."""
    ratios = torch.where(dx < 0, -x / torch.where(dx < 0, dx, -1.0), big)
    return _min_init(ratios, big)


def _soc_step_component(layout, x, dx, big):
    """max α keeping each SOC slice inside its cone: minimum positive root
    of the boundary quadratic, with cancellation-safe root selection.

    reference: socone.rs:421-495
    """
    x0 = _heads(layout, x)
    y0 = _heads(layout, dx)

    # scalar-part bound
    a_lin = torch.where(
        (x0 >= 0) & (y0 < 0), -x0 / torch.where(y0 < 0, y0, -1.0), big
    )

    a = _soc_residual(layout, dx)
    b = 2.0 * (x0 * y0 - _soc_sum(layout, _tail(layout, x) * _tail(layout, dx)))
    c = torch.clamp(_soc_residual(layout, x), min=0.0)
    d = b * b - 4.0 * a * c

    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    t = torch.where(b >= 0, -b - sqrt_d, -b + sqrt_d)
    safe_t = torch.where(t == 0, 1.0, t)
    safe_a = torch.where(a == 0, 1.0, a)
    r1 = (2.0 * c) / safe_t
    r2 = t / (2.0 * safe_a)
    r1 = torch.where((r1 < 0) | (t == 0), big, r1)
    r2 = torch.where((r2 < 0) | (a == 0), big, r2)
    root = torch.minimum(r1, r2)

    a_quad = torch.where(
        ((a > 0) & (b > 0)) | (d < 0),
        big,
        torch.where(
            a == 0,
            big,
            torch.where(c == 0, torch.where(a >= 0, big, 0.0), root),
        ),
    )
    per_cone = torch.minimum(a_lin, a_quad)
    return _min_init(per_cone, big)


def step_length(layout: ConeLayout, state, dz, ds, z, s, settings, alpha_max):
    """Composite maximum step length to the cone boundary, per problem.

    Symmetric cones first (closed form); nonsymmetric cones then shrink the
    result further, after backing off from 1 by √ε.
    reference: compositecone.rs:300-340
    """
    big = _big(z)
    alpha = alpha_max

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        alpha = torch.minimum(alpha, _nn_step_component(z[..., sl], dz[..., sl], big))
        alpha = torch.minimum(alpha, _nn_step_component(s[..., sl], ds[..., sl], big))

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        alpha = torch.minimum(alpha, _soc_step_component(layout, z[..., sl], dz[..., sl], big))
        alpha = torch.minimum(alpha, _soc_step_component(layout, s[..., sl], ds[..., sl], big))

    if layout.num_psd:
        from . import psd as _psd

        alpha = _psd.step_length(layout, state, dz, ds, z, s, alpha, big)

    if not layout.is_symmetric:
        from . import nonsymmetric as _ns

        eps = torch.finfo(z.dtype).eps
        alpha = torch.clamp(alpha, max=1.0 - math.sqrt(eps))
        alpha = _ns.step_length(layout, state, dz, ds, z, s, settings, alpha)

    return alpha


def compute_barrier(layout: ConeLayout, state, z, s, dz, ds, alpha):
    """Combined barrier at (z+αdz, s+αds).  reference: per-cone
    ``compute_barrier``, per problem; used by the asymmetric backtracking
    line search.  ``alpha`` may carry one more trailing dimension than the
    problems' batch shape (candidate step lengths), when (z, s, dz, ds)
    carry a matching dimension of size 1 before their last."""
    del state
    barrier = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    a = _col(alpha)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        si = s[..., sl] + a * ds[..., sl]
        zi = z[..., sl] + a * dz[..., sl]
        barrier = barrier - torch.sum(_logsafe(si * zi), dim=-1)

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        res_s = _soc_residual(layout, s[..., sl] + a * ds[..., sl])
        res_z = _soc_residual(layout, z[..., sl] + a * dz[..., sl])
        good = (res_s > 0) & (res_z > 0)
        term = torch.where(good, -0.5 * _logsafe(res_s * res_z), torch.inf)
        barrier = barrier + torch.sum(term, dim=-1)

    if _has_nonsym(layout):
        from . import nonsymmetric as _ns

        barrier = barrier + _ns.compute_barrier(layout, z, s, dz, ds, a)

    if layout.num_psd:
        from . import psd as _psd

        barrier = barrier + _psd.compute_barrier(layout, z, s, dz, ds, a)

    return barrier


# -----------------------------------------------------------------
# margins and unit shifts (symmetric initialization)
# -----------------------------------------------------------------


def margins(layout: ConeLayout, z, pd):
    """(minimum margin, total positive margin) over all cones, per problem.

    reference: compositecone margins + per-cone impls (zerocone.rs:55-62,
    nonnegativecone.rs:58-62, socone.rs:104-108)
    """
    del pd
    big = _big(z)
    mn = big.expand(z.shape[:-1])
    total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        zi = z[..., sl]
        mn = torch.minimum(mn, _min_init(zi, big))
        total = total + torch.sum(torch.clamp(zi, min=0.0), dim=-1)

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        zi = z[..., sl]
        z0 = _heads(layout, zi)
        n1 = torch.sqrt(_soc_sum(layout, _tail(layout, zi) ** 2))
        a = z0 - n1
        mn = torch.minimum(mn, _min_init(a, big))
        total = total + torch.sum(torch.clamp(a, min=0.0), dim=-1)

    if layout.num_psd:
        from . import psd as _psd

        mn, total = _psd.margins(layout, z, mn, total)

    # zero cones: (+inf, 0) contribution — no-op on (mn, total)
    return mn, total


def scaled_unit_shift(layout: ConeLayout, z, alpha, pd):
    """z += α·e per cone, α a per-problem scalar; zero cones clamp to 0 in
    the primal case.

    reference: per-cone ``scaled_unit_shift`` (zerocone.rs:64-70,
    nonnegativecone.rs:64-66, socone.rs:110-112)
    """
    z = z.clone()
    alpha = _col(alpha)
    if layout.n_zero and pd == PRIMAL:
        z[..., layout.slice_of(api.ZERO)] = 0.0

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        z[..., sl] = z[..., sl] + alpha

    if layout.num_soc:
        sl = layout.slice_of(api.SOC)
        heads = _idx(layout, z.device)["soc_head_idx"] + sl.start
        z[..., heads] = z[..., heads] + alpha

    if layout.num_psd:
        from . import psd as _psd

        z = _psd.scaled_unit_shift(layout, z, alpha)

    return z


def rectify_equilibration(layout: ConeLayout, e):
    """Replace per-row scalings by their per-cone mean on cones that only
    admit a scalar scaling (everything except zero/NN cones).

    reference: per-cone ``rectify_equilibration`` (socone.rs:97-101:
    δ = mean(e)/e, so e ⊙ δ = mean(e) on the cone).
    Returns (δ, changed) where changed is a host bool.
    """
    if not layout.rectify_mask.any():
        return torch.ones_like(e), False
    ix = _idx(layout, e.device)
    mean = _segment_sum(e, ix["rect_pad_idx"], ix["rect_pad_mask"]) / ix["rect_dims"]
    delta = torch.where(ix["rectify_mask"], mean[..., ix["rect_seg"]] / e, 1.0)
    return delta, True


# =================================================================
# sparse Hs: lower-triangle block coordinates + values
# =================================================================
#
# The sparse KKT engine (kkt/sparse.py) needs the block-diagonal Hs as a
# flat vector of lower-triangle entries in a canonical order (the analog of
# the reference's per-cone Hsblocks maps; reference: src/solver/core/
# kktsolvers/direct/quasidef/datamaps.rs + per-cone ``get_Hs``).
# ``hs_lower_coords`` runs on the host at setup and fixes the order;
# ``hs_lower_vals`` produces the values in exactly that order.
#
# Canonical order: [ NN diag | SOC cone-major tril | exp cone-major 3x3
# tril | pow ditto | genpow cone-major tril | PSD bucket/cone-major tril ].
# Zero cones contribute no Hs entries (their K diagonal comes from the
# separate diagonal group of the sparse pattern).


def hs_lower_coords(layout: ConeLayout, soc_expanded=(), genpow_expanded=False):
    """Host-side: global (rows, cols) in [0, m) of every Hs lower-triangle
    entry, row >= col, in the canonical order of :func:`hs_lower_vals`.

    ``soc_expanded`` (bool per SOC cone) and ``genpow_expanded`` select
    the sparse low-rank expansion form for those cones: their Hs block
    degenerates to a diagonal here, with the rank-2/rank-3 terms carried
    by the extension rows of :func:`expansion_coords` (reference:
    socone.rs:217-226 sparse get_Hs, genpowcone.rs:165-176)."""
    rows, cols = [], []

    if layout.n_nn:
        sl = layout.slice_of(api.NONNEGATIVE)
        i = np.arange(sl.start, sl.stop, dtype=np.int64)
        rows.append(i)
        cols.append(i)

    if layout.num_soc:
        off = layout.slice_of(api.SOC).start
        if not soc_expanded:
            soc_expanded = (False,) * layout.num_soc
        # dense cones first (cone-major tril), then expanded cones' diags
        pos = 0
        for ci, d in enumerate(layout.soc_dims):
            if not soc_expanded[ci]:
                ti, tj = np.tril_indices(d)
                rows.append(off + pos + ti)
                cols.append(off + pos + tj)
            pos += d
        pos = 0
        for ci, d in enumerate(layout.soc_dims):
            if soc_expanded[ci]:
                i = off + pos + np.arange(d, dtype=np.int64)
                rows.append(i)
                cols.append(i)
            pos += d

    for kind, count in ((api.EXP, layout.num_exp), (api.POW, layout.num_pow)):
        if count:
            off = layout.slice_of(kind).start
            ti, tj = np.tril_indices(3)
            for k in range(count):
                rows.append(off + 3 * k + ti)
                cols.append(off + 3 * k + tj)

    if layout.num_genpow:
        off = layout.slice_of(api.GENPOW).start
        if genpow_expanded:
            i = off + np.arange(layout.m_genpow, dtype=np.int64)
            rows.append(i)
            cols.append(i)
        else:
            pos = 0
            for c in layout.genpow_cones:
                w = c.nvars
                ti, tj = np.tril_indices(w)
                rows.append(off + pos + ti)
                cols.append(off + pos + tj)
                pos += w

    if layout.num_psd:
        off = layout.slice_of(api.PSD).start
        for b in layout.psd_buckets:
            ti, tj = np.tril_indices(b.tri)
            for ki in range(b.count):
                rows.append(off + b.gather[ki, ti])
                cols.append(off + b.gather[ki, tj])

    if not rows:
        z = np.zeros(0, np.int64)
        return z, z
    return (
        np.concatenate(rows).astype(np.int64),
        np.concatenate(cols).astype(np.int64),
    )


def _flat(v, batch):
    """``v [..., a, b, ...]`` as ``[..., a·b·...]`` over the batch shape."""
    return v.reshape(tuple(batch) + (-1,))


def hs_lower_vals(layout: ConeLayout, state, dtype, device, batch=(),
                  soc_expanded=(), genpow_expanded=False):
    """Hs lower-triangle entry values ``[..., entries]`` in the canonical
    order of :func:`hs_lower_coords`, one row per problem of the batch
    shape ``batch``.  Every gather index is a static host array."""
    parts = []
    ix = _idx(layout, device)

    if layout.n_nn:
        parts.append(state["nn_w"] ** 2)

    if layout.num_soc:
        if not soc_expanded:
            soc_expanded = (False,) * layout.num_soc
        exp_mask = np.asarray(soc_expanded, bool)
        w, eta = state["soc_w"], state["soc_eta"]
        seg_all = ix["soc_seg"]
        # dense form Hs = eta^2 (2wwT - J) per cone (socone.rs:227-245);
        # entry (i, j): 2 u_i u_j + [i == j] * (head ? -eta^2 : +eta^2)
        gi_l, gj_l = [], []
        pos = 0
        for ci, d in enumerate(layout.soc_dims):
            if not soc_expanded[ci]:
                ti, tj = np.tril_indices(d)
                gi_l.append(pos + ti)
                gj_l.append(pos + tj)
            pos += d
        if gi_l:
            gi = np.concatenate(gi_l)
            gj = np.concatenate(gj_l)
            as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
            seg = as_long(layout.soc_seg[gi])
            u = eta[..., seg_all] * w
            eta2 = (eta**2)[..., seg]
            head = torch.as_tensor(layout.soc_head_mask[gi], device=device)
            diag_term = torch.where(head, -eta2, eta2)
            on_diag = torch.as_tensor(gi == gj, device=device)
            ti_, tj_ = as_long(gi), as_long(gj)
            parts.append(2.0 * u[..., ti_] * u[..., tj_] + torch.where(on_diag, diag_term, 0.0))
        if exp_mask.any():
            # sparse form: diagonal eta^2 * [d, 1, ..., 1] per cone with
            # d = 1/(2 w'w) (socone.rs:190-199, 217-226)
            sel = torch.as_tensor(np.where(exp_mask[layout.soc_seg])[0], device=device)
            w1sq = _soc_sum(layout, _tail(layout, w) ** 2)
            w0 = _heads(layout, w)
            dd = 0.5 / (w0**2 + w1sq)
            dvals = torch.where(ix["soc_head_mask"], dd[..., seg_all], 1.0) * (eta**2)[..., seg_all]
            parts.append(dvals[..., sel])

    for key, count in (("exp_hs", layout.num_exp), ("pow_hs", layout.num_pow)):
        if count:
            ti, tj = np.tril_indices(3)
            parts.append(_flat(state[key][..., ti, tj], batch))

    if layout.num_genpow:
        # Hs = mu (D + pp' - qq' - rr') (genpowcone.rs:360-401)
        seg = ix["genpow_seg"]
        diagvec = torch.where(ix["genpow_is_q"], state["gp_d2"][..., seg], state["gp_d1"])
        mu = _col(state["gp_mu"])
        if genpow_expanded:
            # sparse form keeps only mu*D here (genpowcone.rs:169-176);
            # the rank-3 terms ride the extension rows
            parts.append(mu * diagvec)
        else:
            gi_l, gj_l = [], []
            pos = 0
            for c in layout.genpow_cones:
                ti, tj = np.tril_indices(c.nvars)
                gi_l.append(pos + ti)
                gj_l.append(pos + tj)
                pos += c.nvars
            gi = np.concatenate(gi_l)
            gj = np.concatenate(gj_l)
            on_diag = torch.as_tensor(gi == gj, device=device)
            gi = torch.as_tensor(gi, dtype=torch.long, device=device)
            gj = torch.as_tensor(gj, dtype=torch.long, device=device)
            p, qv, rv = state["gp_p"], state["gp_q"], state["gp_r"]
            vals = (
                p[..., gi] * p[..., gj]
                - qv[..., gi] * qv[..., gj]
                - rv[..., gi] * rv[..., gj]
                + torch.where(on_diag, diagvec[..., gi], 0.0)
            )
            parts.append(mu * vals)

    if layout.num_psd:
        from . import psd as _psd

        tensors = layout.psd_tensors(dtype, device)
        for bi, b in enumerate(layout.psd_buckets):
            if not b.n:
                continue
            R = state[f"psd{bi}_R"]
            blocks = _psd._skron(tensors[bi], R @ R.mT)  # [..., k, tri, tri]
            ti, tj = np.tril_indices(b.tri)
            parts.append(_flat(blocks[..., ti, tj], batch))

    if not parts:
        return torch.zeros(tuple(batch) + (0,), dtype=dtype, device=device)
    return torch.cat([p.to(dtype) for p in parts], dim=-1)


def expansion_coords(layout: ConeLayout, soc_expanded=(), genpow_expanded=False):
    """Host-side: lower-triangle coordinates of the sparse-cone expansion
    terms, in the [0, m + pdim) row space (the caller offsets by n for K
    coordinates).  Returns (rows, cols, ext_dsigns).

    Canonical order (must match :func:`expansion_vals`):
      [ SOC v entries | SOC u entries | SOC ext diags (-+ per cone) |
        genpow q | genpow r | genpow p | genpow ext diags (--+ per cone) ]

    reference: datamaps.rs:112-221 (SOC: v column first, u column second,
    D = eta^2*(-1, 1)); :226-343 (genpow: q/r/p columns scaled -sqrt(mu),
    D = (-1, -1, 1)).
    """
    rows, cols, signs = [], [], []
    ext = layout.m  # next extension row index

    soc_ext_pairs = []  # (ext_v, ext_u) per expanded cone
    if layout.num_soc and soc_expanded and any(soc_expanded):
        off = layout.slice_of(api.SOC).start
        pos = 0
        for ci, d in enumerate(layout.soc_dims):
            if soc_expanded[ci]:
                soc_ext_pairs.append((ext, ext + 1, off + pos, d))
                ext += 2
            pos += d
        for ev, eu, r0, d in soc_ext_pairs:  # v entries
            rows.append(np.full(d, ev, np.int64))
            cols.append(r0 + np.arange(d, dtype=np.int64))
        for ev, eu, r0, d in soc_ext_pairs:  # u entries
            rows.append(np.full(d, eu, np.int64))
            cols.append(r0 + np.arange(d, dtype=np.int64))
        for ev, eu, r0, d in soc_ext_pairs:  # ext diagonal
            rows.append(np.asarray([ev, eu], np.int64))
            cols.append(np.asarray([ev, eu], np.int64))
        signs += [-1.0, 1.0] * len(soc_ext_pairs)

    if genpow_expanded and layout.num_genpow:
        off = layout.slice_of(api.GENPOW).start
        gp_ext = []  # (ext_q, ext_r, ext_p, row0, dim1, dim2)
        pos = 0
        for c in layout.genpow_cones:
            d1, d2 = len(c.alpha), c.dim2
            gp_ext.append((ext, ext + 1, ext + 2, off + pos, d1, d2))
            ext += 3
            pos += c.nvars
        for eq, er, ep, r0, d1, d2 in gp_ext:  # q over the alpha part
            rows.append(np.full(d1, eq, np.int64))
            cols.append(r0 + np.arange(d1, dtype=np.int64))
        for eq, er, ep, r0, d1, d2 in gp_ext:  # r over the q part
            rows.append(np.full(d2, er, np.int64))
            cols.append(r0 + d1 + np.arange(d2, dtype=np.int64))
        for eq, er, ep, r0, d1, d2 in gp_ext:  # p over the whole cone
            rows.append(np.full(d1 + d2, ep, np.int64))
            cols.append(r0 + np.arange(d1 + d2, dtype=np.int64))
        for eq, er, ep, r0, d1, d2 in gp_ext:
            rows.append(np.asarray([eq, er, ep], np.int64))
            cols.append(np.asarray([eq, er, ep], np.int64))
        signs += [-1.0, -1.0, 1.0] * len(gp_ext)

    if not rows:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.asarray(signs, np.float64),
    )


def expansion_vals(layout: ConeLayout, state, dtype, device, batch=(),
                   soc_expanded=(), genpow_expanded=False):
    """Expansion entry values ``[..., entries]`` in the order of
    :func:`expansion_coords`, one row per problem of the batch shape
    ``batch``.

    SOC rank-2 factors (socone.rs:186-207): with normalized w and
    wsq = w'w,  d = 1/(2 wsq),  u = [sqrt(wsq - d); (2 w0 / u0) w_1:],
    v = [0; v1 w_1:],  v1 = sqrt(2 (2 + 1/wsq) / (2 wsq - 1/wsq)); the
    K entries are -eta^2 u / -eta^2 v with ext diag eta^2 (-1, 1).
    GenPow (datamaps.rs:330-343): columns -sqrt(mu) q/r/p, diag (-1,-1,1).
    """
    parts = []
    ix = _idx(layout, device)
    as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)

    if layout.num_soc and soc_expanded and any(soc_expanded):
        exp_mask = np.asarray(soc_expanded, bool)
        sel = as_long(np.where(exp_mask[layout.soc_seg])[0])  # static row indices
        cids = as_long(np.where(exp_mask)[0])  # static expanded cone ids
        w, eta = state["soc_w"], state["soc_eta"]
        seg = ix["soc_seg"]
        head = ix["soc_head_mask"]
        w1sq = _soc_sum(layout, _tail(layout, w) ** 2)
        w0 = _heads(layout, w)
        wsq = w0**2 + w1sq
        dd = 0.5 / wsq
        u0 = torch.sqrt(wsq - dd)
        u1 = 2.0 * w0 / u0
        v1 = torch.sqrt(2.0 * (2.0 + 1.0 / wsq) / (2.0 * wsq - 1.0 / wsq))
        u_row = torch.where(head, u0[..., seg], u1[..., seg] * w)
        v_row = torch.where(head, 0.0, v1[..., seg] * w)
        eta2r = (eta**2)[..., seg]
        parts.append((-eta2r * v_row)[..., sel])
        parts.append((-eta2r * u_row)[..., sel])
        eta2c = (eta**2)[..., cids]
        parts.append(_flat(torch.stack([-eta2c, eta2c], dim=-1), batch))

    if genpow_expanded and layout.num_genpow:
        isq = np.asarray(layout.genpow_is_q, bool)
        sqmu = _col(torch.sqrt(state["gp_mu"]))
        parts.append((-sqmu * state["gp_q"])[..., as_long(np.where(~isq)[0])])
        parts.append((-sqmu * state["gp_r"])[..., as_long(np.where(isq)[0])])
        parts.append(-sqmu * state["gp_p"])
        ones = torch.ones(tuple(batch) + (layout.num_genpow,), dtype=dtype, device=device)
        parts.append(_flat(torch.stack([-ones, -ones, ones], dim=-1), batch))

    if not parts:
        return torch.zeros(tuple(batch) + (0,), dtype=dtype, device=device)
    return torch.cat([p.to(dtype) for p in parts], dim=-1)

"""Ruiz equilibration of dense problem data.

PyTorch port of ``clarabel_tpu/equilibration.py:equilibrate`` (reference:
src/solver/implementations/default/problemdata.rs:229-312).  The loop runs a
fixed ``equilibrate_max_iter`` passes, as the reference does; the cost scale
``c`` stays a tensor, so nothing here waits for the device.  The data may
carry leading batch dimensions (P [..., n, n], q [..., n], A [..., m, n],
b [..., m]); every norm and the cost scale ``c`` [...] are then per problem.
"""

from __future__ import annotations

import torch

from .cones import ops as cone_ops
from .cones.layout import ConeLayout


def _absmax(M, dim):
    """``jnp.max(jnp.abs(M), axis=dim, initial=0.0)``."""
    if M.shape[dim] == 0:
        shape = list(M.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=M.dtype, device=M.device)
    return torch.clamp(M.abs().amax(dim=dim), min=0.0)


def equilibrate(layout: ConeLayout, settings, P, q, A, b, triu_mask):
    """Returns (P, q, A, b, d, e, c) with data scaled in the equilibrated
    frame: P' = c·dPd, q' = c·dq, A' = eAd, b' = eb.

    ``triu_mask`` is the upper-triangle mask of P used for the cost
    normalization term (the reference computes column norms of the
    triu-stored P there; problemdata.rs:280-295).
    """
    n, m = q.shape[-1], b.shape[-1]
    batch = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)

    d = torch.ones(batch + (n,), **kw)
    e = torch.ones(batch + (m,), **kw)
    c = torch.ones(batch, **kw)

    if not settings.equilibrate_enable:
        return P, q, A, b, d, e, c

    scale_min = settings.equilibrate_min_scaling
    scale_max = settings.equilibrate_max_scaling

    for _ in range(settings.equilibrate_max_iter):
        # inf-norms of the KKT columns (problemdata.rs:319-328):
        # LHS cols: symmetric P column norms joined with A column norms;
        # RHS rows: A row norms
        dwork = torch.maximum(_absmax(P, -2), _absmax(A, -2))
        ework = _absmax(A, -1)

        # zero rows / columns are left unscaled
        dwork = torch.where(dwork == 0, 1.0, dwork)
        ework = torch.where(ework == 0, 1.0, ework)

        dwork = 1.0 / torch.sqrt(dwork)
        ework = 1.0 / torch.sqrt(ework)

        # bound the cumulative scaling
        dwork = torch.clamp(dwork, scale_min / d, scale_max / d)
        ework = torch.clamp(ework, scale_min / e, scale_max / e)

        # scale data
        P = P * dwork[..., :, None] * dwork[..., None, :]
        A = A * ework[..., :, None] * dwork[..., None, :]
        q = q * dwork
        b = b * ework
        d = d * dwork
        e = e * ework

        # cost normalization (problemdata.rs:280-295).  The reference takes
        # per-column max-abs over the triu-stored P only.
        col_norm_P = _absmax(P * triu_mask, -2)
        mean_col_norm_P = (
            torch.mean(col_norm_P, dim=-1) if n > 0 else torch.zeros(batch, **kw)
        )
        inf_norm_q = _absmax(q, -1)

        do_cost = (mean_col_norm_P != 0) & (inf_norm_q != 0)
        scale_cost = torch.maximum(inf_norm_q, mean_col_norm_P)
        ctmp = torch.where(
            do_cost, 1.0 / torch.where(do_cost, scale_cost, 1.0), 1.0
        )
        ctmp = torch.where(
            do_cost, torch.clamp(ctmp, scale_min / c, scale_max / c), 1.0
        )

        P = P * ctmp[..., None, None]
        q = q * ctmp[..., None]
        c = c * ctmp

    # per-cone rectification: cones that only admit a scalar scaling get
    # their rows replaced by the cone mean (problemdata.rs:299-307)
    delta, changed = cone_ops.rectify_equilibration(layout, e)
    if changed:
        A = A * delta[..., :, None]
        b = b * delta
        e = e * delta

    return P, q, A, b, d, e, c

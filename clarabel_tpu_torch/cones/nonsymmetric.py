"""Nonsymmetric cones: exponential, 3-D power, generalized power.

PyTorch port of ``clarabel_tpu/cones/nonsymmetric.py``, name for name
(reference: src/solver/core/cones/expcone.rs, powcone.rs, genpowcone.rs,
nonsymmetric_common.rs).  All exponential cones batch into one [..., k, 3]
computation, all power cones into another; generalized power cones use the
fixed-order padded segment sums of ``cones.ops``.  Leading dimensions are
batch dimensions, as everywhere in the port.

The JAX package runs three data-dependent loops as ``lax.while_loop``s.
Each freezes its result per entry or per lane, so steps past a lane's stop
change nothing, and the port keeps the results while reading the device
less often:

- ``_newton_raphson`` takes its masked steps on the device and reads
  whether every entry has stopped only every ``NR_CHECK_EVERY`` steps;
- ``step_length``'s feasibility backtracking builds every candidate α from
  the start by repeated multiplication, as the while loop builds them,
  tests all of them in one batched evaluation and takes, per lane, the
  first that stops the loop: no device read at all (the loop-level barrier
  backtracking in ``loop.calc_step_length`` does the same).

Scaling-state entries produced here:
    exp_hs  [..., k,3,3]   scaling matrix Hs per exponential cone
    exp_hd  [..., k,3,3]   dual-barrier Hessian H(z) per cone
    exp_grad [..., k,3]    dual-barrier gradient per cone
    exp_z   [..., k,3]     copy of z at the scaling point
    (pow_* identically for power cones)
    gp_*                   generalized power data (grad, p, q, r, d1, d2, mu)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import api
from .layout import ConeLayout
from .ops import _col, _idx, _logsafe, _segment_sum
from ..statuses import SCALING_DUAL
from ..timers import host_read

#: steps ``_newton_raphson`` takes between two reads of whether it is done
NR_CHECK_EVERY = 4
#: the longest candidate sequence a backtracking builds (only reached with
#: a backtrack step of 1 or no least step, where the JAX package's loop
#: would not end)
_MAX_CANDIDATES = 4096


# =================================================================
# Wright-Omega function (vectorized)
# =================================================================


def wright_omega(z):
    """ω(z) solving y + log(y) = z for z >= 0.

    reference: expcone.rs:396-458 (Algorithm 4, §8.4 of Serrano's thesis),
    vectorized: both initializations are computed and selected by mask,
    followed by the two fixed refinement iterations.
    """
    zm1 = z - 1.0
    # Taylor series initialization for z < 1 + π
    w_small = (
        1.0
        + 0.5 * zm1
        + (1.0 / 16.0) * zm1**2
        - (1.0 / 192.0) * zm1**3
        - (1.0 / 3072.0) * zm1**4
        + (13.0 / 61440.0) * zm1**5
    )
    # log-series initialization for large z
    zsafe = torch.clamp(z, min=1.0)
    logz = torch.log(zsafe)
    zinv = 1.0 / zsafe
    w_big = zsafe - logz
    q = logz * zinv
    w_big = w_big + q
    q = q * zinv
    w_big = w_big + q * (logz / 2.0 - 1.0)
    q = q * zinv
    w_big = w_big + q * (logz * logz / 3.0 - 1.5 * logz + 1.0)

    w = torch.where(z < 1.0 + math.pi, w_small, w_big)

    r = z - w - torch.log(w)
    for _ in range(2):
        wp1 = w + 1.0
        t = wp1 * (wp1 + 2.0 * r / 3.0)
        w = w * (1.0 + (r / wp1) * (t - 0.5 * r) / (t - r))
        r = (2.0 * w * w - 8.0 * w - 1.0) / (72.0 * wp1**6) * r**4
    return w


# =================================================================
# 3x3 helpers (operate on [..., 3, 3] / [..., 3] batches)
# =================================================================


def _dot3(u, v):
    return (u * v).sum(-1)


def _mv3(H, v):
    return (H * v.unsqueeze(-2)).sum(-1)


def _outer(u, v):
    return u.unsqueeze(-1) * v.unsqueeze(-2)


def _solve3(H, b):
    """Solve H u = b for symmetric positive definite 3x3 batches.

    The reference uses an explicit 3x3 Cholesky (dense/fixed/dense3x3); a
    closed-form adjugate solve is equivalent and fully parallel.  Returns
    (u, ok) where ok requires positive definiteness (checked via the
    leading minors, mirroring the Cholesky failure mode).
    """
    a, b01, b02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    c, c12 = H[..., 1, 1], H[..., 1, 2]
    d = H[..., 2, 2]

    m1 = a
    m2 = a * c - b01 * b01
    det = (
        a * (c * d - c12 * c12)
        - b01 * (b01 * d - c12 * b02)
        + b02 * (b01 * c12 - c * b02)
    )
    ok = (m1 > 0) & (m2 > 0) & (det > 0)

    adj = torch.stack(
        [
            torch.stack([c * d - c12 * c12, b02 * c12 - b01 * d, b01 * c12 - b02 * c], -1),
            torch.stack([c12 * b02 - b01 * d, a * d - b02 * b02, b01 * b02 - a * c12], -1),
            torch.stack([b01 * c12 - c * b02, b02 * b01 - a * c12, a * c - b01 * b01], -1),
        ],
        -2,
    )
    safe_det = torch.where(det != 0, det, 1.0)
    u = _mv3(adj, b) / safe_det.unsqueeze(-1)
    return u, ok


def _sym3(a00, a01, a02, a11, a12, a22):
    row0 = torch.stack([a00, a01, a02], -1)
    row1 = torch.stack([a01, a11, a12], -1)
    row2 = torch.stack([a02, a12, a22], -1)
    return torch.stack([row0, row1, row2], -2)


# =================================================================
# exponential cone (batched [..., k, 3])
# =================================================================
#
# Primal: s3 >= s2*e^(s1/s2), s2, s3 > 0
# Dual:   z3 >= -z1*e^(z2/z1 - 1), z3 > 0, z1 < 0
# reference: expcone.rs:192-353


def exp_unit_init():
    """Hard-coded interior point (expcone.rs:88-94)."""
    return np.array([-1.051383945322714, 0.556409619469370, 1.258967884768947])


def exp_is_primal_feasible(s):
    ok = (s[..., 2] > 0) & (s[..., 1] > 0)
    res = s[..., 1] * _logsafe(s[..., 2] / torch.where(ok, s[..., 1], 1.0)) - s[..., 0]
    return ok & (res > 0)


def exp_is_dual_feasible(z):
    ok = (z[..., 2] > 0) & (z[..., 0] < 0)
    zsafe0 = torch.where(ok, z[..., 0], -1.0)
    res = z[..., 1] - z[..., 0] - z[..., 0] * _logsafe(-z[..., 2] / zsafe0)
    return ok & (res > 0)


def exp_barrier_dual(z):
    """f*(z) = -log(-z3 z1) - log(z2 - z1 - z1 log(-z3/z1))  (expcone.rs:245-254)"""
    l = _logsafe(-z[..., 2] / z[..., 0])
    return -_logsafe(-z[..., 2] * z[..., 0]) - _logsafe(
        z[..., 1] - z[..., 0] - z[..., 0] * l
    )


def exp_barrier_primal(s):
    """f(s) via the Wright-Omega closed form (expcone.rs:228-243)."""
    w = wright_omega(1.0 - s[..., 0] / s[..., 1] - _logsafe(s[..., 1] / s[..., 2]))
    w = (w - 1.0) ** 2 / w
    return -_logsafe(w) - 2.0 * _logsafe(s[..., 1]) - _logsafe(s[..., 2]) - 3.0


def exp_grad_dual(z):
    """Gradient of f* at z (expcone.rs:338-343)."""
    l = _logsafe(-z[..., 2] / z[..., 0])
    r = -z[..., 0] * l - z[..., 0] + z[..., 1]
    c2 = 1.0 / r
    g0 = c2 * l - 1.0 / z[..., 0]
    g1 = -c2
    g2 = (c2 * z[..., 0] - 1.0) / z[..., 2]
    return torch.stack([g0, g1, g2], -1)


def exp_hess_dual(z):
    """Hessian of f* at z (expcone.rs:345-353)."""
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    l = _logsafe(-z2 / z0)
    r = -z0 * l - z0 + z1
    H00 = (r * r - z0 * r + l * l * z0 * z0) / (r * z0 * z0 * r)
    H01 = -l / (r * r)
    H11 = 1.0 / (r * r)
    H02 = (z1 - z0) / (r * r * z2)
    H12 = -z0 / (r * r * z2)
    H22 = (r * r - z0 * r + z0 * z0) / (r * r * z2 * z2)
    return _sym3(H00, H01, H02, H11, H12, H22)


def exp_grad_primal(s):
    """Gradient of the primal barrier (expcone.rs:361-372)."""
    w = wright_omega(1.0 - s[..., 0] / s[..., 1] - _logsafe(s[..., 1] / s[..., 2]))
    g0 = 1.0 / ((w - 1.0) * s[..., 1])
    g1 = g0 + g0 * _logsafe(w * s[..., 1] / s[..., 2]) - 1.0 / s[..., 1]
    g2 = w / ((1.0 - w) * s[..., 2])
    return torch.stack([g0, g1, g2], -1)


def exp_higher_correction(Hd, z, ds, v):
    """Third-order correction η (expcone.rs:256-308)."""
    u, ok = _solve3(Hd, ds)

    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    eta2 = -z0 / z2
    eta = torch.stack([_logsafe(eta2), torch.ones_like(z0), eta2], -1)
    psi = z0 * eta[..., 0] - z0 + z1

    dpsi_u = _dot3(u, eta)
    dpsi_v = _dot3(v, eta)

    u0, u2 = u[..., 0], u[..., 2]
    v0, v2 = v[..., 0], v[..., 2]

    coef = (
        (u0 * (v0 / z0 - v2 / z2) + u2 * (z0 * v2 / z2 - v0) / z2) * psi
        - 2.0 * dpsi_u * dpsi_v
    ) / (psi**3)
    out = coef.unsqueeze(-1) * eta

    inv_psi2 = 1.0 / (psi * psi)
    add0 = (
        (1.0 / psi - 2.0 / z0) * u0 * v0 / (z0 * z0)
        - u2 * v2 / (z2 * z2) / psi
        + dpsi_u * inv_psi2 * (v0 / z0 - v2 / z2)
        + dpsi_v * inv_psi2 * (u0 / z0 - u2 / z2)
    )
    add2 = (
        2.0 * (z0 / psi - 1.0) * u2 * v2 / (z2**3)
        - (u2 * v0 + u0 * v2) / (z2 * z2) / psi
        + dpsi_u * inv_psi2 * (z0 * v2 / (z2 * z2) - v0 / z2)
        + dpsi_v * inv_psi2 * (z0 * u2 / (z2 * z2) - u0 / z2)
    )
    out = torch.stack([out[..., 0] + add0, out[..., 1], out[..., 2] + add2], -1)
    out = 0.5 * out
    return torch.where(ok.unsqueeze(-1), out, 0.0)


# =================================================================
# power cone (batched [..., k, 3], exponent a in (0,1))
# =================================================================
#
# Primal: s1^a s2^(1-a) >= |s3|, s1, s2 >= 0
# Dual:   (z1/a)^a (z2/(1-a))^(1-a) >= |z3|, z1, z2 >= 0
# reference: powcone.rs:185-433


def pow_unit_init(a):
    """Unit initialization: z = s = (sqrt(1+a), sqrt(2-a), 0).

    reference: powcone.rs unit_initialization (via GenPow formula
    sqrt(1+αi) with the 3-D layout)
    """
    a = np.asarray(a, np.float64)
    return np.stack(
        [np.sqrt(1.0 + a), np.sqrt(1.0 + (1.0 - a)), np.zeros_like(a)], -1
    )


def pow_is_primal_feasible(a, s):
    ok = (s[..., 0] > 0) & (s[..., 1] > 0)
    res = (
        torch.exp(2.0 * a * _logsafe(s[..., 0]) + 2.0 * (1.0 - a) * _logsafe(s[..., 1]))
        - s[..., 2] * s[..., 2]
    )
    return ok & (res > 0)


def pow_is_dual_feasible(a, z):
    ok = (z[..., 0] > 0) & (z[..., 1] > 0)
    res = (
        torch.exp(
            2.0 * a * _logsafe(z[..., 0] / a)
            + 2.0 * (1.0 - a) * _logsafe(z[..., 1] / (1.0 - a))
        )
        - z[..., 2] * z[..., 2]
    )
    return ok & (res > 0)


def _pow_phi(a, z):
    return (z[..., 0] / a) ** (2.0 * a) * (z[..., 1] / (1.0 - a)) ** (2.0 - 2.0 * a)


def pow_barrier_dual(a, z):
    """powcone.rs:249-261"""
    arg1 = _pow_phi(a, z) - z[..., 2] * z[..., 2]
    return (
        -_logsafe(arg1)
        - (1.0 - a) * _logsafe(z[..., 0])
        - a * _logsafe(z[..., 1])
    )


def pow_barrier_primal(a, s):
    """powcone.rs:226-247 — f(s) = -f*(-g(s)) - 3 with ⟨s, g⟩ = -3."""
    g = pow_grad_primal(a, s)
    out = _logsafe(
        (-g[..., 0] / a) ** (2.0 * a)
        * (-g[..., 1] / (1.0 - a)) ** (2.0 - 2.0 * a)
        - g[..., 2] * g[..., 2]
    )
    out = out + (1.0 - a) * _logsafe(-g[..., 0])
    out = out + a * _logsafe(-g[..., 1]) - 3.0
    return out


def pow_grad_dual_and_hess(a, z):
    """Gradient and Hessian of f* at z (powcone.rs:354-386)."""
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    phi = _pow_phi(a, z)
    psi = phi - z2 * z2

    g0 = 2.0 * a * phi / (z0 * psi)
    g1 = 2.0 * (1.0 - a) * phi / (z1 * psi)
    g2 = -2.0 * z2 / psi

    H00 = g0 * g0 - 2.0 * a * (2.0 * a - 1.0) * phi / (z0 * z0 * psi) + (1.0 - a) / (
        z0 * z0
    )
    H01 = g0 * g1 - 4.0 * a * (1.0 - a) * phi / (z0 * z1 * psi)
    H11 = g1 * g1 - 2.0 * (1.0 - a) * (1.0 - 2.0 * a) * phi / (z1 * z1 * psi) + a / (
        z1 * z1
    )
    H02 = g0 * g2
    H12 = g1 * g2
    H22 = g2 * g2 + 2.0 / psi

    grad = torch.stack([-g0 - (1.0 - a) / z0, -g1 - a / z1, -g2], -1)
    return grad, _sym3(H00, H01, H02, H11, H12, H22)


def _newton_raphson(x0, f0, f1, iters=100):
    """One-sided Newton-Raphson with the reference's stopping rules
    (nonsymmetric_common.rs:193-219), batched over every entry of ``x0``:
    each entry stops by itself and stays frozen, and the loop ends once
    every entry has stopped or after ``iters`` steps, as the JAX package's
    while loop does.  A frozen entry's step changes nothing, so the host
    reads whether all have stopped only every ``NR_CHECK_EVERY`` steps."""
    x = x0
    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    eps = torch.finfo(x0.dtype).eps
    sqrt_eps = math.sqrt(eps)
    for k in range(iters):
        if k and k % NR_CHECK_EVERY == 0 and host_read(done.all()):
            break
        dfdx = f1(x)
        safe = torch.where(dfdx != 0, dfdx, 1.0)
        dx = -f0(x) / safe
        stop = (
            (dx < eps)
            | (torch.abs(dx / torch.where(x != 0, x, 1.0)) < sqrt_eps)
            | (torch.abs(dfdx) < eps)
        )
        x = torch.where(done | stop, x, x + dx)
        done = done | stop
    return x


def pow_grad_primal(a, s):
    """Primal-barrier gradient via Newton-Raphson (powcone.rs:394-420,
    447-491)."""
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    phi = s0 ** (2.0 * a) * s1 ** (2.0 - 2.0 * a)
    abs_s = torch.abs(s2)
    eps = torch.finfo(s.dtype).eps

    big = abs_s > eps
    sa = torch.where(big, abs_s, 1.0)

    x0 = -1.0 / sa + (2.0 * sa + torch.sqrt(phi * phi / (sa * sa) + 3.0 * phi)) / (
        phi - sa * sa
    )
    t0 = -2.0 * a * _logsafe(a) - 2.0 * (1.0 - a) * _logsafe(1.0 - a)

    def f0(x):
        t1 = x * x
        t2 = 2.0 * x / sa
        return (
            2.0 * a * _logsafe(2.0 * a * t1 + (1.0 + a) * t2)
            + 2.0 * (1.0 - a) * _logsafe(2.0 * (1.0 - a) * t1 + (2.0 - a) * t2)
            - _logsafe(phi)
            - _logsafe(t1 + t2)
            - 2.0 * _logsafe(t2)
            + t0
        )

    def f1(x):
        t1 = x * x
        t2 = 2.0 * x / sa
        return (
            2.0 * a * a / (a * x + (1.0 + a) / sa)
            + 2.0 * (1.0 - a) * (1.0 - a) / ((1.0 - a) * x + (2.0 - a) / sa)
            - 2.0 * (x + 1.0 / sa) / (t1 + t2)
        )

    g2abs = _newton_raphson(x0, f0, f1)
    g2 = torch.where(big, torch.where(s2 < 0, -g2abs, g2abs), 0.0)
    g0 = torch.where(big, -(a * g2 * s2 + 1.0 + a) / s0, -(1.0 + a) / s0)
    g1 = torch.where(
        big, -((1.0 - a) * g2 * s2 + 2.0 - a) / s1, -(2.0 - a) / s1
    )
    return torch.stack([g0, g1, g2], -1)


def pow_higher_correction(a, Hd, z, ds, v):
    """Third-order correction η (powcone.rs:263-341)."""
    u, ok = _solve3(Hd, ds)
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]

    phi = _pow_phi(a, z)
    psi = phi - z2 * z2

    eta = torch.stack(
        [2.0 * a * phi / z0, 2.0 * (1.0 - a) * phi / z1, -2.0 * z2], -1
    )

    Hpsi = _sym3(
        2.0 * a * (2.0 * a - 1.0) * phi / (z0 * z0),
        4.0 * a * (1.0 - a) * phi / (z0 * z1),
        torch.zeros_like(z0),
        2.0 * (1.0 - a) * (1.0 - 2.0 * a) * phi / (z1 * z1),
        torch.zeros_like(z0),
        -2.0 * torch.ones_like(z0),
    )

    dpsi_u = _dot3(u, eta)
    dpsi_v = _dot3(v, eta)
    Hpsi_v = _mv3(Hpsi, v)
    Hpsi_u = _mv3(Hpsi, u)

    coef = (_dot3(u, Hpsi_v) * psi - 2.0 * dpsi_u * dpsi_v) / (psi**3)
    coef2 = (
        4.0
        * a
        * (2.0 * a - 1.0)
        * (1.0 - a)
        * phi
        * (u[..., 0] / z0 - u[..., 1] / z1)
        * (v[..., 0] / z0 - v[..., 1] / z1)
        / psi
    )
    inv_psi2 = 1.0 / (psi * psi)

    e0 = (
        coef * eta[..., 0]
        - 2.0 * (1.0 - a) * u[..., 0] * v[..., 0] / (z0**3)
        + coef2 / z0
        + Hpsi_v[..., 0] * dpsi_u * inv_psi2
    )
    e1 = (
        coef * eta[..., 1]
        - 2.0 * a * u[..., 1] * v[..., 1] / (z1**3)
        - coef2 / z1
        + Hpsi_v[..., 1] * dpsi_u * inv_psi2
    )
    e2 = coef * eta[..., 2] + Hpsi_v[..., 2] * dpsi_u * inv_psi2

    out = torch.stack([e0, e1, e2], -1)
    out = 0.5 * (out + Hpsi_u * (dpsi_v * inv_psi2).unsqueeze(-1))
    return torch.where(ok.unsqueeze(-1), out, 0.0)


# =================================================================
# primal-dual scaling for the 3-D cones
# =================================================================


def pd_scaling_hs(Hd, grad_dual, grad_primal_fn, s, z):
    """Mosek-style primal-dual scaling with rank-3 structure, falling back
    to dual scaling near the central path.

    reference: nonsymmetric_common.rs:69-142.  Batched over [..., 3].
    """
    zt = grad_primal_fn(s)
    st = grad_dual

    dot_sz = _dot3(s, z)
    mu = dot_sz / 3.0
    mut = _dot3(st, zt) / 3.0

    ds = s + mu.unsqueeze(-1) * st
    dz = z + mu.unsqueeze(-1) * zt
    dot_dsz = _dot3(ds, dz)

    Hzt = _mv3(Hd, zt)
    de1 = mu * mut - 1.0
    de2 = _dot3(zt, Hzt) - 3.0 * mut * mut

    eps = torch.finfo(s.dtype).eps
    use_pd = (
        (torch.abs(de1) > math.sqrt(eps))
        & (torch.abs(de2) > eps)
        & (dot_sz > 0)
        & (dot_dsz > 0)
    )

    safe_de2 = torch.where(de2 != 0, de2, 1.0)
    tmp = mut.unsqueeze(-1) * st - Hzt
    Hwork = (
        Hd
        - _outer(st, st) / 3.0
        - _outer(tmp, tmp) / safe_de2[..., None, None]
    )
    t = mu * torch.sqrt(torch.sum(Hwork * Hwork, dim=(-2, -1)))

    axis_z = torch.linalg.cross(z, zt, dim=-1)
    axis_norm = torch.linalg.vector_norm(axis_z, dim=-1, keepdim=True)
    axis_z = axis_z / torch.where(axis_norm > 0, axis_norm, 1.0)

    safe_dot_sz = torch.where(dot_sz != 0, dot_sz, 1.0)
    safe_dot_dsz = torch.where(dot_dsz != 0, dot_dsz, 1.0)
    # Hs = s·sᵀ/⟨s,z⟩ + δs·δsᵀ/⟨δs,δz⟩ + t·axis_z·axis_zᵀ
    Hs_pd = (
        _outer(s, s) / safe_dot_sz[..., None, None]
        + _outer(ds, ds) / safe_dot_dsz[..., None, None]
        + t[..., None, None] * _outer(axis_z, axis_z)
    )

    Hs_dual = mu[..., None, None] * Hd
    return torch.where(use_pd[..., None, None], Hs_pd, Hs_dual)


# =================================================================
# layout-level composite hooks (called from cones.ops)
# =================================================================


def _exp_slice(layout):
    return layout.slice_of(api.EXP)


def _pow_slice(layout):
    return layout.slice_of(api.POW)


def _gp_slice(layout):
    return layout.slice_of(api.GENPOW)


def _triples(v):
    """[..., 3k] -> [..., k, 3]"""
    return v.reshape(v.shape[:-1] + (-1, 3))


def _flat(v):
    """[..., k, 3] -> [..., 3k]"""
    return v.reshape(v.shape[:-2] + (-1,))


def _pow_alpha(layout, like):
    return _idx(layout, like.device)["pow_alpha"].to(like.dtype)


def _per_lane(flag, like):
    """A per-problem tensor (or number) shaped to broadcast over ``like``'s
    trailing dimensions beyond the batch shape of ``flag``."""
    flag = torch.as_tensor(flag, device=like.device)
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def unit_initialization(layout: ConeLayout, z, s):
    """(z, s) with the unit initial point on every nonsymmetric cone, in
    place."""
    dt, dev = z.dtype, z.device
    put = lambda v: torch.as_tensor(np.asarray(v, np.float64).reshape(-1), dtype=dt, device=dev)
    if layout.num_exp:
        sl = _exp_slice(layout)
        pt = put(np.tile(exp_unit_init(), layout.num_exp))
        z[..., sl] = pt
        s[..., sl] = pt
    if layout.num_pow:
        sl = _pow_slice(layout)
        pt = put(pow_unit_init(layout.pow_alpha))
        z[..., sl] = pt
        s[..., sl] = pt
    if layout.num_genpow:
        sl = _gp_slice(layout)
        # reference: genpowcone.rs:132-140 — sqrt(1+αi) on the α part,
        # zero on the q part
        pt = put(np.where(layout.genpow_is_q, 0.0, np.sqrt(1.0 + layout.genpow_alpha)))
        z[..., sl] = pt
        s[..., sl] = pt
    return z, s


def _all_finite(Hs):
    """Whether every [3, 3] block of ``Hs [..., k, 3, 3]`` is finite, per
    problem."""
    return torch.isfinite(Hs).flatten(-3).all(-1)


def update_scaling(layout: ConeLayout, state, s, z, mu, strategy):
    ok = torch.ones(s.shape[:-1], dtype=torch.bool, device=s.device)

    if layout.num_exp:
        sl = _exp_slice(layout)
        zi = _triples(z[..., sl])
        si = _triples(s[..., sl])
        Hd = exp_hess_dual(zi)
        grad = exp_grad_dual(zi)
        Hs_dual = ((si * zi).sum(-1) / 3.0)[..., None, None] * Hd
        Hs_pd = pd_scaling_hs(Hd, grad, exp_grad_primal, si, zi)
        Hs = torch.where(_per_lane(strategy, Hs_pd) == SCALING_DUAL, Hs_dual, Hs_pd)
        state["exp_hs"] = Hs
        state["exp_hd"] = Hd
        state["exp_grad"] = grad
        state["exp_z"] = zi
        ok = ok & _all_finite(Hs)

    if layout.num_pow:
        sl = _pow_slice(layout)
        a = _pow_alpha(layout, s)
        zi = _triples(z[..., sl])
        si = _triples(s[..., sl])
        grad, Hd = pow_grad_dual_and_hess(a, zi)
        Hs_dual = ((si * zi).sum(-1) / 3.0)[..., None, None] * Hd
        Hs_pd = pd_scaling_hs(Hd, grad, lambda ss: pow_grad_primal(a, ss), si, zi)
        Hs = torch.where(_per_lane(strategy, Hs_pd) == SCALING_DUAL, Hs_dual, Hs_pd)
        state["pow_hs"] = Hs
        state["pow_hd"] = Hd
        state["pow_grad"] = grad
        state["pow_z"] = zi
        ok = ok & _all_finite(Hs)

    if layout.num_genpow:
        state, ok_gp = _gp_update_scaling(layout, state, z, mu)
        ok = ok & ok_gp

    return state, ok


def _gp_seg_sum(layout, x):
    """Per-cone sums ``[..., m_genpow] -> [..., num_genpow]``: the fixed-order
    padded segment sum of ``cones.ops`` (the JAX package uses a 0/1 matmul
    to sidestep a TPU compiler fault)."""
    ix = _idx(layout, x.device)
    return _segment_sum(x, ix["gp_pad_idx"], ix["gp_pad_mask"])


def _gp_consts(layout, like):
    """The genpow metadata on ``like``'s device: (α at ``like``'s dtype,
    is_q, seg)."""
    ix = _idx(layout, like.device)
    return ix["genpow_alpha"].to(like.dtype), ix["genpow_is_q"], ix["genpow_seg"]


def _gp_update_scaling(layout, state, z, mu):
    """Generalized power cone dual gradient / Hessian factors.

    reference: genpowcone.rs:360-401.  Hs = μ(D + pp' − qq' − rr').
    """
    sl = _gp_slice(layout)
    zi = z[..., sl]
    a, is_q, seg = _gp_consts(layout, zi)

    # φ = Π (z_i/α_i)^(2α_i) over the α part
    logphi_terms = torch.where(is_q, 0.0, 2.0 * a * _logsafe(zi / torch.where(is_q, 1.0, a)))
    phi = torch.exp(_gp_seg_sum(layout, logphi_terms))
    norm2w = _gp_seg_sum(layout, torch.where(is_q, zi * zi, 0.0))
    zeta = phi - norm2w
    ok = torch.all(zeta > 0, dim=-1)

    tau = torch.where(is_q, 0.0, 2.0 * a / zi)
    grad = torch.where(
        is_q,
        (2.0 / zeta[..., seg]) * zi,
        -tau * phi[..., seg] / zeta[..., seg] - (1.0 - a) / zi,
    )

    p0 = torch.sqrt(phi * (phi + norm2w) / 2.0)
    p1 = -2.0 * phi / p0
    q0 = torch.sqrt(zeta * phi / 2.0)
    r1 = 2.0 * torch.sqrt(zeta / (phi + norm2w))

    d1 = torch.where(
        is_q, 0.0, tau * phi[..., seg] / (zeta[..., seg] * zi) + (1.0 - a) / (zi * zi)
    )
    d2 = 2.0 / zeta

    p = torch.where(is_q, (p1 / zeta)[..., seg] * zi, (p0 / zeta)[..., seg] * tau)
    qv = torch.where(is_q, 0.0, (q0 / zeta)[..., seg] * tau)
    rv = torch.where(is_q, (r1 / zeta)[..., seg] * zi, 0.0)

    state["gp_grad"] = grad
    state["gp_p"] = p
    state["gp_q"] = qv
    state["gp_r"] = rv
    state["gp_d1"] = d1  # per-entry diag (zero on q part)
    state["gp_d2"] = d2  # per-cone scalar for the q part
    state["gp_mu"] = torch.as_tensor(mu, dtype=z.dtype, device=z.device)
    state["gp_z"] = zi
    return state, ok


def hs_dense(layout: ConeLayout, state, H):
    """``H [..., m, m]`` with every nonsymmetric cone's Hs block written in
    place."""
    if layout.num_exp:
        sl = _exp_slice(layout)
        H = _embed_3x3_blocks(H, state["exp_hs"], sl.start)
    if layout.num_pow:
        sl = _pow_slice(layout)
        H = _embed_3x3_blocks(H, state["pow_hs"], sl.start)
    if layout.num_genpow:
        sl = _gp_slice(layout)
        _, is_q, seg = _gp_consts(layout, H)
        same = seg[:, None] == seg[None, :]
        p, qv, rv = state["gp_p"], state["gp_q"], state["gp_r"]
        diag = torch.where(is_q, state["gp_d2"][..., seg], state["gp_d1"])
        blk = (
            torch.where(same, _outer(p, p), 0.0)
            - torch.where(same, _outer(qv, qv), 0.0)
            - torch.where(same, _outer(rv, rv), 0.0)
            + torch.diag_embed(diag)
        )
        H[..., sl, sl] = state["gp_mu"][..., None, None] * blk
    return H


def _embed_3x3_blocks(H, blocks, start):
    """Place ``[..., k, 3, 3]`` blocks on the diagonal of ``H [..., m, m]``
    beginning at ``start``, in place."""
    k = blocks.shape[-3]
    idx = start + torch.arange(3 * k, device=H.device).reshape(k, 3)
    rows = idx[:, :, None]  # [k,3,1]
    cols = idx[:, None, :]  # [k,1,3]
    H[..., rows, cols] = blocks
    return H


def mul_hs(layout: ConeLayout, state, x, y):
    """``y`` with Hs x written on every nonsymmetric cone's rows, in place."""
    if layout.num_exp:
        sl = _exp_slice(layout)
        y[..., sl] = _flat(_mv3(state["exp_hs"], _triples(x[..., sl])))
    if layout.num_pow:
        sl = _pow_slice(layout)
        y[..., sl] = _flat(_mv3(state["pow_hs"], _triples(x[..., sl])))
    if layout.num_genpow:
        sl = _gp_slice(layout)
        xi = x[..., sl]
        _, is_q, seg = _gp_consts(layout, xi)
        p, qv, rv = state["gp_p"], state["gp_q"], state["gp_r"]
        coef_p = _gp_seg_sum(layout, p * xi)
        coef_q = _gp_seg_sum(layout, qv * xi)
        coef_r = _gp_seg_sum(layout, rv * xi)
        diag = torch.where(is_q, state["gp_d2"][..., seg], state["gp_d1"])
        out = diag * xi - coef_q[..., seg] * qv - coef_r[..., seg] * rv + coef_p[..., seg] * p
        y[..., sl] = _col(state["gp_mu"]) * out
    return y


def affine_ds(layout: ConeLayout, ds, s):
    """Nonsymmetric cones use ds = s (expcone.rs:134-136 etc.), in place."""
    for sl in _present_slices(layout):
        ds[..., sl] = s[..., sl]
    return ds


def _present_slices(layout):
    out = []
    if layout.num_exp:
        out.append(_exp_slice(layout))
    if layout.num_pow:
        out.append(_pow_slice(layout))
    if layout.num_genpow:
        out.append(_gp_slice(layout))
    return out


def combined_ds_shift(layout: ConeLayout, state, shift, step_z, step_s, sigma_mu, z):
    """shift = σμ·g(z) − η(Δs, Δz)  (expcone.rs:138-147, powcone.rs:131-140,
    genpowcone.rs:208-213 — no 3rd-order term for genpow), in place;
    ``sigma_mu`` is a per-problem scalar."""
    del z
    sm = sigma_mu[..., None, None]
    if layout.num_exp:
        sl = _exp_slice(layout)
        dz = _triples(step_z[..., sl])
        dsv = _triples(step_s[..., sl])
        eta = exp_higher_correction(state["exp_hd"], state["exp_z"], dsv, dz)
        shift[..., sl] = _flat(state["exp_grad"] * sm - eta)
    if layout.num_pow:
        sl = _pow_slice(layout)
        a = _pow_alpha(layout, step_z)
        dz = _triples(step_z[..., sl])
        dsv = _triples(step_s[..., sl])
        eta = pow_higher_correction(a, state["pow_hd"], state["pow_z"], dsv, dz)
        shift[..., sl] = _flat(state["pow_grad"] * sm - eta)
    if layout.num_genpow:
        sl = _gp_slice(layout)
        shift[..., sl] = state["gp_grad"] * _col(sigma_mu)
    return shift


# -----------------------------------------------------------------
# backtracking line searches: every candidate at once
# -----------------------------------------------------------------


def backtrack_candidates(alpha, step, count):
    """``[..., count + 1]``: α, α·step, (α·step)·step, ... -- built by
    repeated multiplication, as the JAX package's while loops build them,
    so that each candidate is bitwise the loop's."""
    out = [alpha]
    for _ in range(count):
        out.append(out[-1] * step)
    return torch.stack(out, dim=-1)


def first_stop(stop):
    """Index of the first True along the last dimension of ``stop``, or the
    last index where none is: the candidate at which a loop that tests the
    candidates in order stops (a loop capped at the last candidate)."""
    stop = stop.clone()
    stop[..., -1] = True
    return torch.argmax(stop.to(torch.int32), dim=-1)


def take(candidates, j):
    """Candidate ``j [...]`` of ``candidates [..., J]``."""
    return candidates.gather(-1, j.unsqueeze(-1)).squeeze(-1)


def _backtrack_count(step, amin):
    """How many multiplications by ``step`` the JAX package's feasibility
    backtracking takes at most from α ≤ 1 before α < ``amin`` stops it
    (nonsymmetric_common.rs:164-192): α only shrinks, so the sequence from
    1 bounds every other."""
    a, count = 1.0, 0
    while a >= amin and a > 0.0 and count < _MAX_CANDIDATES:
        a *= step
        count += 1
    return count


def _backtrack(feasible_fn, q, dq, a, j, amin):
    """One check of the feasibility backtracking (nonsymmetric_common.rs:
    164-192), the JAX package's while loop that shrinks α until every cone
    admits q + α·dq or α < ``amin``, run on the candidates ``a [..., J]``
    from index ``j [...]`` on: the index where that loop stops.
    ``feasible_fn`` maps points ``[..., J, k]`` to per-cone flags."""
    pts = q.unsqueeze(-2) + a.unsqueeze(-1) * dq.unsqueeze(-2)
    stop = feasible_fn(pts).all(-1) | ~(a >= amin)
    order = torch.arange(a.shape[-1], device=a.device)
    return first_stop(stop & (order >= j.unsqueeze(-1)))


def step_length(layout: ConeLayout, state, dz, ds, z, s, settings, alpha):
    """Feasibility backtracking over the nonsymmetric cones
    (nonsymmetric_common.rs:164-192), per problem: α shrinks by
    ``linesearch_backtrack_step`` until every cone admits z + αΔz (then
    s + αΔs, kind by kind), or to 0 below ``min_terminate_step_length``.

    The JAX package runs one while loop per check, each starting where the
    last stopped.  Every loop multiplies the same α by the same step, so
    all of them walk one sequence: it is built once, every check tests all
    of it in one batched evaluation (``_backtrack``), and the index where
    each check stops carries to the next.  ``alpha`` is at most 1."""
    del state
    amin = settings.min_terminate_step_length
    step = settings.linesearch_backtrack_step
    a = backtrack_candidates(alpha, step, _backtrack_count(step, amin))
    j = torch.zeros(alpha.shape, dtype=torch.long, device=alpha.device)
    if layout.num_exp:
        sl = _exp_slice(layout)
        j = _backtrack(lambda v: exp_is_dual_feasible(_triples(v)), z[..., sl], dz[..., sl],
                       a, j, amin)
        j = _backtrack(lambda v: exp_is_primal_feasible(_triples(v)), s[..., sl], ds[..., sl],
                       a, j, amin)
    if layout.num_pow:
        sl = _pow_slice(layout)
        pa = _pow_alpha(layout, z)
        j = _backtrack(lambda v: pow_is_dual_feasible(pa, _triples(v)), z[..., sl], dz[..., sl],
                       a, j, amin)
        j = _backtrack(lambda v: pow_is_primal_feasible(pa, _triples(v)), s[..., sl],
                       ds[..., sl], a, j, amin)
    if layout.num_genpow:
        sl = _gp_slice(layout)
        j = _backtrack(lambda v: _gp_is_dual_feasible(layout, v), z[..., sl], dz[..., sl],
                       a, j, amin)
        j = _backtrack(lambda v: _gp_is_primal_feasible(layout, v), s[..., sl], ds[..., sl],
                       a, j, amin)
    alpha = take(a, j)
    return torch.where(alpha < amin, 0.0, alpha)


def _gp_is_primal_feasible(layout, s):
    """genpowcone.rs:269-288 — returns per-cone feasibility flags [..., k]."""
    a, is_q, _ = _gp_consts(layout, s)
    pos = _gp_seg_sum(layout, torch.where(is_q | (s > 0), 0.0, 1.0).to(s.dtype)) == 0
    logterm = torch.where(is_q, 0.0, 2.0 * a * _logsafe(torch.where(is_q, 1.0, s)))
    res = torch.exp(_gp_seg_sum(layout, logterm)) - _gp_seg_sum(
        layout, torch.where(is_q, s * s, 0.0)
    )
    return pos & (res > 0)


def _gp_is_dual_feasible(layout, z):
    """genpowcone.rs:291-310"""
    a, is_q, _ = _gp_consts(layout, z)
    pos = _gp_seg_sum(layout, torch.where(is_q | (z > 0), 0.0, 1.0).to(z.dtype)) == 0
    logterm = torch.where(
        is_q, 0.0, 2.0 * a * _logsafe(torch.where(is_q, 1.0, z / torch.where(is_q, 1.0, a)))
    )
    res = torch.exp(_gp_seg_sum(layout, logterm)) - _gp_seg_sum(
        layout, torch.where(is_q, z * z, 0.0)
    )
    return pos & (res > 0)


def compute_barrier(layout: ConeLayout, z, s, dz, ds, alpha):
    """Barrier of the nonsymmetric cones at (z + αΔz, s + αΔs), summed per
    problem; ``alpha`` is a column that broadcasts over ``[..., m]``."""
    barrier = torch.zeros((), dtype=z.dtype, device=z.device)
    if layout.num_exp:
        sl = _exp_slice(layout)
        cz = _triples(z[..., sl] + alpha * dz[..., sl])
        cs = _triples(s[..., sl] + alpha * ds[..., sl])
        barrier = barrier + torch.sum(exp_barrier_dual(cz), dim=-1) + torch.sum(
            exp_barrier_primal(cs), dim=-1
        )
    if layout.num_pow:
        sl = _pow_slice(layout)
        a = _pow_alpha(layout, z)
        cz = _triples(z[..., sl] + alpha * dz[..., sl])
        cs = _triples(s[..., sl] + alpha * ds[..., sl])
        barrier = barrier + torch.sum(pow_barrier_dual(a, cz), dim=-1) + torch.sum(
            pow_barrier_primal(a, cs), dim=-1
        )
    if layout.num_genpow:
        sl = _gp_slice(layout)
        cz = z[..., sl] + alpha * dz[..., sl]
        cs = s[..., sl] + alpha * ds[..., sl]
        barrier = barrier + torch.sum(_gp_barrier_dual(layout, cz), dim=-1)
        barrier = barrier + torch.sum(_gp_barrier_primal(layout, cs), dim=-1)
    return barrier


def _gp_barrier_dual(layout, z):
    """genpowcone.rs:333-354"""
    a, is_q, _ = _gp_consts(layout, z)
    logterm = torch.where(
        is_q, 0.0, 2.0 * a * _logsafe(torch.where(is_q, 1.0, z / torch.where(is_q, 1.0, a)))
    )
    res = torch.exp(_gp_seg_sum(layout, logterm)) - _gp_seg_sum(
        layout, torch.where(is_q, z * z, 0.0)
    )
    per_entry = torch.where(is_q, 0.0, -(1.0 - a) * _logsafe(z))
    return -_logsafe(res) + _gp_seg_sum(layout, per_entry)


def _gp_barrier_primal(layout, s):
    """genpowcone.rs:312-331 — f(s) = -f*(-g(s)) - ν."""
    g = _gp_gradient_primal(layout, s)
    degs = _idx(layout, s.device)["genpow_degree"].to(s.dtype)
    return -_gp_barrier_dual(layout, -g) - degs


def _gp_gradient_primal(layout, s):
    """genpowcone.rs:409-441"""
    a, is_q, seg = _gp_consts(layout, s)
    ix = _idx(layout, s.device)

    logphi = _gp_seg_sum(layout, torch.where(is_q, 0.0, 2.0 * a * _logsafe(s)))
    phi = torch.exp(logphi)
    norm_r = torch.sqrt(_gp_seg_sum(layout, torch.where(is_q, s * s, 0.0)))
    eps = torch.finfo(s.dtype).eps
    big = norm_r > eps
    nr = torch.where(big, norm_r, 1.0)

    psi = ix["genpow_psi"].to(s.dtype)

    x0 = -1.0 / nr + (psi * nr + torch.sqrt((phi / nr / nr + psi * psi - 1.0) * phi)) / (
        phi - nr * nr
    )

    asafe = torch.where(is_q, 1.0, a)  # avoid 0-division on the masked q part

    def f0(x):
        finit = -_logsafe(2.0 * x / nr + x * x)
        terms = torch.where(
            is_q,
            0.0,
            2.0 * a * (_logsafe(x[..., seg] * nr[..., seg] + (1.0 + asafe) / asafe) - _logsafe(s)),
        )
        return finit + _gp_seg_sum(layout, terms)

    def f1(x):
        finit = -(2.0 * x + 2.0 / nr) / (x * x + 2.0 * x / nr)
        terms = torch.where(
            is_q, 0.0, 2.0 * a * nr[..., seg] / (nr[..., seg] * x[..., seg] + (1.0 + asafe) / asafe)
        )
        return finit + _gp_seg_sum(layout, terms)

    g1 = _newton_raphson(x0, f0, f1)

    gq = torch.where(is_q, (g1 / nr)[..., seg] * s, 0.0)
    gp_big = -(1.0 + a + a * (g1 * nr)[..., seg]) / torch.where(is_q, 1.0, s)
    gp_small = -(1.0 + a) / torch.where(is_q, 1.0, s)
    gp = torch.where(is_q, 0.0, torch.where(big[..., seg], gp_big, gp_small))
    return torch.where(is_q, torch.where(big[..., seg], gq, 0.0), gp)

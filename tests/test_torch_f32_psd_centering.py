"""The f32 centering recovery of clarabel_tpu_torch's ``loop.py`` against
the JAX package's centering direction, both on the CPU, as
test_torch_f32_psd_solve.py states it: the direction within 1e-3 of the
largest entry of the JAX package's kkt_solve of the same right-hand side on
its own factors.  A file of one test (the JAX package's f32 KKT pieces
compile here), which pytest-xdist's loadfile scheduling runs beside
tests/test_df_lu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu import loop as jloop
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import loop as tloop
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import dense as tdense
from test_torch_f32_psd_solve import F32, _strict_comp_sdp, _svec, _t


def test_centering_recovery_choice():
    """Three lanes at one interior iterate of the strictly complementary
    SDP, the combined step's α and the affine α_aff set per lane: lane 0
    collapsed after a healthy affine step (α = 0.02, α_aff = 0.9) takes the
    centering direction and its step; lane 1 (α = 0.5: not collapsed) and
    lane 2 (α_aff = 0.05: the affine step was short too) keep theirs.  The
    centering direction is the JAX package's kkt_solve of the same
    right-hand side on its own factors (the JAX package's loop.py:1193-1208),
    within 1e-3 of its largest entry."""
    P, q, A, b, cones, x, s, z = _strict_comp_sdp(1, 4, 3, 9)
    P, q, A, b = P[0], q[0], A[0], b[0]
    layout = TorchLayout(tt.cones.api.collapse_cones(cones))
    n = q.shape[0]
    rng = np.random.default_rng(10)
    # an interior iterate near the optimum
    zi = (z[0] + 0.05 * _svec(np.eye(3))).astype(np.float32)
    si = (s[0] + 0.05 * _svec(np.eye(3))).astype(np.float32)
    xi = (x[0] + 0.01 * rng.normal(size=n)).astype(np.float32)
    tau = kappa = np.float32(1.0)
    lanes = lambda v: torch.stack([_t(np.asarray(v, np.float32))] * 3)
    Pt, qt, At, bt = (lanes(v) for v in (P, q, A, b))
    X, S, Z = lanes(xi), lanes(si), lanes(zi)
    T, Kp = torch.ones(3), torch.ones(3)
    tset = tp.port_settings(F32)
    r = tloop.compute_residuals(Pt, qt, At, bt, X, S, Z, T, Kp)
    mu = tloop.calc_mu(layout, r, T, Kp)
    state, _ = tops.update_scaling(layout, tops.set_identity_scaling(
        layout, torch.float32, "cpu", (3,)), S, Z, mu, torch.zeros(3, dtype=torch.int32))
    factors, K, _ = tloop._kkt_prepare(layout, tset, torch.float32, n, False, Pt, At, state)
    assert isinstance(K, tuple) and factors[0] == "df_lu"
    variables = (X, S, Z, T, Kp)
    aff_rhs = (r.rx, tops.affine_ds(layout, state, S), r.rz, r.rtau, T * Kp)
    sol_c, _ = tdense.solve_refined(factors, K, torch.cat([-qt, bt], dim=-1), tset,
                                    want_lo=True)
    x2 = (sol_c[0][..., :n], sol_c[1][..., :n])
    z2 = (sol_c[0][..., n:], sol_c[1][..., n:])
    comb = tuple(torch.full_like(v, 7.0) for v in (X, S, Z, T, Kp))
    alpha = torch.tensor([0.02, 0.5, 0.02])
    alpha_aff = torch.tensor([0.9, 0.9, 0.05])
    tloop._centering_recovery.centering_steps = 0
    got, a, fail = tloop._centering_recovery(
        layout, tset, state, factors, K, Pt, qt, At, bt, x2, z2, r, mu, aff_rhs, variables,
        torch.zeros(3, dtype=torch.int32), False, comb, alpha, alpha_aff,
        torch.zeros(3, dtype=torch.bool), torch.zeros(3, dtype=torch.bool))
    assert int(tloop._centering_recovery.centering_steps) == 1
    assert not fail.any() and a[0] > 0.04 and a[1:].tolist() == pytest.approx([0.5, 0.02])
    for g, c in zip(got, comb):
        assert torch.equal(g[1:], c[1:]) and not torch.equal(g[0], c[0])

    # the JAX package's centering direction at the same iterate
    jl = JaxLayout(ct.cones.api.collapse_cones([ct.PSDTriangleConeT(3)]))
    J = lambda v: jnp.asarray(np.asarray(v, np.float32))
    jr = jloop.compute_residuals(J(P), J(q), J(A), J(b), J(xi), J(si), J(zi), J(tau), J(kappa))
    jmu = jloop.calc_mu(jl, jr, J(tau), J(kappa))
    jstate, _ = jops.update_scaling(jl, jops.set_identity_scaling(jl, jnp.float32), J(si),
                                    J(zi), jmu, 0)
    jfac, jK, _ = jloop._kkt_prepare(jl, F32, jnp.float32, n, False, J(P), J(A), jstate)
    jsc, _ = jloop.solve_kkt_refined(jfac, jK, jnp.concatenate([-J(q), J(b)]), F32, want_lo=True)
    jx2 = (jsc[0][:n], jsc[1][:n])
    jz2 = (jsc[0][n:], jsc[1][n:])
    jaff1 = jops.affine_ds(jl, jstate, J(si))
    shift = jops.combined_ds_shift(jl, jstate, jnp.zeros(jl.m, jnp.float32),
                                   jnp.zeros(jl.m, jnp.float32), jmu, J(zi))
    cent_rhs = (jnp.zeros(n, jnp.float32), jaff1 + shift, jnp.zeros(jl.m, jnp.float32),
                jnp.zeros((), jnp.float32), -jmu + J(tau) * J(kappa))
    jcent, _ = jloop.kkt_solve(jl, jstate, jfac, jK, J(P), J(q), J(A), J(b), jx2, jz2,
                               cent_rhs, (J(xi), J(si), J(zi), J(tau), J(kappa)), F32,
                               is_combined=True)
    for g, ref in zip(got, jcent):
        ref = np.asarray(ref, np.float64)
        assert np.abs(g[0].double().numpy() - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())

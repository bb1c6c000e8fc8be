"""The exponential, power and generalized power cone functions of
clarabel_tpu_torch (``cones/nonsymmetric.py`` and the nonsymmetric branches
of ``cones/ops.py``) against the JAX package's, at f64 on the CPU, on
interior points drawn from a numpy seed: one problem ([k, 3]) and a batch
of B = 3 problems ([B, k, 3], B = k) held lane by lane to the JAX function
of that lane.

Tolerances, relative to the largest entry of the reference (at least 1):
- 1e-14 for ``wright_omega``: the same closed form and two refinement
  steps, a few roundings apart;
- 1e-12 for the gradients, Hessians, barriers, scalings, Hs products and
  the third-order corrections: the same arithmetic, with sums (3-vectors,
  per-cone segment sums) in other orders;
- 1e-12 also for the Newton-Raphson primal gradients (``pow_grad_primal``,
  ``_gp_gradient_primal``), which is tighter than the 1e-8 (√eps) their
  stopping test could allow if a rounding moved the stop by one step:
  measured here, every entry stops at the same step in both packages;
- step lengths exactly equal: both packages compare the same candidates,
  built by the same multiplications.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu import loop as jloop
from clarabel_tpu.cones import nonsymmetric as jns
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.statuses import SCALING_DUAL, SCALING_PRIMAL_DUAL
from clarabel_tpu_torch import convert, loop as tloop
from clarabel_tpu_torch.cones import nonsymmetric as tns
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.timers import host_read

CONES = [ct.NonnegativeConeT(2), ct.ExponentialConeT(), ct.SecondOrderConeT(3),
         ct.PowerConeT(0.3), ct.ExponentialConeT(), ct.PowerConeT(0.7),
         ct.GenPowerConeT([0.2, 0.3, 0.5], 2), ct.ExponentialConeT(),
         ct.GenPowerConeT([0.6, 0.4], 1), ct.PowerConeT(0.5)]
JL = JaxLayout(ct.cones.api.collapse_cones(CONES))
TL = TorchLayout(convert.cones_from_specs(convert.cone_specs(JL.cones)))
B = 3  # = the number of exp cones and of pow cones: a misplaced dimension fails
SETTINGS = ct.DefaultSettings(verbose=False)
TSETTINGS = tp.port_settings(SETTINGS)
ALPHA = np.array([0.3, 0.7, 0.5])


def _close(got, ref, rel=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * scale


def _t(v):
    return torch.tensor(np.asarray(v, np.float64))


# -----------------------------------------------------------------
# interior points
# -----------------------------------------------------------------


def exp_primal(rng, k):
    s1 = rng.uniform(0.5, 2.0, k)
    s0 = rng.normal(size=k)
    return np.stack([s0, s1, s1 * np.exp(s0 / s1) * rng.uniform(1.2, 3.0, k)], -1)


def exp_dual(rng, k):
    z0, z2 = -rng.uniform(0.5, 2.0, k), rng.uniform(0.5, 2.0, k)
    return np.stack([z0, z0 + z0 * np.log(-z2 / z0) + rng.uniform(0.2, 2.0, k), z2], -1)


def pow_point(rng, a, dual):
    u = rng.uniform(0.5, 2.0, (len(a), 2))
    w = (u[:, 0] / a) ** a * (u[:, 1] / (1 - a)) ** (1 - a) if dual else \
        u[:, 0] ** a * u[:, 1] ** (1 - a)
    return np.concatenate([u, (rng.uniform(-0.9, 0.9, len(a)) * w)[:, None]], -1)


def gp_point(rng, cone, dual):
    a = np.asarray(cone.alpha)
    u = rng.uniform(0.5, 2.0, len(a))
    bound = np.prod((u / a) ** a) if dual else np.prod(u ** a)
    w = rng.normal(size=cone.dim2)
    return np.concatenate([u, w / np.linalg.norm(w) * bound * rng.uniform(0.1, 0.9)])


def interior(rng, layout, dual):
    """A point strictly inside every cone of ``layout`` (primal or dual)."""
    v = np.zeros(layout.m)
    v[layout.slice_of(ct.cones.api.NONNEGATIVE)] = rng.uniform(0.5, 2.0, layout.n_nn)
    soc = layout.slice_of(ct.cones.api.SOC)
    tail = rng.normal(size=soc.stop - soc.start - 1)
    v[soc] = np.concatenate([[np.linalg.norm(tail) + 1.0], tail])
    v[layout.slice_of(ct.cones.api.EXP)] = (exp_dual if dual else exp_primal)(
        rng, layout.num_exp).ravel()
    v[layout.slice_of(ct.cones.api.POW)] = pow_point(rng, layout.pow_alpha, dual).ravel()
    v[layout.slice_of(ct.cones.api.GENPOW)] = np.concatenate(
        [gp_point(rng, c, dual) for c in layout.genpow_cones])
    return v


@pytest.fixture
def points():
    """B lanes of (s, z, ds, dz)."""
    rng = np.random.default_rng(17)
    lanes = [(interior(rng, JL, False), interior(rng, JL, True),
              rng.normal(size=JL.m), rng.normal(size=JL.m)) for _ in range(B)]
    return [np.stack(v) for v in zip(*lanes)]


# -----------------------------------------------------------------
# the [k, 3] functions
# -----------------------------------------------------------------


def test_wright_omega():
    z = np.concatenate([np.linspace(0.0, 1.0 + np.pi - 1e-9, 50),
                        np.linspace(1.0 + np.pi, 60.0, 50), [1e3, 1e6]])
    _close(tns.wright_omega(_t(z)), jns.wright_omega(jnp.asarray(z)), rel=1e-14)


@pytest.mark.parametrize("batched", [False, True], ids=["k", "Bk"])
def test_exp_functions(batched):
    rng = np.random.default_rng(3)
    shape = (B,) if batched else ()
    s = exp_primal(rng, B * B).reshape(shape + (-1, 3)) if batched else exp_primal(rng, 4)
    z = exp_dual(rng, s.shape[-2] * (B if batched else 1)).reshape(s.shape)
    ds, v = rng.normal(size=s.shape), rng.normal(size=s.shape)
    lanes = range(B) if batched else [()]
    for name, args in [("exp_grad_dual", (z,)), ("exp_hess_dual", (z,)),
                       ("exp_barrier_dual", (z,)), ("exp_barrier_primal", (s,)),
                       ("exp_grad_primal", (s,))]:
        got = getattr(tns, name)(*map(_t, args))
        for i in lanes:
            _close(got[i], getattr(jns, name)(*(jnp.asarray(a[i]) for a in args)))
    for i in lanes:
        Hd = jns.exp_hess_dual(jnp.asarray(z[i]))
        _close(tns.exp_higher_correction(_t(np.asarray(Hd)), _t(z[i]), _t(ds[i]), _t(v[i])),
               jns.exp_higher_correction(Hd, jnp.asarray(z[i]), jnp.asarray(ds[i]),
                                         jnp.asarray(v[i])))
        g = jns.exp_grad_dual(jnp.asarray(z[i]))
        _close(tns.pd_scaling_hs(_t(np.asarray(Hd)), _t(np.asarray(g)), tns.exp_grad_primal,
                                 _t(s[i]), _t(z[i])),
               jns.pd_scaling_hs(Hd, g, jns.exp_grad_primal, jnp.asarray(s[i]),
                                 jnp.asarray(z[i])))
    assert bool(tns.exp_is_primal_feasible(_t(s)).all())
    assert bool(tns.exp_is_dual_feasible(_t(z)).all())


def test_pow_functions():
    rng = np.random.default_rng(4)
    s, z = pow_point(rng, ALPHA, False), pow_point(rng, ALPHA, True)
    ds, v = rng.normal(size=s.shape), rng.normal(size=s.shape)
    a_t, a_j = _t(ALPHA), jnp.asarray(ALPHA)
    S, Z = _t(s), _t(z)
    js, jz = jnp.asarray(s), jnp.asarray(z)
    tg, tH = tns.pow_grad_dual_and_hess(a_t, Z)
    jg, jH = jns.pow_grad_dual_and_hess(a_j, jz)
    _close(tg, jg)
    _close(tH, jH)
    _close(tns.pow_barrier_dual(a_t, Z), jns.pow_barrier_dual(a_j, jz))
    _close(tns.pow_grad_primal(a_t, S), jns.pow_grad_primal(a_j, js))
    _close(tns.pow_barrier_primal(a_t, S), jns.pow_barrier_primal(a_j, js))
    _close(tns.pow_higher_correction(a_t, tH, Z, _t(ds), _t(v)),
           jns.pow_higher_correction(a_j, jH, jz, jnp.asarray(ds), jnp.asarray(v)))
    _close(tns.pd_scaling_hs(tH, tg, lambda x: tns.pow_grad_primal(a_t, x), S, Z),
           jns.pd_scaling_hs(jH, jg, lambda x: jns.pow_grad_primal(a_j, x), js, jz))
    # |s3| below eps takes the closed form, no Newton step
    s[1, 2] = 0.0
    _close(tns.pow_grad_primal(a_t, _t(s)), jns.pow_grad_primal(a_j, jnp.asarray(s)))


def test_solve3_flags_indefinite_blocks():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(4, 3, 3))
    H = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(3)
    H[3] = -H[3]
    b = rng.normal(size=(4, 3))
    u, ok = tns._solve3(_t(H), _t(b))
    ju, jok = jns._solve3(jnp.asarray(H), jnp.asarray(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True, True, True, False]
    _close(u, ju)


# -----------------------------------------------------------------
# the layout-level hooks, one problem and a batch
# -----------------------------------------------------------------


def _jax_state(s, z, mu, strategy):
    state, ok = jops.update_scaling(JL, jops.set_identity_scaling(JL, jnp.float64),
                                    jnp.asarray(s), jnp.asarray(z), mu, strategy)
    return state, bool(ok)


@pytest.mark.parametrize("strategy", [SCALING_PRIMAL_DUAL, SCALING_DUAL])
def test_update_scaling_and_products(points, strategy):
    s, z, ds, dz = points
    mu = (s * z).sum(-1) / (JL.degree + 1)
    tstate, tok = tops.update_scaling(
        TL, tops.set_identity_scaling(TL, torch.float64, "cpu", (B,)), _t(s), _t(z),
        _t(mu), torch.full((B,), strategy, dtype=torch.int32))
    H = tops.hs_dense(TL, tstate, torch.float64, "cpu", (B,))
    y = tops.mul_hs(TL, tstate, _t(dz))
    sigma_mu = _t(0.3 * mu)
    shift = tops.combined_ds_shift(TL, tstate, _t(dz), _t(ds), sigma_mu, _t(z))
    aff = tops.affine_ds(TL, tstate, _t(s))
    off = tops.ds_from_dz_offset(TL, tstate, _t(ds), _t(z))
    for i in range(B):
        jstate, jok = _jax_state(s[i], z[i], mu[i], strategy)
        assert bool(tok[i]) == jok
        for key in jstate:
            _close(tstate[key][i], jstate[key])
        jH, _ = jops.hs_dense(JL, jstate, jnp.float64)
        _close(H[i], jH)
        _close(y[i], jops.mul_hs(JL, jstate, jnp.asarray(dz[i])))
        _close(y[i], H[i] @ _t(dz[i]))
        _close(shift[i], jops.combined_ds_shift(JL, jstate, jnp.asarray(dz[i]),
                                                jnp.asarray(ds[i]), 0.3 * mu[i],
                                                jnp.asarray(z[i])))
        _close(aff[i], jops.affine_ds(JL, jstate, jnp.asarray(s[i])))
        _close(off[i], jops.ds_from_dz_offset(JL, jstate, jnp.asarray(ds[i]),
                                              jnp.asarray(z[i])))


def test_unit_initialization_and_barriers(points):
    s, z, ds, dz = points
    tz, ts = tops.unit_initialization(TL, torch.float64, "cpu", (B,))
    jz, js = jops.unit_initialization(JL, jnp.float64)
    for i in range(B):
        _close(tz[i], jz)
        _close(ts[i], js)
    alpha = np.array([0.0, 1e-3, 0.02])
    got = tops.compute_barrier(TL, {}, _t(z), _t(s), _t(dz), _t(ds), _t(alpha))
    for i in range(B):
        _close(got[i], jops.compute_barrier(JL, {}, jnp.asarray(z[i]), jnp.asarray(s[i]),
                                            jnp.asarray(dz[i]), jnp.asarray(ds[i]), alpha[i]))
    gp = JL.slice_of(ct.cones.api.GENPOW)
    _close(tns._gp_gradient_primal(TL, _t(s[:, gp])),
           np.stack([jns._gp_gradient_primal(JL, jnp.asarray(s[i, gp])) for i in range(B)]))


def test_step_length_per_lane(points):
    """Three lanes: one feasible at α_max, one that backtracks, one whose
    direction leaves the cones even at the least step (α = 0)."""
    s, z, ds, dz = points
    ds, dz = 0.01 * ds, 0.01 * dz
    ds[1] *= 300.0
    dz[2] = -1e7 * z[2]
    alpha_max = _t(np.array([1.0, 1.0, 0.7]))
    got = tops.step_length(TL, {}, _t(dz), _t(ds), _t(z), _t(s), TSETTINGS, alpha_max)
    want = [float(jops.step_length(JL, {}, jnp.asarray(dz[i]), jnp.asarray(ds[i]),
                                   jnp.asarray(z[i]), jnp.asarray(s[i]), SETTINGS,
                                   float(alpha_max[i]))) for i in range(B)]
    assert got.tolist() == want
    assert want[0] == 1.0 - np.sqrt(np.finfo(np.float64).eps)
    assert 0.0 < want[1] < want[0] and want[2] == 0.0


def test_barrier_backtracking_per_lane(points):
    """The dual-scaling barrier backtracking of the combined step
    (loop.calc_step_length) on a batch whose lanes run different
    strategies: lane 2, under dual scaling, backtracks; lane 0, under dual
    scaling too, needs no backtracking; lane 1, under primal-dual scaling,
    keeps its α.  The candidates take no device read of their own: the only
    reads are the Newton-Raphson checks of the power and generalized power
    cones' primal barriers, which run once over all candidates."""
    s, z, ds, dz = points
    rng = np.random.default_rng(9)
    dtau, dkappa = rng.normal(size=B) * 0.1, rng.normal(size=B) * 0.1
    tau, kappa = np.ones(B), np.ones(B)
    x = np.zeros((B, 2))
    scaling = np.array([SCALING_DUAL, SCALING_PRIMAL_DUAL, SCALING_DUAL])
    step = lambda: (_t(x), _t(ds), _t(dz), _t(dtau), _t(dkappa))
    variables = lambda: (_t(x), _t(s), _t(z), _t(tau), _t(kappa))
    host_read.count = 0
    got = tloop.calc_step_length(TL, {}, step(), variables(), TSETTINGS, True,
                                 torch.as_tensor(scaling))
    assert host_read.count <= 2 * 100 // tns.NR_CHECK_EVERY
    plain = tloop.calc_step_length(TL, {}, step(), variables(), TSETTINGS, True,
                                   torch.as_tensor(scaling), any_dual=False)
    for i in range(B):
        want = jloop.calc_step_length(
            JL, {}, tuple(jnp.asarray(v) for v in (x[i], ds[i], dz[i], dtau[i], dkappa[i])),
            tuple(jnp.asarray(v) for v in (x[i], s[i], z[i], tau[i], kappa[i])),
            SETTINGS, True, scaling[i])
        assert float(got[i]) == float(want)
    assert float(got[0]) == float(plain[0]) and float(got[1]) == float(plain[1])
    assert float(got[2]) < float(plain[2])


def test_newton_raphson_reads_every_few_steps():
    """The Newton-Raphson loop reads whether it is done once per
    NR_CHECK_EVERY steps, and its result does not depend on how often."""
    rng = np.random.default_rng(6)
    s = _t(pow_point(rng, np.full(8, 0.4), False))
    a = _t(np.full(8, 0.4))
    host_read.count = 0
    g = tns.pow_grad_primal(a, s)
    reads = host_read.count
    assert 1 <= reads <= 100 // tns.NR_CHECK_EVERY
    every = tns.NR_CHECK_EVERY
    try:
        tns.NR_CHECK_EVERY = 1
        host_read.count = 0
        g1 = tns.pow_grad_primal(a, s)
        assert host_read.count >= reads
    finally:
        tns.NR_CHECK_EVERY = every
    assert torch.equal(g, g1)

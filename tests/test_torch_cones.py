"""The zero, nonnegative and second-order cone operations and the Ruiz
equilibration of clarabel_tpu_torch against the JAX package, at f64 on the
CPU, on a mixed cone layout with random interior points made from a numpy
seed.  Tolerance 1e-12 relative to the largest entry of the reference (at
least 1): both packages do the same arithmetic, summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (pins torch's threads)
import clarabel_tpu as ct
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu import equilibration as jeq
from clarabel_tpu_torch import convert
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch import equilibration as teq

CONES = [ct.ZeroConeT(2), ct.NonnegativeConeT(3), ct.SecondOrderConeT(4),
         ct.SecondOrderConeT(3), ct.NonnegativeConeT(2), ct.SecondOrderConeT(5)]
JL = JaxLayout(ct.cones.api.collapse_cones(CONES))
TL = TorchLayout(convert.cones_from_specs(convert.cone_specs(JL.cones)))
SETTINGS = ct.DefaultSettings(verbose=False)


def _interior(rng, layout):
    """A point strictly inside every cone (zero-cone rows arbitrary)."""
    v = rng.normal(size=layout.m)
    nn = layout.slice_of(ct.cones.api.NONNEGATIVE)
    v[nn] = rng.uniform(0.5, 2.0, size=nn.stop - nn.start)
    soc = layout.slice_of(ct.cones.api.SOC)
    pos = soc.start
    for d in layout.soc_dims:
        tail = v[pos + 1:pos + d]
        v[pos] = np.linalg.norm(tail) + rng.uniform(0.5, 2.0)
        pos += d
    return v


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert np.max(np.abs(got - ref), initial=0.0) <= 1e-12 * scale


@pytest.fixture
def points():
    rng = np.random.default_rng(11)
    s, z = _interior(rng, JL), _interior(rng, JL)
    ds, dz = rng.normal(size=JL.m), rng.normal(size=JL.m)
    return s, z, ds, dz


def _scalings(s, z):
    mu = float(s @ z / (JL.degree + 1))
    jstate, jok = jops.update_scaling(
        JL, jops.set_identity_scaling(JL, jnp.float64), jnp.asarray(s),
        jnp.asarray(z), mu, 0,
    )
    tstate, tok = tops.update_scaling(
        TL, tops.set_identity_scaling(TL, torch.float64, "cpu"),
        torch.as_tensor(s), torch.as_tensor(z), mu, 0,
    )
    return jstate, bool(jok), tstate, bool(tok)


def test_initialization_and_identity_scaling():
    jz, js = jops.unit_initialization(JL, jnp.float64)
    tz, ts = tops.unit_initialization(TL, torch.float64, "cpu")
    _close(tz, jz)
    _close(ts, js)
    jid = jops.set_identity_scaling(JL, jnp.float64)
    tid = tops.set_identity_scaling(TL, torch.float64, "cpu")
    assert set(jid) == set(tid)
    for k in jid:
        _close(tid[k], jid[k])


def test_update_scaling(points):
    s, z, _, _ = points
    jstate, jok, tstate, tok = _scalings(s, z)
    assert jok and tok
    assert set(jstate) == set(tstate)
    for k in jstate:
        _close(tstate[k], jstate[k])


def test_hs_products_and_shifts(points):
    s, z, ds, dz = points
    jstate, _, tstate, _ = _scalings(s, z)
    H, _ = jops.hs_dense(JL, jstate, jnp.float64)
    _close(tops.hs_dense(TL, tstate, torch.float64, "cpu"), H)
    _close(tops.mul_hs(TL, tstate, torch.as_tensor(dz)),
           jops.mul_hs(JL, jstate, jnp.asarray(dz)))
    _close(tops.affine_ds(TL, tstate, torch.as_tensor(s)),
           jops.affine_ds(JL, jstate, jnp.asarray(s)))
    sigma_mu = 0.3
    _close(
        tops.combined_ds_shift(TL, tstate, torch.as_tensor(dz), torch.as_tensor(ds),
                               torch.tensor(sigma_mu, dtype=torch.float64), torch.as_tensor(z)),
        jops.combined_ds_shift(JL, jstate, jnp.asarray(dz), jnp.asarray(ds),
                               sigma_mu, jnp.asarray(z)),
    )
    _close(tops.ds_from_dz_offset(TL, tstate, torch.as_tensor(ds), torch.as_tensor(z)),
           jops.ds_from_dz_offset(JL, jstate, jnp.asarray(ds), jnp.asarray(z)))


def test_step_length_barrier_and_margins(points):
    s, z, ds, dz = points
    jstate, _, tstate, _ = _scalings(s, z)
    T = lambda v: torch.as_tensor(v)
    J = jnp.asarray
    for scale in (0.1, 10.0):
        _close(
            tops.step_length(TL, tstate, T(scale * dz), T(scale * ds), T(z), T(s),
                             SETTINGS, torch.tensor(1.0, dtype=torch.float64)),
            jops.step_length(JL, jstate, J(scale * dz), J(scale * ds), J(z), J(s),
                             SETTINGS, 1.0),
        )
    alpha = 0.05
    _close(
        tops.compute_barrier(TL, tstate, T(z), T(s), T(dz), T(ds),
                             torch.tensor(alpha, dtype=torch.float64)),
        jops.compute_barrier(JL, jstate, J(z), J(s), J(dz), J(ds), alpha),
    )
    for pd in (tops.PRIMAL, tops.DUAL):
        v = s - 1.5  # some margins negative
        jm, jt = jops.margins(JL, J(v), pd)
        tm, tt = tops.margins(TL, T(v), pd)
        _close(tm, jm)
        _close(tt, jt)
        shift = torch.tensor(0.7, dtype=torch.float64)
        _close(tops.scaled_unit_shift(TL, T(v), shift, pd),
               jops.scaled_unit_shift(JL, J(v), 0.7, pd))


def test_equilibrate():
    rng = np.random.default_rng(5)
    n, m = 6, JL.m
    M = rng.normal(size=(n, n)) * np.exp(rng.normal(size=(n, 1)))
    P = M @ M.T
    A = rng.normal(size=(m, n)) * np.exp(2 * rng.normal(size=(m, 1)))
    q, b = 10.0 * rng.normal(size=n), rng.normal(size=m)
    triu = np.triu(np.ones((n, n)))
    ref = jeq.equilibrate(JL, SETTINGS, *(jnp.asarray(v) for v in (P, q, A, b)),
                          triu)
    got = teq.equilibrate(TL, SETTINGS, *(torch.as_tensor(v) for v in (P, q, A, b)),
                          torch.as_tensor(triu))
    for g, r in zip(got, ref):
        _close(g, r)
    delta_ref, changed_ref = jops.rectify_equilibration(JL, jnp.asarray(b))
    delta, changed = tops.rectify_equilibration(TL, torch.as_tensor(b))
    assert changed == changed_ref
    _close(delta, delta_ref)

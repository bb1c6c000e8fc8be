"""The PSD triangle cone functions of clarabel_tpu_torch (``cones/psd.py``
and the PSD branches of ``cones/ops.py``) against the JAX package's, at f64
on the CPU, on a layout of two buckets (n = 3, two cones; n = 5, one cone)
beside a nonnegative and a second-order cone, at interior points drawn
from a numpy seed: one problem ([k, n, n]) and a batch of B = 3 problems
([B, k, n, n]) held lane by lane to the JAX function of that lane.

Tolerance 1e-12 relative to the largest entry of the reference (at least
1): the same arithmetic, with matrix products and sums in other orders.

An SVD's singular vectors are defined only up to sign, so the R and R⁻¹
of ``update_scaling`` are compared through what does not depend on the
choice -- RRᵀ, R⁻ᵀR⁻¹, λ, Hs, Hs·x and the step lengths -- and R itself
column by column up to sign.  The functions that take a scaling state are
given the JAX package's own state, so they compare entry for entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones import psd as jpsd
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
import clarabel_tpu_torch as tt
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones import psd as tpsd
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout

CONES = [ct.NonnegativeConeT(2), ct.PSDTriangleConeT(3), ct.SecondOrderConeT(3),
         ct.PSDTriangleConeT(5), ct.PSDTriangleConeT(3)]
JL = JaxLayout(ct.cones.api.collapse_cones(CONES))
TL = TorchLayout(tp.port_cones(JL.cones))
B = 3  # = the number of PSD cones: a misplaced dimension fails
SETTINGS = ct.DefaultSettings(verbose=False)
TSETTINGS = tp.port_settings(SETTINGS)
SQRT2 = np.sqrt(2.0)


def _close(got, ref, rel=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * scale


def _t(v):
    return torch.tensor(np.asarray(v, np.float64))


def _svec(M):
    n = M.shape[-1]
    return np.array([M[i, j] * (1.0 if i == j else SQRT2)
                     for j in range(n) for i in range(j + 1)])


def _spd(rng, n, lo=0.5, hi=2.0):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * rng.uniform(lo, hi, n)) @ Q.T


def interior(rng, layout):
    """A point strictly inside every cone of ``layout``."""
    v = np.zeros(layout.m)
    nn = layout.slice_of(ct.cones.api.NONNEGATIVE)
    v[nn] = rng.uniform(0.5, 2.0, nn.stop - nn.start)
    soc = layout.slice_of(ct.cones.api.SOC)
    tail = rng.normal(size=soc.stop - soc.start - 1)
    v[soc] = np.concatenate([[np.linalg.norm(tail) + 1.0], tail])
    v[layout.slice_of(ct.cones.api.PSD)] = np.concatenate(
        [_svec(_spd(rng, d)) for d in layout.psd_dims])
    return v


@pytest.fixture
def points():
    """B lanes of (s, z, ds, dz)."""
    rng = np.random.default_rng(23)
    lanes = [(interior(rng, JL), interior(rng, JL), rng.normal(size=JL.m),
              rng.normal(size=JL.m)) for _ in range(B)]
    return [np.stack(v) for v in zip(*lanes)]


def _jax_state(s, z):
    state, ok = jops.update_scaling(JL, jops.set_identity_scaling(JL, jnp.float64),
                                    jnp.asarray(s), jnp.asarray(z), 1.0, 0)
    assert bool(ok)
    return state


def _port_state(states):
    """The JAX states of each lane as one port state ([B, ...] tensors)."""
    return {k: _t(np.stack([np.asarray(st[k]) for st in states])) for k in states[0]}


def _lanes(batched):
    return list(range(B)) if batched else [0]


def _pick(v, batched):
    """The port's input: all lanes, or lane 0 alone."""
    return _t(v if batched else v[0])


def _lane(got, i, batched):
    return got[i] if batched else got


# -----------------------------------------------------------------
# svec packing and the layout's buckets
# -----------------------------------------------------------------


def test_buckets_and_svec_packing():
    assert [(b.n, b.count) for b in TL.psd_buckets] == [(b.n, b.count) for b in JL.psd_buckets]
    rng = np.random.default_rng(1)
    for tb, jb, t in zip(TL.psd_buckets, JL.psd_buckets, TL.psd_tensors(torch.float64, "cpu")):
        np.testing.assert_array_equal(tb.gather, jb.gather)
        np.testing.assert_array_equal(tb.I, jb.I)
        np.testing.assert_array_equal(tb.J, jb.J)
        x = rng.normal(size=(B, jb.count, jb.tri))
        M = rng.normal(size=(B, jb.count, jb.n, jb.n))
        for i in range(B):
            # bitwise: the same products, placed differently
            np.testing.assert_array_equal(tpsd._to_mat(t, _t(x))[i].numpy(),
                                          np.asarray(jpsd._to_mat(jb, jnp.asarray(x[i]))))
            np.testing.assert_array_equal(tpsd._to_svec(t, _t(M))[i].numpy(),
                                          np.asarray(jpsd._to_svec(jb, jnp.asarray(M[i]))))
            A = M[i] @ np.swapaxes(M[i], -1, -2)
            np.testing.assert_array_equal(tpsd._skron(t, _t(A)).numpy(),
                                          np.asarray(jpsd._skron(jb, jnp.asarray(A))))
    # the widest rectified cone sets the equilibration's padded segments
    widest = max(c.nvars for c in TL.cones if c.kind != ct.cones.api.NONNEGATIVE)
    assert TL.rect_pad_idx.shape[1] == widest


def test_initialization_and_identity_scaling():
    z, s = tops.unit_initialization(TL, torch.float64, "cpu", (B,))
    jz, js = jops.unit_initialization(JL, jnp.float64)
    for i in range(B):
        np.testing.assert_array_equal(z[i].numpy(), np.asarray(jz))
        np.testing.assert_array_equal(s[i].numpy(), np.asarray(js))
    state = tops.set_identity_scaling(TL, torch.float64, "cpu", (B,))
    jstate = jops.set_identity_scaling(JL, jnp.float64)
    assert sorted(state) == sorted(jstate)
    for k, v in jstate.items():
        for i in range(B):
            np.testing.assert_array_equal(state[k][i].numpy(), np.asarray(v))
    # the identity scaling's Hs: the identity up to the rounding of
    # (1/√2)², in both packages
    H = tops.hs_dense(TL, state, torch.float64, "cpu", (B,))
    jH, _ = jops.hs_dense(JL, jstate, jnp.float64)
    for i in range(B):
        np.testing.assert_array_equal(H[i].numpy(), np.asarray(jH))
    _close(H[0], np.eye(TL.m), rel=1e-15)


# -----------------------------------------------------------------
# scaling and the Hs products
# -----------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True], ids=["k", "Bk"])
def test_update_scaling_invariants(points, batched):
    s, z, _, dz = points
    state, ok = tops.update_scaling(TL, tops.set_identity_scaling(TL, torch.float64, "cpu"),
                                    _pick(s, batched), _pick(z, batched), None, None)
    assert ok.shape == ((B,) if batched else ())
    assert bool(ok.all())
    H = tops.hs_dense(TL, state, torch.float64, "cpu", (B,) if batched else ())
    y = tops.mul_hs(TL, state, _pick(dz, batched))
    for i in _lanes(batched):
        js = _jax_state(s[i], z[i])
        for bi in range(len(JL.psd_buckets)):
            R, Rinv = (_lane(state[f"psd{bi}_{k}"], i, batched).numpy() for k in ("R", "Rinv"))
            jR, jRinv = (np.asarray(js[f"psd{bi}_{k}"]) for k in ("R", "Rinv"))
            _close(R @ np.swapaxes(R, -1, -2), jR @ np.swapaxes(jR, -1, -2))
            _close(np.swapaxes(Rinv, -1, -2) @ Rinv, np.swapaxes(jRinv, -1, -2) @ jRinv)
            _close(_lane(state[f"psd{bi}_lam"], i, batched), js[f"psd{bi}_lam"])
            # R column by column, up to the SVD's sign choice
            sign = np.sign(np.sum(R * jR, axis=-2, keepdims=True))
            _close(R * sign, jR)
            _close(Rinv * np.swapaxes(sign, -1, -2), jRinv)
        jH, _ = jops.hs_dense(JL, js, jnp.float64)
        _close(_lane(H, i, batched), jH)
        _close(_lane(y, i, batched), jops.mul_hs(JL, js, jnp.asarray(dz[i])))


def test_update_scaling_flags_a_point_outside_the_cone(points):
    """A lane whose s is not positive definite reads as a scaling failure;
    the other lanes keep theirs, unchanged."""
    s, z, _, _ = points
    s = s.copy()
    row = JL.slice_of(ct.cones.api.PSD).start + JL.psd_buckets[1].gather[0, 0]
    s[1, row] = -1.0  # the n = 5 cone's first diagonal entry
    state, ok = tops.update_scaling(TL, tops.set_identity_scaling(TL, torch.float64, "cpu"),
                                    _t(s), _t(z), None, None)
    assert ok.tolist() == [True, False, True]
    jstate, jok = jops.update_scaling(JL, jops.set_identity_scaling(JL, jnp.float64),
                                      jnp.asarray(s[1]), jnp.asarray(z[1]), 1.0, 0)
    assert not bool(jok)
    for k, v in jstate.items():
        # NaN exactly where the JAX package's factors are NaN
        np.testing.assert_array_equal(np.isnan(state[k][1].numpy()), np.isnan(np.asarray(v)))
    full, ok0 = tops.update_scaling(TL, tops.set_identity_scaling(TL, torch.float64, "cpu"),
                                    _t(points[0]), _t(z), None, None)
    for k in state:
        np.testing.assert_array_equal(state[k][[0, 2]].numpy(), full[k][[0, 2]].numpy())


@pytest.mark.parametrize("batched", [False, True], ids=["k", "Bk"])
def test_products_and_shifts_on_one_state(points, batched):
    """The functions of a scaling state, given the JAX package's state."""
    s, z, ds, dz = points
    lanes = _lanes(batched)
    jstates = [_jax_state(s[i], z[i]) for i in lanes]
    state = _port_state(jstates)
    if not batched:
        state = {k: v[0] for k, v in state.items()}
    sigma_mu = np.array([0.3, 0.1, 0.7])
    sm = _t(sigma_mu if batched else sigma_mu[0])
    got = {
        "mul_hs": tops.mul_hs(TL, state, _pick(dz, batched)),
        "affine_ds": tops.affine_ds(TL, state, _pick(s, batched)),
        "shift": tops.combined_ds_shift(TL, state, _pick(dz, batched), _pick(ds, batched),
                                        sm, _pick(z, batched)),
        "offset": tops.ds_from_dz_offset(TL, state, _pick(ds, batched), _pick(z, batched)),
        "hs": tops.hs_dense(TL, state, torch.float64, "cpu", (B,) if batched else ()),
    }
    for i, js in zip(lanes, jstates):
        J = lambda v: jnp.asarray(v[i])
        _close(_lane(got["mul_hs"], i, batched), jops.mul_hs(JL, js, J(dz)))
        _close(_lane(got["affine_ds"], i, batched), jops.affine_ds(JL, js, J(s)))
        _close(_lane(got["shift"], i, batched),
               jops.combined_ds_shift(JL, js, J(dz), J(ds), sigma_mu[i], J(z)))
        _close(_lane(got["offset"], i, batched), jops.ds_from_dz_offset(JL, js, J(ds), J(z)))
        _close(_lane(got["hs"], i, batched), jops.hs_dense(JL, js, jnp.float64)[0])
        # the W-products on one bucket, both forms
        bt = TL.psd_tensors(torch.float64, "cpu")[0]
        jb = JL.psd_buckets[0]
        x = dz[i][JL.slice_of(ct.cones.api.PSD)][jb.gather]
        for transpose in (False, True):
            R = state["psd0_R"][i] if batched else state["psd0_R"]
            _close(tpsd._mul_w(bt, R, _t(x), transpose),
                   jpsd._mul_w(jb, js["psd0_R"], jnp.asarray(x), transpose))


# -----------------------------------------------------------------
# step lengths, barriers and margins
# -----------------------------------------------------------------


def test_step_length_per_lane(points):
    """Each lane's step to the PSD boundary, from the JAX state and from
    the port's own (the eigenvalues do not depend on the SVD's signs)."""
    s, z, ds, dz = points
    dz = dz * np.array([[1.0], [5.0], [0.01]])  # one lane far, one near
    ds = ds * np.array([[1.0], [5.0], [0.01]])
    jstates = [_jax_state(s[i], z[i]) for i in range(B)]
    own, _ = tops.update_scaling(TL, tops.set_identity_scaling(TL, torch.float64, "cpu"),
                                 _t(s), _t(z), None, None)
    alpha_max = _t([1.0, 1.0, 1.0])
    got = [tops.step_length(TL, st, _t(dz), _t(ds), _t(z), _t(s), TSETTINGS, alpha_max)
           for st in (_port_state(jstates), own)]
    for i in range(B):
        ref = jops.step_length(JL, jstates[i], jnp.asarray(dz[i]), jnp.asarray(ds[i]),
                               jnp.asarray(z[i]), jnp.asarray(s[i]), SETTINGS, 1.0)
        for g in got:
            _close(g[i], ref)
    assert float(got[0][2]) == 1.0 and float(got[0][1]) < 1.0


def test_step_length_skips_an_empty_cone(points):
    """A PSD cone of dimension 0 has no rows and limits no step (the JAX
    package's step length has no empty bucket to compare: it is held to
    the same layout without the empty cone)."""
    s, z, ds, dz = points
    cones = tp.port_cones(JL.cones)
    with_empty = TorchLayout(cones[:2] + (tt.PSDTriangleConeT(0),) + cones[2:])
    assert with_empty.m == TL.m and len(with_empty.psd_buckets) == len(TL.psd_buckets) + 1
    state, _ = tops.update_scaling(with_empty,
                                   tops.set_identity_scaling(with_empty, torch.float64, "cpu"),
                                   _t(s), _t(z), None, None)
    alpha = tops.step_length(with_empty, state, _t(dz), _t(ds), _t(z), _t(s), TSETTINGS,
                             _t([1.0] * B))
    for i in range(B):
        _close(alpha[i], jops.step_length(JL, _jax_state(s[i], z[i]), jnp.asarray(dz[i]),
                                          jnp.asarray(ds[i]), jnp.asarray(z[i]),
                                          jnp.asarray(s[i]), SETTINGS, 1.0))


def test_barrier_over_candidates(points):
    """The barrier at several candidate step lengths at once, as the
    backtracking line search evaluates it ([B, J] from rows [B, 1, m]):
    finite inside the cone, inf where a candidate leaves it (a Cholesky
    that breaks down), and with an empty cone in the JAX package's layout."""
    s, z, ds, dz = points
    a = np.array([[0.0, 0.1, 0.5], [0.05, 0.2, 50.0], [0.3, 1e3, 0.01]])
    row = lambda v: _t(v).unsqueeze(-2)
    got = tpsd.compute_barrier(TL, row(z), row(s), row(dz), row(ds), _t(a).unsqueeze(-1))
    with_empty = JaxLayout(JL.cones + (ct.PSDTriangleConeT(0),))
    for i in range(B):
        for j in range(a.shape[1]):
            ref = jpsd.compute_barrier(JL, *(jnp.asarray(v[i]) for v in (z, s, dz, ds)), a[i, j])
            if np.isinf(ref):
                assert float(got[i, j]) == np.inf
            else:
                _close(got[i, j], ref)
    assert np.isinf(got.numpy()).sum() >= 2 and np.isfinite(got.numpy()).sum() >= 5
    # the composite barrier over every cone, one lane, with the empty cone
    ref = jops.compute_barrier(with_empty, None, *(jnp.asarray(v[0]) for v in (z, s, dz, ds)),
                               0.1)
    tl_empty = TorchLayout(tp.port_cones(with_empty.cones))
    _close(tops.compute_barrier(tl_empty, None, *(_t(v[0]) for v in (z, s, dz, ds)),
                                _t(0.1)), ref)


@pytest.mark.parametrize("pd", [0, 1], ids=["primal", "dual"])
def test_margins_and_unit_shift(points, pd):
    s, z, _, _ = points
    v = s - 1.5 * z  # some lanes leave the cone
    mn, total = tops.margins(TL, _t(v), pd)
    shifted = tops.scaled_unit_shift(TL, _t(v), _t([0.5, 1.0, 2.0]), pd)
    for i in range(B):
        jmn, jtotal = jops.margins(JL, jnp.asarray(v[i]), pd)
        _close(mn[i], jmn)
        _close(total[i], jtotal)
        _close(shifted[i], jops.scaled_unit_shift(JL, jnp.asarray(v[i]), [0.5, 1.0, 2.0][i], pd))

"""The double-float arithmetic of clarabel_tpu_torch (``kkt/compensated.py``
and ``cones.ops.mul_hs_df``) against the JAX package's, at f32 on the CPU,
on inputs made from a numpy seed.

Tolerances:
- the error-free transforms (``_two_prod``, ``_two_sum``), the compensated
  reduction tree (``_df_reduce_last``) and ``residual`` are bitwise equal
  to the JAX package's: both packages round every operation on its own, in
  the same order, and pair the same entries level by level;
- ``mul_hs_df``'s nonnegative slice is an exact TwoProd, bitwise equal too;
  on the SOC and exponential slices both packages round the plain product
  Hs·x, summed in other orders: hi within 4 f32 ulps of the largest entry
  (4·2⁻²³ relative) and lo within the same of its own largest entry.
A batch of problems equals each problem alone, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.kkt import compensated as jdfc
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import compensated as tdfc

ULP4 = 4 * 2.0**-23


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _equal(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("fn", ["_two_prod", "_two_sum"])
def test_error_free_transforms_bitwise(fn):
    rng = np.random.default_rng(0)
    a = _f32(rng, 4, 128, scale=1e3) * np.geomspace(1e-6, 1e6, 128).astype(np.float32)
    b = _f32(rng, 4, 128)
    ref = jax.jit(getattr(jdfc, fn))(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tdfc, fn)(torch.as_tensor(a), torch.as_tensor(b))
    for g, r in zip(got, ref):
        _equal(g, r)
    # and error-free: the pair holds the exact result
    exact = (a.astype(np.float64) * b if fn == "_two_prod" else a.astype(np.float64) + b)
    assert np.array_equal(got[0].double().numpy() + got[1].double().numpy(), exact)


@pytest.mark.parametrize("n", [1, 7, 13, 64])
def test_df_reduce_last_bitwise(n):
    """Odd lengths pad with a zero, entry 2i pairs with 2i + 1; over a
    leading batch dimension each row reduces as it does alone."""
    rng = np.random.default_rng(n)
    hi = _f32(rng, 3, n) * np.geomspace(1.0, 1e7, n).astype(np.float32)
    lo = _f32(rng, 3, n, scale=1e-8)
    got = tdfc._df_reduce_last(torch.as_tensor(hi), torch.as_tensor(lo))
    for i in range(3):
        ref = jdfc._df_reduce_last(jnp.asarray(hi[i]), jnp.asarray(lo[i]))
        for g, r in zip(got, ref):
            _equal(g[i], r)


@pytest.mark.parametrize("case", ["vector", "multi-rhs", "batch", "batch multi-rhs"])
def test_residual_bitwise(case):
    rng = np.random.default_rng(3)
    N = 23
    K = _f32(rng, N, N) * np.geomspace(1, 1e6, N).astype(np.float32)
    shape = (N, 2) if "multi-rhs" in case else (N,)
    x, rhs = _f32(rng, *shape), _f32(rng, *shape)
    ref = jax.jit(jdfc.residual)(jnp.asarray(K), jnp.asarray(x), jnp.asarray(rhs))
    t = torch.as_tensor
    if case.startswith("batch"):
        # [2, N, N] with the problem in lane 1: it computes what it does alone
        Kb, xb, rb = (np.stack([_f32(rng, *v.shape), v]) for v in (K, x, rhs))
        got = tdfc.residual(t(Kb), t(xb), t(rb))[1]
    else:
        got = tdfc.residual(t(K), t(x), t(rhs))
    _equal(got, ref)
    # ~eps² accurate: the f64 residual within one rounding of the output
    true = rhs - K.astype(np.float64) @ x.astype(np.float64)
    assert np.all(np.abs(got.double().numpy() - true) <= 1.5e-7 * np.abs(true) + 1e-30
                  + 1e-12 * np.abs(true).max())


LAYOUTS = {
    "nn": [ct.NonnegativeConeT(5)],
    "soc": [ct.ZeroConeT(1), ct.NonnegativeConeT(2), ct.SecondOrderConeT(4)],
    "exp": [ct.NonnegativeConeT(2), ct.ExponentialConeT(), ct.ExponentialConeT()],
}


def _interior(rng, layout):
    """A point strictly inside every cone (the zero cone's rows arbitrary)."""
    v = rng.normal(size=layout.m)
    for kind, lo, hi in ((ct.cones.api.NONNEGATIVE, 0.5, 2.0),):
        sl = layout.slice_of(kind)
        v[sl] = rng.uniform(lo, hi, size=sl.stop - sl.start)
    soc = layout.slice_of(ct.cones.api.SOC)
    pos = soc.start
    for d in layout.soc_dims:
        v[pos] = np.linalg.norm(v[pos + 1:pos + d]) + rng.uniform(0.5, 2.0)
        pos += d
    ex = layout.slice_of(ct.cones.api.EXP)
    for c in range(ex.start, ex.stop, 3):
        # (x, y, z) with y > 0 and z > y·exp(x/y)
        v[c:c + 3] = [-0.5, 1.0, np.exp(-0.5) + rng.uniform(0.5, 1.5)]
    return v


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_mul_hs_df(name):
    """y = Hs (x + x_lo) as a (hi, lo) pair, on a scaling the JAX package
    computes at f32 from interior points, one problem and a batch of two."""
    jl = JaxLayout(ct.cones.api.collapse_cones(LAYOUTS[name]))
    tl = TorchLayout(tp.port_cones(jl.cones))
    rng = np.random.default_rng(5)
    s, z = _interior(rng, jl).astype(np.float32), _interior(rng, jl).astype(np.float32)
    mu = float(s.astype(np.float64) @ z / (jl.degree + 1))
    jstate, ok = jops.update_scaling(jl, jops.set_identity_scaling(jl, jnp.float32),
                                     jnp.asarray(s), jnp.asarray(z), np.float32(mu), 0)
    assert bool(ok)
    x = _f32(rng, jl.m, scale=1e3)
    x_lo = _f32(rng, jl.m, scale=1e-5)
    rh, rl = jops.mul_hs_df(jl, jstate, jnp.asarray(x), jnp.asarray(x_lo))
    rh, rl = np.asarray(rh), np.asarray(rl)

    state = {k: torch.as_tensor(np.array(v)) for k, v in jstate.items()}
    hi, lo = tops.mul_hs_df(tl, state, torch.as_tensor(x), torch.as_tensor(x_lo))
    nn = jl.slice_of(ct.cones.api.NONNEGATIVE)
    np.testing.assert_array_equal(hi.numpy()[nn], rh[nn])
    np.testing.assert_array_equal(lo.numpy()[nn], rl[nn])
    assert np.abs(hi.numpy() - rh).max() <= ULP4 * np.abs(rh).max()
    assert np.abs(lo.numpy() - rl).max() <= ULP4 * max(np.abs(rl).max(), np.abs(rh).max() * 2**-24)

    # a batch of two, the problem in lane 1
    bstate = {k: torch.stack([v, v]) for k, v in state.items()}
    xb = torch.stack([torch.zeros(jl.m), torch.as_tensor(x)])
    xlb = torch.stack([torch.zeros(jl.m), torch.as_tensor(x_lo)])
    bh, bl = tops.mul_hs_df(tl, bstate, xb, xlb)
    assert torch.equal(bh[1], hi) and torch.equal(bl[1], lo)


def test_mul_hs_df_psd():
    """PSD cones (this raised until the double-float PSD scaling was
    ported): y = Hs (x + x_lo) through the double-float congruence of a
    PSD(3) and a PSD(2) beside a nonnegative cone, on a scaling the JAX
    package computes at f32, bit for bit the JAX package's (tests/
    test_torch_f32_psd.py holds the stashed skron blocks and the larger
    buckets)."""
    jl = JaxLayout(ct.cones.api.collapse_cones(
        [ct.NonnegativeConeT(2), ct.PSDTriangleConeT(3), ct.PSDTriangleConeT(2)]))
    tl = TorchLayout(tp.port_cones(jl.cones))
    rng = np.random.default_rng(11)

    def interior():
        v = np.concatenate([rng.uniform(0.5, 2.0, 2), np.zeros(jl.m - 2)])
        pos = 2
        for c in jl.cones[1:]:
            Q, _ = np.linalg.qr(rng.normal(size=(c.dim, c.dim)))
            M = Q @ np.diag(np.geomspace(1e-3, 1.0, c.dim)) @ Q.T
            v[pos:pos + c.nvars] = [M[i, j] * (1.0 if i == j else np.sqrt(2.0))
                                    for j in range(c.dim) for i in range(j + 1)]
            pos += c.nvars
        return v.astype(np.float32)

    s, z = interior(), interior()
    jstate, ok = jops.update_scaling(jl, jops.set_identity_scaling(jl, jnp.float32),
                                     jnp.asarray(s), jnp.asarray(z), np.float32(1.0), 0)
    assert bool(ok)
    x, x_lo = _f32(rng, jl.m, scale=1e3), _f32(rng, jl.m, scale=1e-5)
    ref = jops.mul_hs_df(jl, jstate, jnp.asarray(x), jnp.asarray(x_lo))
    state = {k: torch.as_tensor(np.array(v)) for k, v in jstate.items()}
    got = tops.mul_hs_df(tl, state, torch.as_tensor(x), torch.as_tensor(x_lo))
    for g, r in zip(got, ref):
        _equal(g, r)

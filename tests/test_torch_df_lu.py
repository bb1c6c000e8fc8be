"""The double-float LU of clarabel_tpu_torch (``kkt/df_ldl.py``, the plain
versions the CPU runs) and the f32 factorizations of ``kkt/dense.py``
against the JAX package's, at f32 on the CPU, on tests/test_df_lu.py's
split-scale quasidefinite matrices (n + m ≤ 40) made from a numpy seed.

Tolerances:
- the scaled factor's hi parts, the permutation and the scaling are bitwise
  equal to the JAX package's: the same operations in the same order;
- its lo parts within 2⁻⁴⁰ of the largest hi entry: XLA:CPU contracts a
  product into the lo-stream sums of the jitted column loop (an FMA, in
  ``_df_div``'s remainder), the port rounds every operation;
- the solve within 4 f32 ulps of the largest entry: the one rounding of
  (xh + xl)·s at the end, on lo parts that differ as above;
- the forward error under 1e-6 and 50x better than the f32 pivoted LU's,
  as tests/test_df_lu.py asserts it;
- ``factor_jacobi``: the scaling d = 1/√|diag| within one f32 ulp (XLA
  may compute it as one reciprocal square root); the two packages' LAPACK
  LUs of the scaled matrix, and the solves through them, within 1e-5 of
  the largest entry (f32 rounding in another elimination order).
A batch of matrices factors and solves as each matrix alone, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (pins torch's threads)
import clarabel_tpu as ct
import test_torch_f32_dense as f32d
from clarabel_tpu.kkt import dense as jdense
from clarabel_tpu.kkt import df_ldl as jdf
from clarabel_tpu_torch.kkt import dense as tdense
from clarabel_tpu_torch.kkt import df_ldl as tdf
from test_df_lu import _quasidef

ULP4 = 4 * 2.0**-23


def _split(K):
    hi = K.astype(np.float32)
    return hi, (K - hi.astype(np.float64)).astype(np.float32)


def _zero_pivot(N=6):
    """A quasidefinite matrix with row and column 2 zero: that column stays
    zero, so every candidate of its pivot ties at 0 and the pivot becomes
    delta."""
    K = _quasidef(2, N - 2, 1.0, seed=4)
    K[2, :] = K[:, 2] = 0.0
    return K


def _ties(N=6):
    """Column 0 zero but for K_00 = 1 and ±4 in rows 1 and 4, whose ±2
    diagonals give them the same exact scaling: the two tie as the largest
    candidate, and the first must win."""
    K = _quasidef(2, N - 2, 1.0, seed=5)
    K[:, 0] = 0.0
    K[0, 0], K[1, 1], K[4, 4] = 1.0, 2.0, -2.0
    K[1, 0], K[4, 0] = 4.0, -4.0
    return K


#: the JAX package's factor and solve, compiled once per shape: the two
#: pivoting edges without a K_lo share one compile
_jfactor, _jsolve = jax.jit(jdf.factor), jax.jit(jdf.solve)


def _reference(K, rhs, with_lo=True):
    hi, lo = _split(K)
    fac, ok = _jfactor(jnp.asarray(hi), jnp.asarray(lo) if with_lo else None)
    return [np.asarray(f) for f in fac], bool(ok), np.asarray(_jsolve(fac, jnp.asarray(rhs)))


def _port(K, rhs, with_lo=True):
    hi, lo = _split(K)
    fac, ok = tdf.factor(torch.as_tensor(hi), torch.as_tensor(lo) if with_lo else None)
    return fac, bool(ok), tdf.solve(fac, torch.as_tensor(rhs))


def _assert_matches(port, ref):
    (Ah, Al, perm, s), ok, x = port
    (rAh, rAl, rperm, rs), rok, rx = ref
    assert ok == rok
    np.testing.assert_array_equal(Ah.numpy(), rAh)
    np.testing.assert_array_equal(perm.numpy(), rperm)
    np.testing.assert_array_equal(s.numpy(), rs)
    assert np.abs(Al.numpy() - rAl).max() <= 2.0**-40 * np.abs(rAh).max()
    finite = np.isfinite(rx)
    np.testing.assert_array_equal(np.isfinite(x.numpy()), finite)
    assert np.abs(x.numpy()[finite] - rx[finite]).max(initial=0.0) <= ULP4 * np.abs(rx[finite]).max(
        initial=0.0)


@pytest.fixture(scope="module")
def split_scale():
    """tests/test_df_lu.py's split-scale quasidefinite K at n + m = 40
    (cond ~ 1e8), a right-hand side and two more, both packages' factors
    and solves."""
    K = _quasidef(8, 32, 5.0)
    rng = np.random.default_rng(1)
    rhs = rng.normal(size=(K.shape[0], 3)).astype(np.float32)
    return K, rhs, _reference(K, rhs), _port(K, rhs)


def test_factor_and_solve_match_reference(split_scale):
    K, rhs, ref, port = split_scale
    _assert_matches(port, ref)
    # one right-hand side as a vector equals its column of the [N, 3] solve
    fac = port[0]
    np.testing.assert_array_equal(tdf.solve(fac, torch.as_tensor(rhs[:, 0])).numpy(),
                                  port[2][:, 0].numpy())


def test_forward_error_beats_f32_lu(split_scale):
    """~eps_df·cond forward error, at least 50x better than the f32 pivoted
    LU's eps32·cond (the reference test's criteria)."""
    K, rhs, _, (_, _, x) = split_scale
    exact = np.linalg.solve(K, rhs.astype(np.float64))
    err = lambda v: np.linalg.norm(v - exact) / np.linalg.norm(exact)
    K32 = torch.as_tensor(K.astype(np.float32))
    x_lu = torch.linalg.lu_solve(*torch.linalg.lu_factor(K32), torch.as_tensor(rhs))
    assert err(x.double().numpy()) < 1e-6
    assert err(x.double().numpy()) * 50 < err(x_lu.double().numpy())


def test_batch_equals_each_matrix_alone(split_scale):
    K, rhs, _, (fac, ok, x) = split_scale
    K2 = _quasidef(8, 32, 3.0, seed=9)
    hi, lo = (torch.stack(v) for v in zip(map(torch.as_tensor, _split(K2)),
                                            map(torch.as_tensor, _split(K))))
    fac_b, ok_b = tdf.factor(hi, lo)
    for got, want in zip(fac_b, fac):
        assert torch.equal(got[1], want)
    assert bool(ok_b[1]) == ok
    rb = torch.stack([torch.zeros(K.shape[0], 3), torch.as_tensor(rhs)])
    assert torch.equal(tdf.solve(fac_b, rb)[1], x)
    # a vector per matrix: [B, N]
    assert torch.equal(tdf.solve(fac_b, rb[..., 0])[1], x[:, 0])


@pytest.mark.parametrize("make, with_lo", [(_zero_pivot, True), (_zero_pivot, False),
                                           (_ties, False)])
def test_pivoting_edges_match_reference(make, with_lo):
    """The zero-pivot safeguard (a finite factor, ok, and the same
    non-finite solve: U keeps the zero pivot) and tied candidates (the
    first wins), as the JAX package resolves them."""
    K = make()
    rhs = np.random.default_rng(2).normal(size=(K.shape[0], 2)).astype(np.float32)
    port, ref = _port(K, rhs, with_lo), _reference(K, rhs, with_lo)
    _assert_matches(port, ref)
    assert port[1]
    if make is _ties:
        assert int(port[0][2][0]) == 1
    else:
        assert not np.isfinite(port[2].numpy()).all()


def test_factor_jacobi_matches_reference(split_scale):
    K, rhs, _, _ = split_scale
    K32 = K.astype(np.float32)
    settings = ct.DefaultSettings()
    (kind, (lu, piv, d)), ok = tdense.factor_jacobi(torch.as_tensor(K32), settings, 8)
    (rkind, (rlu, rpiv, rd)), rok = jdense.factor_jacobi(jnp.asarray(K32), settings, 8)
    assert kind == rkind == "lu_jacobi" and bool(ok) and bool(rok)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=2.0**-22, atol=0)
    assert np.abs(lu.numpy() - np.asarray(rlu)).max() <= 1e-5 * np.abs(np.asarray(rlu)).max()
    for b in (rhs, rhs[:, 0]):
        x = tdense._raw_solve((kind, (lu, piv, d)), torch.as_tensor(b)).numpy()
        rx = np.asarray(jdense._raw_solve((rkind, (rlu, rpiv, rd)), jnp.asarray(b)))
        assert np.abs(x - rx).max() <= 1e-5 * np.abs(rx).max()
        # and it solves K: the Jacobi scaling leaves the f32 LU's accuracy
        exact = np.linalg.solve(K32.astype(np.float64), b.astype(np.float64))
        assert np.linalg.norm(x - exact) <= 1e-2 * np.linalg.norm(exact)
    # the same row interchanges (LAPACK's, 1-based in torch, 0-based in jsl)
    np.testing.assert_array_equal(piv.numpy() - 1, np.asarray(rpiv))


def test_kernels_take_no_plain_version_off_the_cpu():
    """A CPU tensor runs the plain version and counts no launch; another
    device gets the kernel or an error, never the plain version."""
    before = (tdf.factor.launches, tdf.solve.launches)
    K = torch.eye(3)
    fac, ok = tdf.factor(K)
    assert bool(ok) and torch.equal(tdf.solve(fac, torch.ones(3)), torch.ones(3))
    assert (tdf.factor.launches, tdf.solve.launches) == before
    with pytest.raises(RuntimeError, match="no double-float LU kernel"):
        tdf.factor(K.to("meta"))
    with pytest.raises(TypeError, match="float32"):
        tdf.factor(K.double())


@pytest.mark.parametrize("route", ["qdldl", "jacobi"])
def test_f32_lu_routes_match_reference(route, monkeypatch):
    """Whole f32 solves of test_f32_paths.py's exponential-cone problem
    against the JAX package's, with test_torch_f32_dense.py's tolerances:
    "qdldl" (the plain f32 pivoted LU with the compensated refinement), and
    "lu" with DF_LU_MAX_DIM at 0 in both packages, which routes it to the
    Jacobi-equilibrated LU."""
    calls, traced = [], []
    if route == "jacobi":
        for module, seen in ((jdense, traced), (tdense, calls)):
            monkeypatch.setattr(module, "DF_LU_MAX_DIM", 0)
            monkeypatch.setattr(module, "factor_jacobi", functools.partial(
                lambda f, seen, *a: seen.append(1) or f(*a), module.factor_jacobi, seen))
    f32d.assert_solve_matches_reference(("expcone", route))
    if route == "jacobi":
        # the JAX package traces its loop once; the port calls it per iteration
        assert traced and len(calls) == f32d.port(("expcone", route)).solution.iterations

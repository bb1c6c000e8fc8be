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
import os
import subprocess
import sys

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
from clarabel_tpu_torch.kkt.compensated import _two_prod, _two_sum
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


# -----------------------------------------------------------------
# CPU models of the kernels' schedules (csrc/df_lu.cu), bitwise against
# the twins: the same elementwise operations, reordered as the kernels
# order them, with the kernels' test for the twin's masked effects
# -----------------------------------------------------------------

SPLIT_SAFE = 2.0**115  # below this, Dekker's split of a value cannot overflow


def _update(a, al, lh, ll, rh, rl):
    """One step of the twin's trailing update of the pairs (a, al) by the
    multiplier (lh, ll) and the U entry (rh, rl)."""
    uh, ue = _two_prod(lh, rh)
    cross = lh * rl + ll * rh
    sh, e1 = _two_sum(a, -uh)
    return _two_sum(sh, al + (e1 - ue - cross))


def _finite(*ts):
    return all(bool(torch.isfinite(t).all()) for t in ts)


def _scaled(K_hi, K_lo):
    s = tdf._pow2_jacobi(K_hi)
    lo = torch.zeros_like(K_hi) if K_lo is None else K_lo
    return s, K_hi * s[:, None] * s[None, :], lo * s[:, None] * s[None, :]


def _pivot(dh, dl, delta):
    if dh == 0.0:
        return torch.tensor(delta, dtype=torch.float32), torch.tensor(0.0)
    return dh, dl


def _factor_exact_model(K_hi, K_lo, delta):
    """The factor kernel's exact branch: the twin's masked schedule, column j
    left out of the update and then given its multipliers."""
    N = K_hi.shape[-1]
    s, Ah, Al = _scaled(K_hi, K_lo)
    perm, idx = torch.arange(N), torch.arange(N)
    for j in range(N):
        p = j + int(torch.argmax(torch.abs(Ah[j:, j] + Al[j:, j])))
        Ah[[j, p]], Al[[j, p]], perm[[j, p]] = Ah[[p, j]], Al[[p, j]], perm[[p, j]]
        dh, dl = _pivot(Ah[j, j], Al[j, j], delta)
        lh, ll = tdf._df_div(Ah[:, j], Al[:, j], dh, dl)
        below = (idx > j).float()
        mh, ml = lh * below, ll * below
        h, l = _update(Ah, Al, mh[:, None], ml[:, None], Ah[j] * below, Al[j] * below)
        rest = idx != j
        Ah, Al = torch.where(rest, h, Ah), torch.where(rest, l, Al)
        Ah[j + 1:, j], Al[j + 1:, j] = mh[j + 1:], ml[j + 1:]
    return (Ah, Al, perm, s), _finite(Ah, Al)


def _factor_model(K_hi, K_lo, nb, delta=1e-6):
    """The factor kernel's schedule for one matrix: panels of nb columns
    factored alone (with the masked multipliers of rows <= j computed for
    their finiteness), the panel's swaps applied late to the other columns,
    its U rows finished by a triangular sweep, and the trailing block given
    the panel's nb updates in step order; the exact branch when an entry
    ends non-finite or a masked multiplier is."""
    N = K_hi.shape[-1]
    s, Ah, Al = _scaled(K_hi, K_lo)
    perm = torch.arange(N)
    fin = tamed = True
    for j0 in range(0, N, nb):
        w = min(nb, N - j0)
        c0 = j0 + w
        Ph, Pl = Ah[:, j0:c0].clone(), Al[:, j0:c0].clone()
        piv = []
        for c in range(w):
            j = j0 + c
            p = j + int(torch.argmax(torch.abs(Ph[j:, c] + Pl[j:, c])))
            piv.append(p)
            Ph[[j, p]], Pl[[j, p]], perm[[j, p]] = Ph[[p, j]], Pl[[p, j]], perm[[p, j]]
            if j == 1:  # step 0 renormalized row 0, step 1 renormalizes (0, 0)
                Ph[0], Pl[0] = _two_sum(Ph[0], Pl[0])
            dh, dl = _pivot(Ph[j, c], Pl[j, c], delta)
            lh, ll = tdf._df_div(Ph[:, c], Pl[:, c], dh, dl)
            tamed = tamed and _finite(lh[:j + 1], ll[:j + 1])
            Ph[j + 1:, c], Pl[j + 1:, c] = lh[j + 1:], ll[j + 1:]
            Ph[j + 1:, c + 1:], Pl[j + 1:, c + 1:] = _update(
                Ph[j + 1:, c + 1:], Pl[j + 1:, c + 1:], lh[j + 1:, None], ll[j + 1:, None],
                Ph[j, c + 1:], Pl[j, c + 1:])
        Ah[j0:, j0:c0], Al[j0:, j0:c0] = Ph[j0:], Pl[j0:]
        fin = fin and _finite(Ph[j0:], Pl[j0:])
        rest = torch.tensor([k for k in range(N) if not j0 <= k < c0], dtype=torch.long)
        for c, p in enumerate(piv):
            for M in (Ah, Al):
                sub = M[:, rest]
                sub[[j0 + c, p]] = sub[[p, j0 + c]]
                M[:, rest] = sub
        U, Ul = Ah[j0:c0, c0:].clone(), Al[j0:c0, c0:].clone()
        for r in range(1, w):
            for t in range(r):
                U[r], Ul[r] = _update(U[r], Ul[r], Ph[j0 + r, t], Pl[j0 + r, t], U[t], Ul[t])
        Ah[j0:c0, c0:], Al[j0:c0, c0:] = U, Ul
        if j0 == 0:
            Ah[0, c0:], Al[0, c0:] = _two_sum(U[0], Ul[0])
        fin = fin and _finite(Ah[j0:c0, c0:], Al[j0:c0, c0:])
        T, Tl = Ah[c0:, c0:], Al[c0:, c0:]
        for t in range(w):
            T, Tl = _update(T, Tl, Ph[c0:, t, None], Pl[c0:, t, None], U[t], Ul[t])
        Ah[c0:, c0:], Al[c0:, c0:] = T, Tl
    if fin and tamed:
        return (Ah, Al, perm, s), True
    return _factor_exact_model(K_hi, K_lo, delta)


def _tame(h, l):
    return bool((torch.abs(h) < SPLIT_SAFE).all()) and _finite(l)


def _solve_model(factors, rhs, bs=8):
    """The solve kernel's schedule for one matrix, rhs [N, R]: row blocks of
    bs, each row taking the triangle's updates in the twin's column order
    (off-diagonal blocks first, then the diagonal block); the twin's own
    schedule when a factor entry, an iterate or an output is non-finite or
    an iterate too large to split."""
    Ah, Al, perm, s = factors
    N = Ah.shape[-1]
    fin = _finite(Ah, Al)
    yh, yl = rhs[perm] * s[perm][:, None], torch.zeros_like(rhs)
    blocks = [(i0, min(N, i0 + bs)) for i0 in range(0, N, bs)]
    for i0, i1 in blocks:
        xh, xl = yh[i0:i1].clone(), yl[i0:i1].clone()
        for j in range(i0):
            uh, ul = tdf._df_mul(Ah[i0:i1, j, None], Al[i0:i1, j, None], yh[j], yl[j])
            xh, xl = tdf._df_sub(xh, xl, uh, ul)
        for jj in range(i1 - i0):
            j = i0 + jj
            uh, ul = tdf._df_mul(Ah[j + 1:i1, j, None], Al[j + 1:i1, j, None], xh[jj], xl[jj])
            xh[jj + 1:], xl[jj + 1:] = tdf._df_sub(xh[jj + 1:], xl[jj + 1:], uh, ul)
        yh[i0:i1], yl[i0:i1] = xh, xl
        fin = fin and _tame(xh, xl)
    out = torch.empty_like(rhs)
    for i0, i1 in reversed(blocks):
        xh, xl = yh[i0:i1].clone(), yl[i0:i1].clone()
        for j in range(N - 1, i1 - 1, -1):
            ph, pl = tdf._df_mul(Ah[i0:i1, j, None], Al[i0:i1, j, None], yh[j], yl[j])
            xh, xl = tdf._df_sub(xh, xl, ph, pl)
        for jj in range(i1 - i0 - 1, -1, -1):
            j = i0 + jj
            xh[jj], xl[jj] = tdf._df_div(xh[jj], xl[jj], Ah[j, j], Al[j, j])
            ph, pl = tdf._df_mul(Ah[i0:j, j, None], Al[i0:j, j, None], xh[jj], xl[jj])
            xh[:jj], xl[:jj] = tdf._df_sub(xh[:jj], xl[:jj], ph, pl)
        yh[i0:i1], yl[i0:i1] = xh, xl
        out[i0:i1] = (xh + xl) * s[i0:i1, None]
        fin = fin and _tame(xh, xl) and _finite(out[i0:i1])
    # the exact branch repeats the twin's masked schedule operation for
    # operation (PR-13 form): the twin itself stands for it here
    return out if fin else tdf.solve_plain(factors, rhs)


def _model_matrix(N, kind, seed=3):
    """K [N, N] (f64): test_df_lu.py's quasidefinite matrix, or one of its
    edges: a zero row and column (``zero pivot``), tied candidates
    (``ties``), an inf or a value past Dekker's split range in the lower
    triangle (``inf``, ``huge``), a masked multiplier past f32's range
    (``masked``)."""
    n = max(N // 4, 1)
    K = _quasidef(n, N - n, 3.0, seed=seed + N)
    if kind == "zero pivot":
        K[N // 3, :] = K[:, N // 3] = 0.0
    elif kind == "ties":
        K[:, 0] = 0.0
        K[0, 0], K[2, 2], K[N - 2, N - 2] = 1.0, 2.0, -2.0
        K[2, 0], K[N - 2, 0] = 4.0, -4.0
    elif kind == "inf":
        K[N - 2, N // 2] = np.inf
    elif kind == "huge":
        K[N - 1, 1] = 3e37
    elif kind == "masked":
        # column 0 zero below K_00 and row and column z zero: z's pivot
        # becomes delta, and row 0's U entry over it (~1e33 once scaled by
        # the zero diagonal's 2^50) gives a masked multiplier past f32's range
        z = N // 3
        K[1:, 0] = K[z, :] = K[:, z] = 0.0
        K[0, z] = 1e18
    return K


def _model_cases():
    cases = []
    for nb in (8, 16):
        for N in (1, 2, nb - 1, nb, nb + 1, 2 * nb + 3):
            cases += [(nb, N, "random", "split"), (nb, N, "random", None)]
        N = 2 * nb + 3
        cases += [(nb, N, "zero pivot", "split"), (nb, N, "zero pivot", None),
                  (nb, N, "ties", None), (nb, N, "inf", "split"), (nb, N, "huge", None),
                  (nb, N, "masked", None), (nb, N, "random", "loose")]
    return sorted(set(cases), key=str)


def _model_inputs(N, kind, lo):
    """K_hi, K_lo (None, the exact split of K, or a ``loose`` lo part up to
    64 ulps of hi, whose pairs are not normalized)."""
    K = _model_matrix(N, kind)
    with np.errstate(invalid="ignore"):
        hi, split_lo = _split(K)
    if lo is None:
        return torch.as_tensor(hi), None
    if lo == "loose":
        rng = np.random.default_rng(N)
        split_lo = (np.spacing(hi) * rng.integers(-64, 65, size=hi.shape)).astype(np.float32)
    return torch.as_tensor(hi), torch.as_tensor(np.nan_to_num(split_lo, nan=0.0))


def _assert_same_bits(got, want, what):
    assert torch.equal(torch.isnan(got), torch.isnan(want)), f"{what}: NaN positions differ"
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), f"{what} differs"


@pytest.mark.parametrize("nb, N, kind, lo", _model_cases())
def test_factor_schedule_model_matches_twin(nb, N, kind, lo):
    """The factor kernel's panel-blocked schedule gives factor_plain's Ah, Al,
    perm, s and ok bit for bit (NaN positions included) at the panel edges
    N = 1, 2, nb - 1, nb, nb + 1, 2·nb + 3, with and without K_lo, with a
    loose K_lo, a zero pivot, ties, an inf, a value past the split and a
    masked multiplier past f32's range.  The kernel's panel width is 8;
    nb = 16 shows that the reordering does not hang on the width."""
    K_hi, K_lo = _model_inputs(N, kind, lo)
    (Ah, Al, perm, s), ok = _factor_model(K_hi, K_lo, nb)
    (rAh, rAl, rperm, rs), rok = tdf.factor_plain(K_hi, K_lo)
    for name, got, want in (("Ah", Ah, rAh), ("Al", Al, rAl), ("s", s, rs)):
        _assert_same_bits(got, want, name)
    assert torch.equal(perm, rperm)
    assert ok == bool(rok)
    assert ok == (kind not in ("inf", "huge", "masked"))


@pytest.mark.parametrize("nb, N, kind, lo", _model_cases())
def test_solve_schedule_model_matches_twin(nb, N, kind, lo):
    """The solve kernel's row-oriented blocked schedule gives solve_plain's
    result bit for bit, NaN positions included, at R = 1 and 2 on the same
    factors (a zero pivot or a non-finite factor takes the exact branch)."""
    K_hi, K_lo = _model_inputs(N, kind, lo)
    fac, _ = tdf.factor_plain(K_hi, K_lo)
    rhs = torch.as_tensor(np.random.default_rng(N).normal(size=(N, 2)), dtype=torch.float32)
    for b in (rhs[:, :1], rhs):
        _assert_same_bits(_solve_model(fac, b), tdf.solve_plain(fac, b), f"solve R={b.shape[1]}")


def test_launch_parameters():
    """factor_launch and solve_launch choose the kernels' form and shapes
    from (B, N, R) and the card's shared memory, and raise only for what
    cannot launch; nothing is launched.  (H100: 232,448 bytes per block,
    132 SMs.)  Up to N = 512 the one-block forms; above, the grid forms,
    whose shared memory is static and small, at every N."""
    cap, sms = 232448, 132
    assert tdf.factor_launch(1, 176, cap, sms) == ("block", 512, tdf.factor_smem_bytes(176))
    assert tdf.factor_smem_bytes(176) == (2 * 176 * 9 + 2 * 8 * 168 + 2 * 176) * 4
    assert tdf.factor_launch(264, 208, cap, sms)[1] == 256
    form, threads, nbytes = tdf.factor_launch(512, 208, cap, sms)
    # four blocks of the entropy batch share an SM (228 KB, 1 KB reserved each)
    assert form == "block" and threads == 128 and 4 * (nbytes + 1024 + 512) <= 233472
    assert tdf.BLOCK_MAX_DIM == tdense.DF_LU_MAX_DIM == 512
    assert tdf.factor_launch(1, 512, cap, sms)[::2] == ("block", tdf.factor_smem_bytes(512))
    assert tdf.factor_smem_bytes(512) <= cap
    for B, N in ((1, 513), (8, 1024), (1, 2540), (1, 20000)):
        assert tdf.factor_launch(B, N, cap, sms) == ("grid", 1024, 0)
    assert tdf.grid_scratch_words(2540) == 4 * 8 * 2540 + 2540 + 8 + 2
    with pytest.raises(ValueError, match="65535 matrices"):
        tdf.factor_launch(65536, 513, cap, sms)
    with pytest.raises(ValueError, match="shared memory"):
        tdf.factor_launch(1, 512, 50_000, sms)
    assert tdf.solve_launch(176, 1, cap) == ("block", 1, (8 * 2 * 32 * 17 + 2 * 32 * 33 + 4 * 176) * 4)
    form, rc, nbytes = tdf.solve_launch(208, 2, cap)
    # four blocks of the entropy batch's solve share an SM: one wave of 512
    assert form == "block" and rc == 2 and 4 * (nbytes + 1024) <= 233472
    assert tdf.solve_launch(512, 3, cap)[:2] == ("block", 2)
    assert tdf.solve_launch(513, 1, cap) == ("grid", 1, 0)
    assert tdf.solve_launch(2540, 2, cap) == ("grid", 2, 0)
    assert tdf.grid_solve_scratch_words(2540, 2) == 4 * 2540 * 2
    with pytest.raises(ValueError, match="shared memory"):
        tdf.solve_launch(512, 2, 50_000)


@pytest.mark.parametrize("value", ["0", "256", "1024"])
def test_df_lu_max_dim_ceiling(value, monkeypatch):
    """CT_DF_LU_MAX_DIM is read as the JAX package reads it
    (clarabel_tpu/kkt/dense.py): any integer, lower or higher than the
    default 512 (0 turns the double-float LU off) -- the kernels take every
    order, so there is no ceiling.  kkt/dense.py reads it on import
    (DF_LU_MAX_DIM = _df_lu_max_dim())."""
    monkeypatch.setenv("CT_DF_LU_MAX_DIM", value)
    assert tdense._df_lu_max_dim() == int(value)
    monkeypatch.delenv("CT_DF_LU_MAX_DIM")
    assert tdense._df_lu_max_dim() == 512


def test_df_lu_max_dim_on_import():
    """A process that imports the port with CT_DF_LU_MAX_DIM=4096 sees it
    in kkt.dense, where an import used to raise past 512."""
    code = "import clarabel_tpu_torch.kkt.dense as d; print(d.DF_LU_MAX_DIM)"
    env = dict(os.environ, CT_DF_LU_MAX_DIM="4096")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.split() == ["4096"]

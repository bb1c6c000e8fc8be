"""f32 on PSD layouts in clarabel_tpu_torch against the JAX package, both on
the CPU: the double-float PSD scaling (``cones/psd.py``: the eigh floor, the
double-float svec conversions, skron blocks and congruences, the stashed
skron blocks ``ops.mul_hs_df`` applies), the products of
``kkt/compensated.py`` they use and the (K, K_lo) refinement of
``kkt/dense.solve_refined``.

Tolerances, and why:
- ``df_matmul``, ``df_matmul_df`` and ``residual`` with ``K_lo``: hi parts
  bit for bit (both packages round every operation on its own and pair the
  same entries level by level); lo parts within 2⁻⁴⁰ of the largest hi
  entry (XLA:CPU contracts a product into a lo-stream sum, an FMA: the
  divergence documented for the double-float LU);
- the double-float sites on buckets of order n ≤ 32 (the svec conversions,
  ``_skron_df``, ``hs_dense(want_lo=True)`` and ``mul_hs_df`` with and
  without the stash): bit for bit, hi and lo, given the JAX package's own
  scaling state.  The f32 ``mul_hs`` rounds its double-float product through
  the plain ``_to_svec``, which the JAX package (x64) rounds from f64: within
  8 f32 ulps of the largest entry.  The order-33 bucket takes the plain
  f32 products: within 8 f32 ulps of the largest entry (4·2⁻²²: XLA sums
  in another order, and with x64 on, as the tests run it, the JAX package
  rounds its ``_to_mat`` and ``_skron`` products in f64 first);
- ``combined_ds_shift``, ``ds_from_dz_offset`` and ``step_length`` at f32:
  their double-float congruences start from the plain ``_to_mat``, which the
  JAX package (x64) rounds once from f64 and the port in f32, one ulp apart
  on some entries, amplified by the scaling's condition: within 2e-6 of the
  largest entry (measured 4e-7) and the step length within 1e-5 relative;
- ``update_scaling`` at f32: eigh's and the SVD's vectors are defined up to
  sign and rotation, so R is compared through RRᵀ, R⁻ᵀR⁻¹, λ and Hs; the
  f32 eigh and SVD round at eps32 times the condition of these test points
  (eigenvalues from 1e-4 to 1): within 1e-3 of the largest entry;
- ``solve_refined`` with a (K, K_lo) pair: x within 1e-6 of the largest
  entry of the f64 solution of (K + K_lo) x = rhs and the double-float
  x + x_lo within 1e-12 (~eps² times the matrix's condition, about 200), as
  the JAX package's are, and at least 100 times closer than the refinement
  against K alone.

The centering recovery and whole f32 PSD solves are in
``test_torch_f32_psd_solve.py``; the refinement with a (K, K_lo) pair in
``test_torch_f32_psd_refine.py``, a file of two tests that pytest-xdist's
loadfile scheduling runs beside tests/test_df_lu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones import psd as jpsd
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.kkt import compensated as jdfc
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones import psd as tpsd
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import compensated as tdfc

LO_REL = 2.0**-40
ULP8 = 8 * 2.0**-23
# buckets of order 2, 3 (three cones), 5 and 33 (past _DF_AXA_MAX_N = 32)
CONES = [ct.NonnegativeConeT(2), ct.PSDTriangleConeT(3), ct.PSDTriangleConeT(2),
         ct.PSDTriangleConeT(5), ct.PSDTriangleConeT(3), ct.PSDTriangleConeT(3),
         ct.PSDTriangleConeT(33)]
JL = JaxLayout(ct.cones.api.collapse_cones(CONES))
TL = TorchLayout(tp.port_cones(JL.cones))
F32 = ct.DefaultSettings.for_float32(verbose=False)
SQRT2 = np.sqrt(2.0)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(v):
    return torch.as_tensor(np.array(v))


def _equal(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _close(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref), initial=0.0)), 1e-30)
    assert np.max(np.abs(got.astype(np.float64) - ref), initial=0.0) <= rel * scale


def _svec(M):
    n = M.shape[-1]
    return np.array([M[i, j] * (1.0 if i == j else SQRT2) for j in range(n) for i in range(j + 1)])


def _interior(rng, layout=JL):
    """A point inside every cone: NN entries in [0.5, 2], each PSD matrix
    with eigenvalues from 1e-4 to 1 in a random basis."""
    v = np.zeros(layout.m)
    sl = layout.slice_of(ct.cones.api.NONNEGATIVE)
    v[sl] = rng.uniform(0.5, 2.0, sl.stop - sl.start)
    pos = layout.slice_of(ct.cones.api.PSD).start
    for c in layout.cones:
        if c.kind == ct.cones.api.PSD:
            Q, _ = np.linalg.qr(rng.normal(size=(c.dim, c.dim)))
            v[pos:pos + c.nvars] = _svec(Q @ np.diag(np.geomspace(1e-4, 1.0, c.dim)) @ Q.T)
            pos += c.nvars
    return v.astype(np.float32)


def _jax_state(seed):
    """The JAX package's f32 scaling at two interior points, and the port's
    copy of it."""
    rng = np.random.default_rng(seed)
    s, z = _interior(rng), _interior(rng)
    jstate, ok = jops.update_scaling(JL, jops.set_identity_scaling(JL, jnp.float32),
                                     jnp.asarray(s), jnp.asarray(z), np.float32(1.0), 0)
    assert bool(ok)
    return rng, s, z, jstate, {k: _t(v) for k, v in jstate.items()}


def _df_buckets():
    """(bucket index, JAX bucket, the port's bucket and tensors) of each
    bucket, and the rows of each in the m-vector."""
    start = JL.slice_of(ct.cones.api.PSD).start
    return [(bi, jb, tb, t, start + jb.gather.reshape(-1))
            for (bi, tb, t), jb in zip(tpsd._buckets(TL, torch.zeros(1, dtype=torch.float32)),
                                       JL.psd_buckets)]


# ---------------------------------------------------------------------
# kkt/compensated.py: the double-float products and the K_lo residual
# ---------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["df_matmul", "df_matmul_df"])
def test_df_products(fn):
    rng = np.random.default_rng(1)
    A, B = _f32(rng, 2, 3, 5, 4) * 1e2, _f32(rng, 2, 3, 4, 6)
    args = (A, B) if fn == "df_matmul" else (A, _f32(rng, 2, 3, 5, 4, scale=1e-6),
                                             B, _f32(rng, 2, 3, 4, 6, scale=1e-8))
    rh, rl = jax.jit(getattr(jdfc, fn))(*map(jnp.asarray, args))
    gh, gl = getattr(tdfc, fn)(*map(_t, args))
    _equal(gh, rh)
    assert np.abs(gl.numpy() - np.asarray(rl)).max() <= LO_REL * np.abs(np.asarray(rh)).max()
    # ~eps²: the pair holds the f64 product of the f64 operands to 2^-44
    A64 = args[0].astype(np.float64) + (0 if fn == "df_matmul" else args[1])
    B64 = (args[1] if fn == "df_matmul" else args[2] + args[3].astype(np.float64))
    exact = A64 @ B64
    assert np.abs(gh.double().numpy() + gl.double().numpy() - exact).max() \
        <= 2.0**-44 * np.abs(exact).max()
    # a batch of one computes what its lane does in the batch
    one = getattr(tdfc, fn)(*(_t(a[1:2]) for a in args))
    assert torch.equal(one[0][0], gh[1]) and torch.equal(one[1][0], gl[1])


@pytest.mark.parametrize("case", ["vector", "multi-rhs", "batch multi-rhs"])
def test_residual_with_k_lo_bitwise(case):
    rng = np.random.default_rng(2)
    N = 23
    K = _f32(rng, N, N) * np.geomspace(1, 1e6, N).astype(np.float32)
    K_lo = (K * _f32(rng, N, N, scale=2.0**-25)).astype(np.float32)
    shape = (N, 2) if "multi" in case else (N,)
    x, rhs = _f32(rng, *shape), _f32(rng, *shape)
    ref = jax.jit(jdfc.residual)(*map(jnp.asarray, (K, x, rhs)), K_lo=jnp.asarray(K_lo))
    if case.startswith("batch"):
        # the problem in lane 1 computes what it does alone
        Kb, Klb, xb, rb = (np.stack([_f32(rng, *v.shape), v]) for v in (K, K_lo, x, rhs))
        got = tdfc.residual(_t(Kb), _t(xb), _t(rb), K_lo=_t(Klb))[1]
    else:
        got = tdfc.residual(_t(K), _t(x), _t(rhs), K_lo=_t(K_lo))
    _equal(got, ref)
    true = rhs - (K.astype(np.float64) + K_lo) @ x.astype(np.float64)
    assert np.all(np.abs(got.double().numpy() - true)
                  <= 1.5e-7 * np.abs(true) + 1e-12 * np.abs(true).max())


# ---------------------------------------------------------------------
# cones/psd.py and cones/ops.py at f32
# ---------------------------------------------------------------------


@pytest.mark.parametrize("with_lo, exact", [(False, False), (True, False), (True, True)])
def test_svec_conversions_df(with_lo, exact, monkeypatch):
    """The svec conversions and the skron blocks, in the rounded frame of
    the 1/√2 constants (``_EXACT_SQRT2`` False, both packages' setting) and
    in the exact one (True: each constant's lo part added)."""
    monkeypatch.setattr(jpsd, "_EXACT_SQRT2", exact)
    monkeypatch.setattr(tpsd, "_EXACT_SQRT2", exact)
    rng = np.random.default_rng(3)
    for bi, jb, tb, t, _ in _df_buckets():
        x = _f32(rng, jb.count, jb.tri, scale=10.0)
        x_lo = _f32(rng, jb.count, jb.tri, scale=1e-7) if with_lo else None
        rM = jpsd._to_mat_df(jb, jnp.asarray(x), None if x_lo is None else jnp.asarray(x_lo))
        gM = tpsd._to_mat_df(tb, t, _t(x), None if x_lo is None else _t(x_lo))
        for g, r in zip(gM, rM):
            _equal(g, r)
        Yl = _f32(rng, jb.count, jb.n, jb.n, scale=1e-7)
        rs = jpsd._to_svec_df(jb, rM[0], jnp.asarray(Yl))
        gs = tpsd._to_svec_df(tb, t, gM[0], _t(Yl))
        for g, r in zip(gs, rs):
            _equal(g, r)
        # svec(mat(x)) gives back x + x_lo: to ~eps² in the exact frame, and
        # in the rounded one to the rounding of its constants, (√2·f32(1/√2))²
        back = tpsd._to_svec_df(tb, t, *gM)
        total = x.astype(np.float64) + (0 if x_lo is None else x_lo)
        err = back[0].double().numpy() + back[1].double().numpy() - total
        assert np.abs(err).max() <= (2.0**-40 if exact else 2.0**-22) * np.abs(x).max()
        # the skron blocks of the pair
        Ah, Al = (_f32(rng, jb.count, jb.n, jb.n), _f32(rng, jb.count, jb.n, jb.n, scale=1e-8))
        for g, r in zip(tpsd._skron_df(tb, t, _t(Ah), _t(Al)),
                        jpsd._skron_df(jb, jnp.asarray(Ah), jnp.asarray(Al))):
            _equal(g, r)


def test_hs_dense_lo_and_the_stash():
    """hs_dense(want_lo=True): the double-float skron blocks (hi in H, lo in
    H_lo) bit for bit the JAX package's, stashed in the state; the order-33
    bucket plain, with no lo and no stash.  A batch of two problems equals
    each alone."""
    _, _, _, jstate, state = _jax_state(4)
    jH, jHl = jops.hs_dense(JL, dict(jstate), jnp.float32, want_lo=True)
    H, Hl = tops.hs_dense(TL, state, torch.float32, "cpu", want_lo=True)
    for bi, jb, _, _, rows in _df_buckets():
        blk = np.ix_(rows, rows)
        if jb.n <= tpsd._DF_AXA_MAX_N:
            _equal(H[blk], np.asarray(jH)[blk])
            _equal(Hl[blk], np.asarray(jHl)[blk])
            sh, sl = state[f"psd{bi}_skron"]
            g = torch.as_tensor(jb.gather) + JL.slice_of(ct.cones.api.PSD).start
            assert torch.equal(H[g[:, :, None], g[:, None, :]], sh)
        else:
            _close(H[blk], np.asarray(jH)[blk], ULP8)
            assert not Hl[blk].any() and f"psd{bi}_skron" not in state
    # without want_lo every bucket takes the plain f32 skron, and H alone
    plain = tops.hs_dense(TL, dict(state), torch.float32, "cpu")
    assert isinstance(plain, torch.Tensor)
    _close(plain, H.double().numpy(), ULP8)
    # a batch of two, the problem in lane 1
    bstate = {k: torch.stack([v.flip(-1), v]) for k, v in state.items() if k.endswith(
        ("_R", "_Rinv", "_lam", "_w"))}
    bH, bHl = tops.hs_dense(TL, bstate, torch.float32, "cpu", (2,), want_lo=True)
    assert torch.equal(bH[1], H) and torch.equal(bHl[1], Hl)


@pytest.mark.parametrize("stash", [False, True])
def test_mul_hs_f32_and_mul_hs_df(stash):
    """The f32 mul_hs (double-float A·X·A, rounded) and mul_hs_df: with the
    stash, the compensated matvec of the solved K's skron blocks; without,
    the double-float congruence; the order-33 bucket the plain products."""
    rng, _, _, jstate, state = _jax_state(5)
    if stash:
        jops.hs_dense(JL, jstate, jnp.float32, want_lo=True)
        tops.hs_dense(TL, state, torch.float32, "cpu", want_lo=True)
        assert all(f"psd{bi}_skron" in jstate for bi in range(3))
    x, x_lo = _f32(rng, JL.m, scale=1e2), _f32(rng, JL.m, scale=1e-6)
    ref = [np.asarray(jops.mul_hs(JL, jstate, jnp.asarray(x)))]
    ref += [np.asarray(v) for v in jops.mul_hs_df(JL, jstate, jnp.asarray(x), jnp.asarray(x_lo))]
    got = [tops.mul_hs(TL, state, _t(x))]
    got += list(tops.mul_hs_df(TL, state, _t(x), _t(x_lo)))
    nn = JL.slice_of(ct.cones.api.NONNEGATIVE)
    for g, r in zip(got, ref):
        _equal(g[nn], r[nn])
    for _, jb, _, _, rows in _df_buckets():
        if jb.n <= tpsd._DF_AXA_MAX_N:
            # mul_hs rounds the double-float A·X·A through the plain _to_svec,
            # which the JAX package (x64) rounds once from f64
            _close(got[0][rows], ref[0][rows], ULP8)
            for g, r in zip(got[1:], ref[1:]):
                _equal(g[rows], r[rows])
        else:
            for g, r, scale in zip(got, ref, (ref[0], ref[1], ref[1])):
                assert np.abs(g[rows].numpy() - r[rows]).max() \
                    <= ULP8 * np.abs(scale[rows]).max()
    # a batch of two, the problem in lane 1
    bstate = {k: (tuple(torch.stack([v.flip(-1), v]) for v in val) if isinstance(val, tuple)
                  else torch.stack([val.flip(-1), val])) for k, val in state.items()}
    bh, bl = tops.mul_hs_df(TL, bstate, torch.stack([_t(x).flip(-1), _t(x)]),
                            torch.stack([_t(x_lo), _t(x_lo)]))
    assert torch.equal(bh[1], got[1]) and torch.equal(bl[1], got[2])


def test_step_quantities_f32():
    """combined_ds_shift, ds_from_dz_offset and step_length through the
    double-float congruences (the order-33 bucket plain)."""
    rng, s, z, jstate, state = _jax_state(6)
    dz, ds = _f32(rng, JL.m), _f32(rng, JL.m)
    sm = np.float32(0.3)
    ref = jops.combined_ds_shift(JL, jstate, jnp.asarray(dz), jnp.asarray(ds), sm,
                                 jnp.asarray(z))
    _close(tops.combined_ds_shift(TL, state, _t(dz), _t(ds), _t(sm), _t(z)), ref, 2e-6)
    ref = jops.ds_from_dz_offset(JL, jstate, jnp.asarray(dz), jnp.asarray(z))
    _close(tops.ds_from_dz_offset(TL, state, _t(dz), _t(z)), ref, 2e-6)
    ref = float(jops.step_length(JL, jstate, jnp.asarray(dz), jnp.asarray(ds), jnp.asarray(z),
                                 jnp.asarray(s), F32, np.float32(1.0)))
    tset = tp.port_settings(F32)
    got = float(tops.step_length(TL, state, _t(dz), _t(ds), _t(z), _t(s), tset,
                                 torch.tensor(1.0)))
    assert ref < 1.0 and abs(got - ref) <= 1e-5 * ref


def test_update_scaling_f32_invariants():
    """The eigh-floored NT scaling, compared by what does not depend on
    eigh's and the SVD's vector choices; a non-finite point makes ``ok``
    False and its lane's R NaN without touching the other lane; a matrix
    with a negative eigenvalue below the floor gets the floored factor."""
    rng, s, z, jstate, _ = _jax_state(7)
    state, ok = tops.update_scaling(TL, tops.set_identity_scaling(TL, torch.float32, "cpu"),
                                    _t(s), _t(z), torch.tensor(1.0), torch.tensor(0))
    assert bool(ok)
    for bi, jb, _, _, _ in _df_buckets():
        R, Rinv = state[f"psd{bi}_R"].double(), state[f"psd{bi}_Rinv"].double()
        jR = np.asarray(jstate[f"psd{bi}_R"], np.float64)
        jRi = np.asarray(jstate[f"psd{bi}_Rinv"], np.float64)
        _close(R @ R.mT, jR @ jR.transpose(0, 2, 1), 1e-3)
        _close(Rinv.mT @ Rinv, jRi.transpose(0, 2, 1) @ jRi, 1e-3)
        _close(state[f"psd{bi}_lam"], jstate[f"psd{bi}_lam"], 1e-3)
    H = tops.hs_dense(TL, state, torch.float32, "cpu")
    _close(H, jops.hs_dense(JL, jstate, jnp.float32)[0], 1e-3)

    # a batch of two: lane 0 with a NaN in its second PSD cone
    sb = np.stack([s, s])
    sb[0, JL.slice_of(ct.cones.api.PSD).start + JL.psd_buckets[1].gather[1, 0]] = np.nan
    bstate, bok = tops.update_scaling(
        TL, tops.set_identity_scaling(TL, torch.float32, "cpu", (2,)), _t(sb),
        _t(np.stack([z, z])), torch.ones(2), torch.zeros(2, dtype=torch.int32))
    assert bok.tolist() == [False, True]
    assert torch.isnan(bstate["psd1_R"][0, 1]).all() and torch.isfinite(bstate["psd1_R"][0, 0]).all()
    for k, v in state.items():
        assert torch.equal(bstate[k][1], v), k

    # the floor: eigenvalues (-1e-9, 1e-3, 1) -> (4·eps32, 1e-3, 1)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    M = (Q @ np.diag([-1e-9, 1e-3, 1.0]) @ Q.T).astype(np.float32)
    L = tpsd._sqrt_factor(_t(M)).double().numpy()
    w, U = np.linalg.eigh(M.astype(np.float64))
    floored = U @ np.diag(np.maximum(w, 4 * 2.0**-23 * np.abs(w).max())) @ U.T
    assert np.all(np.isfinite(L)) and np.abs(L @ L.T - floored).max() <= 1e-6


def test_f32_linalg_repeated_in_f64_where_it_fails(monkeypatch):
    """An f32 eigh, eigvalsh or SVD that does not converge (cuSOLVER's
    batched Jacobi on a card can fail where LAPACK does not) is repeated in
    f64 and rounded back: the scaling and the step length come out as from
    f32 calls that converge, within the f32 rounding of these test points'
    condition (1e-3, as update_scaling's invariants above)."""
    rng, s, z, _, _ = _jax_state(12)
    dz, ds = _f32(rng, JL.m), _f32(rng, JL.m)
    tset = tp.port_settings(F32)

    def scaling_and_step():
        state, ok = tops.update_scaling(
            TL, tops.set_identity_scaling(TL, torch.float32, "cpu"), _t(s), _t(z),
            torch.tensor(1.0), torch.tensor(0))
        alpha = tops.step_length(TL, state, _t(dz), _t(ds), _t(z), _t(s), tset,
                                 torch.tensor(1.0))
        return state, bool(ok), float(alpha)

    want, ok, alpha = scaling_and_step()
    for name in ("eigh", "eigvalsh", "svd"):
        fn = getattr(torch.linalg, name)

        def failing(A, *args, _fn=fn, **kwargs):
            if A.dtype == torch.float32:
                raise torch.linalg.LinAlgError("did not converge")
            return _fn(A, *args, **kwargs)

        monkeypatch.setattr(torch.linalg, name, failing)
    got, ok2, alpha2 = scaling_and_step()
    assert ok and ok2 and abs(alpha2 - alpha) <= 1e-3 * alpha
    for bi in range(len(JL.psd_buckets)):
        R, R2 = want[f"psd{bi}_R"].double(), got[f"psd{bi}_R"].double()
        assert got[f"psd{bi}_R"].dtype == torch.float32
        _close(R2 @ R2.mT, (R @ R.mT).numpy(), 1e-3)
        _close(got[f"psd{bi}_lam"], want[f"psd{bi}_lam"].numpy(), 1e-3)


def _quasidef(n, m, seed):
    """A quasidefinite f32 K with an Hs block spread over 1e-4..1e4 and its
    lo part (as an f32 PSD layout's K_lo: eps-scaled, in the Hs block)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    Pm = rng.normal(size=(n, n))
    H = rng.normal(size=(m, m))
    H = H @ H.T / m + np.diag(10.0 ** rng.uniform(-4, 4, m))
    K = np.block([[Pm @ Pm.T / n + np.eye(n), A.T], [A, -H]])
    K32 = K.astype(np.float32)
    K_lo = np.zeros_like(K32)
    K_lo[n:, n:] = (K[n:, n:] - K32[n:, n:]).astype(np.float32)
    return K32, K_lo, rng.normal(size=(n + m, 2)).astype(np.float32)



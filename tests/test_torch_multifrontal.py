"""The multifrontal numeric factorization and solves of clarabel_tpu_torch
against the JAX package's, f64 on the CPU, on one plan and one set of K
values made from a numpy seed: a quasidefinite K (P ≻ 0 block, -H ≺ 0
block) on a grid pattern, analyzed once by the JAX package's
``mf_symbolic`` (the port's gives the same plan: test_torch_mf_symbolic.py).

- ``mf_factor`` and ``mf_solve`` through the pivot scan (the CPU route)
  and through the kernel route's plain twin (``_diag_factor_ldl``: the
  blocks symmetrized and factored by ``pallas_ldl.ldl_unblocked_plain``
  with per-front signs, what the card runs through
  ``ldl_unblocked_kernel``), against the JAX package's: pivots, L and the
  solution within 1e-12 relative.  The scan repeats the JAX arithmetic; the
  kernel route forms each rank-1 update in another order ((K[j][r]/d)·K[j][c]
  against (K[c][j]/d)·K[r][j]), so the two differ by rounding.  Held in
  test_torch_multifrontal_factor.py, a file of two tests that
  pytest-xdist's loadfile scheduling runs beside tests/test_df_lu.py.
- the per-matrix-sign twin against JAX ``_diag_factor``, 1e-12 relative,
  and the regularization firing on the same pivots in both.
- padded fronts: pad pivots regularize to delta and leave the solution of
  K x = b exact (against a dense solve, 1e-10 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity  # noqa: F401  (pins torch's threads)
from clarabel_tpu.kkt import mf_symbolic as jsym
from clarabel_tpu.kkt import multifrontal as jmf
from clarabel_tpu_torch.kkt import mf_symbolic as tsym
from clarabel_tpu_torch.kkt import multifrontal as tmf
from clarabel_tpu_torch.kkt import pallas_ldl

EPS, DELTA = 1e-13, 2e-7  # the default dynamic regularization


def _close(got, ref, rel=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * scale


def _quasidefinite(k=12, m=40, seed=0):
    """(K_low CSC, dense K, dsigns): K = [[P, Aᵀ], [A, -H]] with P a
    weighted k x k grid Laplacian (positive definite; its nested fronts
    give the plan several levels and children to extend-add), A sparse
    random, H positive diagonal."""
    rng = np.random.default_rng(seed)
    T = sp.diags([2.0 * np.ones(k), -np.ones(k - 1), -np.ones(k - 1)], [0, 1, -1])
    n = k * k
    P = sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k)) + sp.diags(rng.uniform(0.5, 1.5, n))
    A = sp.random(m, n, density=2.0 / n, random_state=seed)
    H = sp.diags(rng.uniform(0.5, 2.0, m))
    K = sp.bmat([[P, A.T], [A, -H]]).tocsc()
    dsigns = np.concatenate([np.ones(n), -np.ones(m)])
    return sp.tril(K).tocsc(), K.toarray(), dsigns


def _setup(seed=0, **kw):
    K_low, K, dsigns = _quasidefinite(seed=seed, **kw)
    plan = jsym.analyze(K_low, dsigns)
    tplan = tsym.analyze(K_low, dsigns)
    jarrays = {k: jnp.asarray(v) for k, v in plan.arrays.items()}
    tarrays = tmf.device_arrays(tplan, torch.float64, "cpu")
    kvals = K_low.data.copy()
    return plan, tplan, jarrays, tarrays, kvals, K


def _blocks(k=6, b=32, seed=4):
    """k symmetric b x b blocks with mixed expected signs, each diagonally
    dominant in its own signs, and two pivots that fire the
    regularization without blowing up the rest: front 0's first pivot is
    tiny (its column below is zero), front 1's last has the wrong sign."""
    rng = np.random.default_rng(seed)
    signs = np.where(rng.random((k, b)) < 0.5, 1.0, -1.0)
    D = rng.normal(size=(k, b, b))
    D = D + np.swapaxes(D, 1, 2)
    D[:, np.arange(b), np.arange(b)] = 4.0 * b * signs
    D[0, 0, 0] = 1e-15 * signs[0, 0]
    D[0, 1:, 0] = 0.0
    D[1, -1, -1] = -5.0 * signs[1, -1]
    # only the lower triangle is valid
    return np.tril(D) + np.triu(rng.normal(size=(k, b, b)), 1), signs


@pytest.mark.parametrize("b", [1, 17, 32])
def test_per_matrix_sign_twin_matches_reference_diag_factor(b):
    D, signs = _blocks(b=b)
    jL, jd = jmf._diag_factor(jnp.asarray(D), jnp.asarray(signs), EPS, DELTA)
    tL, td = tmf._diag_factor_ldl(torch.as_tensor(D), torch.as_tensor(signs), EPS, DELTA)
    _close(tL, jL)
    _close(td, jd)
    # the scan repeats the JAX package's arithmetic
    sL, sd = tmf._diag_factor_scan(torch.as_tensor(D), torch.as_tensor(signs), EPS, DELTA)
    _close(sL, jL, rel=1e-15)
    _close(sd, jd, rel=1e-15)
    # the regularization fires on the same pivots, to delta·sign
    fired = np.asarray(jd) == DELTA * signs
    assert np.array_equal(td.numpy() == DELTA * signs, fired)
    assert fired[0, 0] and fired[1, -1] and fired.sum() == 2


def test_per_matrix_signs_are_each_matrix_own():
    """A batch whose matrices carry different signs factors like each
    matrix alone with its own signs (and unlike a shared sign vector)."""
    D, signs = _blocks(k=4, b=8, seed=6)
    S = torch.as_tensor(np.tril(D) + np.swapaxes(np.tril(D, -1), 1, 2))
    sg = torch.as_tensor(signs)
    packed = pallas_ldl.ldl_unblocked(S, sg, EPS, DELTA)
    for i in range(4):
        alone = pallas_ldl.ldl_unblocked_plain(S[i:i + 1], sg[i], EPS, DELTA)
        assert torch.equal(packed[i:i + 1], alone)
    assert pallas_ldl.ldl_unblocked.launches == 0  # the CPU takes the plain version
    with pytest.raises(ValueError):
        pallas_ldl.ldl_unblocked(S, sg[0], EPS, DELTA)
    with pytest.raises(RuntimeError, match="no LDL kernel"):
        pallas_ldl.ldl_unblocked(S.to("meta"), sg.to("meta"), EPS, DELTA)


def test_padded_fronts_solve_exactly():
    """Fronts padded past their pivot count (c_pad > c): the pad pivots
    regularize to delta·(+1) and the solution is K⁻¹b."""
    plan, tplan, jarrays, tarrays, kvals, K = _setup(seed=2, k=10, m=30)
    padded = [(B, nid) for lvl in tplan.levels for B in lvl for nid in [B.node_ids]
              if any(tplan.arrays[B.key + ":cols_g"][:, -1] == tplan.N)]
    assert padded
    tf, tok = tmf.mf_factor(tplan, tarrays, torch.as_tensor(kvals), EPS, DELTA)
    assert bool(tok)
    for B, _ in padded:
        pad = tplan.arrays[B.key + ":cols_g"] == tplan.N
        d = tf["dvec"][B.w_off: B.w_off + B.k * B.c_pad].reshape(B.k, B.c_pad).numpy()
        assert np.all(d[pad] == DELTA)
    rhs = np.random.default_rng(3).normal(size=K.shape[0])
    _close(tmf.mf_solve(tplan, tarrays, tf, torch.as_tensor(rhs)), np.linalg.solve(K, rhs),
           rel=1e-10)


def test_unit_lower_inverse_forms_agree():
    rng = np.random.default_rng(7)
    L = torch.as_tensor(np.tril(rng.normal(size=(3, 20, 20)) * 0.3, -1))
    eye = torch.eye(20, dtype=torch.float64)
    for stable in (False, True):
        inv = tmf._unit_lower_inverse(L, stable=stable)
        _close(inv @ (L + eye), eye.expand(3, 20, 20), rel=1e-12)
        _close(inv, jmf._unit_lower_inverse(jnp.asarray(L.numpy()), stable=stable))


def test_batched_factor_and_solve_equal_each_lane():
    """B = 3 value sets on one plan: the factor of the batch (every lane's
    fronts of a bucket in one [B·k, r, r] partial factorization, the plan's
    signs tiled over the lanes) equals each lane's own factor bit for bit --
    pivots, panels, inverses -- and so does the solve at [B, N, 2]; at
    [B, N, 1] each lane lies within 1e-14 relative of its own solve, not
    bit for bit: the plan's last bucket holds one front, whose product with
    one right-hand side takes BLAS's matrix-vector path alone and the
    batched product in a batch, and the two sum in other orders.  ``ok`` is
    per lane.  A [B, N] right-hand side is refused, since it would read as
    one problem's [N, r]."""
    plan, tplan, jarrays, tarrays, kvals, K = _setup()
    rng = np.random.default_rng(11)
    B = 3
    kv = np.stack([kvals * rng.uniform(0.8, 1.2, kvals.size) for _ in range(B)])
    fb, okb = tmf.mf_factor(tplan, tarrays, torch.as_tensor(kv), EPS, DELTA)
    assert okb.shape == (B,) and bool(okb.all())
    rhs = torch.as_tensor(rng.normal(size=(B, K.shape[0], 2)))
    x2 = tmf.mf_solve(tplan, tarrays, fb, rhs)
    x1 = tmf.mf_solve(tplan, tarrays, fb, rhs[..., :1])
    for i in range(B):
        fi, oki = tmf.mf_factor(tplan, tarrays, torch.as_tensor(kv[i]), EPS, DELTA)
        assert bool(oki) and torch.equal(fb["dvec"][i], fi["dvec"])
        for lb, li in zip(fb["levels"], fi["levels"]):
            for (bLc, bd, bLinv), (iLc, i_d, iLinv) in zip(lb, li):
                assert torch.equal(bLc[i], iLc) and torch.equal(bd[i], i_d)
                assert torch.equal(bLinv[i], iLinv)
        assert torch.equal(x2[i], tmf.mf_solve(tplan, tarrays, fi, rhs[i]))
        _close(x1[i, :, 0], tmf.mf_solve(tplan, tarrays, fi, rhs[i, :, 0]).numpy(), rel=1e-14)
    with pytest.raises(ValueError, match="rhs"):
        tmf.mf_solve(tplan, tarrays, fb, rhs[..., 0])


def test_non_finite_factor_fails_its_lane_only():
    """A NaN in one lane's K values fails that lane's ``ok`` alone; the
    other lanes' factors are those of their values alone."""
    plan, tplan, jarrays, tarrays, kvals, K = _setup()
    kv = np.stack([kvals, kvals.copy(), 1.1 * kvals])
    kv[1, kv.shape[1] // 2] = np.nan
    fb, okb = tmf.mf_factor(tplan, tarrays, torch.as_tensor(kv), EPS, DELTA)
    assert okb.tolist() == [True, False, True]
    fi, _ = tmf.mf_factor(tplan, tarrays, torch.as_tensor(kv[2]), EPS, DELTA)
    assert torch.equal(fb["dvec"][2], fi["dvec"])
    # the partial factorization's ok is per front
    F = torch.eye(4, dtype=torch.float64).expand(3, 4, 4).clone()
    F[1, 2, 0] = np.inf
    *_, ok = tmf.partial_ldl(F, 2, torch.ones((3, 2), dtype=torch.float64), EPS, DELTA)
    assert ok.tolist() == [True, False, True]

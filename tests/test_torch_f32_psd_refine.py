"""``solve_refined`` of clarabel_tpu_torch with a double-float (K, K_lo)
pair against the JAX package's, both on the CPU, as test_torch_f32_psd.py
states it: through the double-float LU of K_reg + K_lo (the f32 "lu" route)
and through the plain f32 LU of K (the aliases' route), x within 1e-6 and
x + x_lo within 1e-12 of the f64 solution, at least 100 times closer than
the refinement against K alone.  A file of two tests (the JAX package's
double-float LU and refinement compiles), which pytest-xdist's loadfile
scheduling runs beside tests/test_df_lu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from clarabel_tpu.kkt import dense as jdense
from clarabel_tpu_torch.kkt import dense as tdense
from test_torch_f32_psd import F32, _close, _quasidef, _t


@pytest.mark.parametrize("factor", ["df_lu", "lu"])
def test_solve_refined_with_k_lo_pair(factor):
    """Refinement against the double-float (K, K_lo): with the double-float
    LU of K_reg + K_lo ("df_lu", the f32 "lu" route) and with the plain f32
    LU of K ("lu", the aliases' route), one and two right-hand sides, a
    batch of two equal to each alone."""
    K, K_lo, R = _quasidef(6, 14, 8)
    exact = np.linalg.solve(K.astype(np.float64) + K_lo, R.astype(np.float64))
    tset = tp.port_settings(F32)
    if factor == "df_lu":
        jf, tf = jdense.factor_df(jnp.asarray(K), jnp.asarray(K_lo))[0], \
            tdense.factor_df(_t(K), _t(K_lo))[0]
    else:
        jf, tf = jdense.factor(jnp.asarray(K))[0], tdense.factor(_t(K))[0]
    for rhs in (R[:, 0], R):
        (x, x_lo), ok = tdense.solve_refined(tf, (_t(K), _t(K_lo)), _t(rhs), tset, want_lo=True)
        (jx, jx_lo), jok = jdense.solve_refined(jf, (jnp.asarray(K), jnp.asarray(K_lo)),
                                                jnp.asarray(rhs), F32, want_lo=True)
        want = exact[:, 0] if rhs.ndim == 1 else exact
        assert bool(ok) and bool(jok) and x_lo is not None
        _close(x, want, 1e-6)
        _close(np.asarray(jx), want, 1e-6)
        # the double-float solution x + x_lo to ~eps², as the JAX package's;
        # refined against K alone it misses K_lo's share
        both = lambda a, b: np.asarray(a, np.float64) + np.asarray(b, np.float64)
        _close(both(x, x_lo), want, 1e-12)
        _close(both(jx, jx_lo), want, 1e-12)
        (xk, xk_lo), _ = tdense.solve_refined(tf, _t(K), _t(rhs), tset, want_lo=True)
        err = lambda v: np.abs(v - want).max()
        assert err(both(x, x_lo)) * 100 <= err(both(xk, xk_lo))
    # a batch of two right-hand-side pairs, lane 1 the problem
    Kb, Klb = (torch.stack([_t(v).flip(0), _t(v)]) for v in (K, K_lo))
    fb = (tdense.factor_df(Kb, Klb) if factor == "df_lu" else tdense.factor(Kb))[0]
    (xb, _), _ = tdense.solve_refined(fb, (Kb, Klb), torch.stack([_t(R), _t(R)]), tset,
                                      want_lo=True)
    (x1, _), _ = tdense.solve_refined(
        (tdense.factor_df(Kb[1:], Klb[1:]) if factor == "df_lu" else tdense.factor(Kb[1:]))[0],
        (Kb[1:], Klb[1:]), _t(R)[None], tset, want_lo=True)
    assert torch.equal(xb[1], x1[0])

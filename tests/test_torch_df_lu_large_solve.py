"""The double-float LU's solve past the one-block kernels' order: the
plain twin of clarabel_tpu_torch (``kkt/df_ldl.py``'s ``solve_plain``,
which the grid-form solve kernel of ``csrc/df_lu.cu`` equals bit for bit
on a card) against the JAX package's ``solve`` through the same factor,
test_torch_df_lu_large.py's N = 545 matrix with K_lo (the port's factor of
it, which that file holds to the JAX package's), two right-hand sides.

Tolerances: within 4 f32 ulps of the largest entry (the one rounding of
(xh + xl)·s at the end, on lo streams that XLA:CPU contracts, as
tests/test_torch_df_lu.py states at N ≤ 40), and a forward error under
1e-6 (~eps_df·cond; the f32 pivoted LU's is ~eps32·cond ~ 10).  One JAX
compile (~25 s at this order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_parity as tp
from clarabel_tpu.kkt import df_ldl as jdf
from clarabel_tpu_torch.kkt import df_ldl as tdf

#: four f32 ulps at 1
ULP4 = 4 * 2.0**-23
N = tp.DF_LARGE_N


def test_solve_matches_reference_past_512():
    K = tp.df_large_matrix()
    hi, lo = tp.df_split(K)
    fac, ok = tdf.factor(torch.as_tensor(hi), torch.as_tensor(lo))
    assert bool(ok)
    rhs = np.random.default_rng(12).normal(size=(N, 2)).astype(np.float32)
    rx = np.asarray(jax.jit(jdf.solve)(tuple(jnp.asarray(f.numpy()) for f in fac),
                                       jnp.asarray(rhs)))
    x = tdf.solve(fac, torch.as_tensor(rhs)).numpy()
    assert np.isfinite(rx).all() and np.isfinite(x).all()
    assert np.abs(x - rx).max() <= ULP4 * np.abs(rx).max()
    exact = np.linalg.solve(K, rhs.astype(np.float64))
    assert np.linalg.norm(x - exact) <= 1e-6 * np.linalg.norm(exact)

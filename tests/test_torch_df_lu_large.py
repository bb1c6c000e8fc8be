"""The double-float LU's factor past the one-block kernels' order: the
plain twin of clarabel_tpu_torch (``kkt/df_ldl.py``'s ``factor_plain``,
the CPU path, which the grid-form kernel of ``csrc/df_lu.cu`` equals bit
for bit on a card) against the JAX package's double-float LU at N = 545
(past 512, not a multiple of 32 or of the factor's panel width 8), B = 1,
with K_lo, on tests/test_df_lu.py's split-scale quasidefinite matrix
(cond ~ 1e8).  The solve is held in test_torch_df_lu_large_solve.py: each
file takes one JAX compile at this order (~30 s), and a file of one or two
tests runs beside the long tests/test_df_lu.py under pytest-xdist's
loadfile scheduling.

Tolerances: the permutation and the scaling bitwise equal; every pair's
value hi + lo within 2⁻⁴⁰ of the largest hi entry, and so every lo part:
XLA:CPU contracts a product into the lo-stream sums of the jitted column
loop (an FMA, in ``_df_div``'s remainder), the port rounds every operation
(tests/test_torch_df_lu.py states the same at N ≤ 40).  The hi parts are
bitwise equal but where that contraction moves a pair across a rounding
boundary of its hi part in a renormalizing TwoSum: there hi is one f32 ulp
apart and the pair's value still within the 2⁻⁴⁰ (5 of 297,025 entries
here; none at N ≤ 40).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_parity as tp
from clarabel_tpu.kkt import df_ldl as jdf
from clarabel_tpu_torch.kkt import df_ldl as tdf


def test_factor_matches_reference_past_512():
    hi, lo = tp.df_split(tp.df_large_matrix())
    ref, rok = jax.jit(jdf.factor)(jnp.asarray(hi), jnp.asarray(lo))
    rAh, rAl, rperm, rs = (np.asarray(f) for f in ref)
    (Ah, Al, perm, s), ok = tdf.factor(torch.as_tensor(hi), torch.as_tensor(lo))
    Ah, Al = Ah.numpy(), Al.numpy()
    assert bool(ok) and bool(rok)
    np.testing.assert_array_equal(perm.numpy(), rperm)
    np.testing.assert_array_equal(s.numpy(), rs)
    bound = 2.0**-40 * np.abs(rAh).max()
    pair = (Ah.astype(np.float64) + Al) - (rAh.astype(np.float64) + rAl)
    assert np.abs(pair).max() <= bound
    assert np.abs(Al - rAl).max() <= bound
    apart = Ah != rAh
    ulp = np.spacing(np.abs(rAh[apart]))
    assert np.array_equal(np.abs(Ah[apart] - rAh[apart]), ulp)

"""The plain PyTorch version of the unblocked (K2) LDLᵀ kernel
(clarabel_tpu_torch/kkt/pallas_ldl.py) against the JAX package's Pallas
kernel in interpret mode at n = m = 80, f64 and f32, as test_torch_ldl.py
states it (its tolerances and its other shapes).  A file of two tests (the
kernel's JAX compiles at this shape), which pytest-xdist's loadfile
scheduling runs beside tests/test_df_lu.py.
"""

import numpy as np
import pytest

import test_torch_ldl as base


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,m,variant", [(80, 80, "unrolled")])
def test_factor_and_solve_match_pallas(n, m, variant, dtype):
    base.check_factor_and_solve(n, m, variant, dtype)

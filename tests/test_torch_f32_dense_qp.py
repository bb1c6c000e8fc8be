"""A whole f32 solve of a small portfolio QP through "pallas" (the LDLᵀ's
f32 twin; the JAX kernel in interpret mode) against the JAX package's f32
solve, with test_torch_f32_dense.py's tolerances.  A file of one test (one
JAX f32 compile), which pytest-xdist's loadfile scheduling runs beside
tests/test_df_lu.py.
"""

import pytest

import test_torch_f32_dense as base


@pytest.mark.parametrize("key", [("portfolio_qp", "pallas")])
def test_f32_dense_matches_reference(key):
    base.assert_solve_matches_reference(key)

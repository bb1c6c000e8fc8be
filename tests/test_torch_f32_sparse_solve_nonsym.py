"""The f32 multifrontal solves of the basic generalized power cone program
and of an entropy maximization over 8 exponential cones against the JAX
package's, as test_torch_f32_sparse_solve.py holds its other problems: a
file of two tests, which pytest-xdist's loadfile scheduling runs beside
tests/test_df_lu.py."""

import pytest

import test_torch_f32_sparse_solve as base


@pytest.mark.parametrize("name", ["genpow", "entropy"])
def test_f32_multifrontal_matches_reference(name, monkeypatch):
    base.check_f32_multifrontal(name, monkeypatch)

"""The f32 multifrontal solve of the JAX bench's banded QP at n = 200 (a
DIA recipe: the fused factor and the recipe matvec's ``.df``) against the
JAX package's, as test_torch_f32_sparse_solve.py holds its other problems:
a file of one test (one JAX f32 compile), which pytest-xdist's loadfile
scheduling runs beside tests/test_df_lu.py."""

import pytest

import test_torch_f32_sparse_solve as base


@pytest.mark.parametrize("name", ["banded_qp"])
def test_f32_multifrontal_matches_reference(name, monkeypatch):
    base.check_f32_multifrontal(name, monkeypatch)

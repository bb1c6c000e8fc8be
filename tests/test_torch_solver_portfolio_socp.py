"""Whole-solve parity of clarabel_tpu_torch with the JAX package, as
test_torch_solver_socp.py states it, on the portfolio SOCP: a file of two
tests (one problem's JAX compiles), which pytest-xdist's loadfile
scheduling deals out after the files of three or more tests, beside
tests/test_df_lu.py."""

import pytest

import _torch_parity as tp

@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["portfolio_socp"])
def test_port_matches_reference(name, method, monkeypatch):
    tp.interpret_pallas(monkeypatch)
    tp.assert_port_matches_reference(name, method)

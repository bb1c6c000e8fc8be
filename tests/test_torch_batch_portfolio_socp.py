"""The port's BatchSolver against the JAX package's, lane by lane, on the
risk-constrained portfolio SOCP (n = 8) of tests/_torch_parity.py with
B = 3 draws of the expected returns over one covariance,
through ``direct_solve_method`` "auto" and "pallas", both packages at f64 on
the CPU."""

import pytest

import _torch_parity as tp


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["portfolio_socp"])
def test_batch_matches_reference(name, method):
    tp.assert_batch_matches_reference(name, method)

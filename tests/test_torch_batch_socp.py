"""The port's BatchSolver against the JAX package's, lane by lane, on the
portfolio and second-order-cone batches: the Markowitz QP (n = 12) and the
risk-constrained SOCP (n = 8) of tests/_torch_parity.py with B = 3 draws of
the expected returns over one covariance, and the JAX bench's batched SOCP
(bench.py:156-167) at n = 6, SecondOrderConeT(7), B = 4, through
``direct_solve_method`` "auto" and "pallas", both packages at f64 on the
CPU."""

import pytest

import _torch_parity as tp

NAMES = ["portfolio_qp", "portfolio_socp", "bench_socp"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_batch_matches_reference(name, method):
    tp.assert_batch_matches_reference(name, method)

"""The port's BatchSolver against the JAX package's, lane by lane, on a batch
of one feasible and one primal-infeasible LP (test_batch.py:59-73). A file
of two tests (one problem's JAX compiles), which pytest-xdist's loadfile
scheduling runs beside tests/test_df_lu.py."""

import pytest

import _torch_parity as tp


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["mixed_status_lp"])
def test_batch_matches_reference(name, method):
    tp.assert_batch_matches_reference(name, method)

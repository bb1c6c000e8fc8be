"""The port's BatchSolver against the JAX package's, lane by lane, on
test_torch_batch.py's box QPs (B = 5, n = 4, m = 8). A file of two tests
(one problem's JAX compiles), which pytest-xdist's loadfile scheduling runs
beside tests/test_df_lu.py."""

import pytest

import _torch_parity as tp


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["box_qp"])
def test_batch_matches_reference(name, method):
    tp.assert_batch_matches_reference(name, method)

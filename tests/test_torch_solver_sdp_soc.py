"""Whole-solve parity of clarabel_tpu_torch with the JAX package, as
test_torch_solver_sdp.py states it, on the PSD + SOC mixture of
tests/test_basic_sdp.py: a file of two tests (one problem's JAX compiles),
which pytest-xdist's loadfile scheduling deals out after the files of three
or more tests, beside tests/test_df_lu.py."""

import pytest

import _torch_parity as tp

@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["sdp_mixed_with_soc"])
def test_port_matches_reference(name, method, monkeypatch):
    tp.interpret_pallas(monkeypatch)
    tp.assert_port_matches_reference(name, method)

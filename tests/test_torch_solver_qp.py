"""Whole-solve parity of clarabel_tpu_torch with the JAX package: the
QP oracle problems (tests/_torch_parity.py), through
``direct_solve_method`` "auto" (pivoted LU at f64) and "pallas" (the
quasidefinite LDLᵀ), both packages at f64 on the CPU."""

import pytest

import _torch_parity as tp

NAMES = [n for n in tp.PROBLEMS if n.startswith(('qp_',))]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_port_matches_reference(name, method):
    tp.assert_port_matches_reference(name, method)

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


@pytest.mark.parametrize("kind", ["nonnegative"])
def test_jax_files_load_in_the_port(kind, tmp_path, monkeypatch):
    """_torch_parity.check_jax_file_loads on this module's problem (a file
    the JAX package writes loads in the port): its JAX reference solves are
    this module's."""
    tp.check_jax_file_loads(kind, tmp_path, monkeypatch)

"""Whole-solve parity of clarabel_tpu_torch with the JAX package: the
SOCP and portfolio oracle problems (tests/_torch_parity.py), through
``direct_solve_method`` "auto" (pivoted LU at f64) and "pallas" (the
quasidefinite LDLᵀ), both packages at f64 on the CPU.  Here the reference's
SOCP and its infeasible variant (which share their JAX compiles), and
the JAX-file check (``_torch_parity.check_jax_file_loads``) on the SOCP
(sharing its references);
each of the others in a file of its own (test_torch_solver_socp_*.py,
test_torch_solver_portfolio_*.py), two tests each, which pytest-xdist's
loadfile scheduling runs beside tests/test_df_lu.py."""

import pytest

import _torch_parity as tp

@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", ["socp_feasible", "socp_infeasible"])
def test_port_matches_reference(name, method, monkeypatch):
    tp.interpret_pallas(monkeypatch)
    tp.assert_port_matches_reference(name, method)


@pytest.mark.parametrize("kind", ["second_order"])
def test_jax_files_load_in_the_port(kind, tmp_path, monkeypatch):
    """_torch_parity.check_jax_file_loads on this module's problem (a file
    the JAX package writes loads in the port): its JAX reference solves are
    this module's."""
    tp.check_jax_file_loads(kind, tmp_path, monkeypatch)

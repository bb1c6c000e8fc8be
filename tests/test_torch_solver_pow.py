"""Whole-solve parity of clarabel_tpu_torch with the JAX package on the
power and generalized power cones: the problems of
tests/test_basic_powcone.py (each feasible, primal infeasible and dual
infeasible), through ``direct_solve_method`` "auto" (pivoted LU at f64) and
"pallas" (the quasidefinite LDLᵀ), both packages at f64 on the CPU, under
the parity contract of tests/_torch_parity.py (the exponential cone's
problems: ``test_torch_solver_nonsym.py``).

The generalized power cones allow no primal-dual scaling, so their solves
run the dual-scaling barrier backtracking on every step.

Each problem also solves as a BatchSolver of two copies of itself, each
lane held to the JAX package's DefaultSolver under the same contract.
"""

import pytest

import _torch_parity as tp
from test_torch_solver_nonsym import _batch_lanes

NAMES = ["pow_feasible", "pow_primal_infeasible", "pow_dual_infeasible", "genpow_feasible",
         "genpow_primal_infeasible", "genpow_dual_infeasible"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_port_matches_reference(name, method):
    tp.assert_port_matches_reference(name, method)


@pytest.mark.parametrize("name, method", [(n, m) for n in NAMES for m in ("auto", "pallas")])
def test_batch_lanes_match_reference(name, method):
    pair = ("auto", "pallas")
    ref = {m: tp.lane_of(tp.reference(name, m)) for m in pair}
    for i in range(2):
        got = {m: _batch_lanes(name, m)[i] for m in pair}
        tp.assert_lane_matches(ref[method], got[method], [ref[m] for m in pair],
                               [got[m] for m in pair], optimum=tp.reference_optimum(name))


@pytest.mark.parametrize("kind", ["power", "genpower"])
def test_jax_files_load_in_the_port(kind, tmp_path, monkeypatch):
    """_torch_parity.check_jax_file_loads on this module's problems (a file
    the JAX package writes loads in the port): their JAX reference solves
    are this module's."""
    tp.check_jax_file_loads(kind, tmp_path, monkeypatch)

"""The chordal oracle problem through clarabel_tpu_torch's decomposition
held to the JAX package's solve, as test_torch_solver_chordal.py states it:
the default configuration (compact, completed dual, clique-graph merging)
cold, and a warm start through the clique transform from the JAX package's
cold solution, which shares its compile.  A file of two tests, which
pytest-xdist's loadfile scheduling runs beside tests/test_df_lu.py.
"""

import pytest

import clarabel_tpu as ct
import clarabel_tpu_torch as tt
import test_torch_solver_chordal as base
from test_torch_solver_chordal import REFERENCE_CONFIGS, _solve, _solver


@pytest.mark.parametrize("compact, complete, merge", REFERENCE_CONFIGS[:1])
def test_configs_match_reference(compact, complete, merge):
    base.check_config_matches_reference(compact, complete, merge)


def test_warm_start_through_the_transform():
    cold = _solve("jax", REFERENCE_CONFIGS[0]).solution
    start = (cold.x, cold.s, cold.z)
    ref = _solver("jax", REFERENCE_CONFIGS[0]).solve(warm_start=start)
    got = _solver("port", REFERENCE_CONFIGS[0]).solve(warm_start=start)
    assert ref.status == ct.SolverStatus.Solved and got.status == tt.SolverStatus.Solved
    assert got.iterations == ref.iterations
    assert abs(got.obj_val - ref.obj_val) <= 1e-8 * max(1.0, abs(ref.obj_val))

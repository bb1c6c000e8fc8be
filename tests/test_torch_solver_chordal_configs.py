"""The chordal oracle problem through clarabel_tpu_torch's decomposition
held to the JAX package's solve, as test_torch_solver_chordal.py states it,
under the standard transform and under no merging without completion.  A
file of two tests (each configuration's JAX compile), which pytest-xdist's
loadfile scheduling runs beside tests/test_df_lu.py.
"""

import pytest

import test_torch_solver_chordal as base


@pytest.mark.parametrize("compact, complete, merge", base.REFERENCE_CONFIGS[1:])
def test_configs_match_reference(compact, complete, merge):
    base.check_config_matches_reference(compact, complete, merge)

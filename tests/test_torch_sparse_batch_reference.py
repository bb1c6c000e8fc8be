"""The port's SparseBatchSolver against the JAX package's, lane by lane, on
test_torch_sparse_batch.py's batches (the JAX package's banded QP batch and
an NN + SOC batch on the rank-2 expansion), under the parity contract of
tests/_torch_parity.py, each lane Solved, one plan for every lane.  A file
of two tests (the JAX package's SparseBatchSolver compiles), which
pytest-xdist's loadfile scheduling runs beside tests/test_df_lu.py.
"""

import pytest

import _torch_parity as tp
import clarabel_tpu_torch as tt
from test_torch_sparse_batch import BATCHES, _port, _reference


@pytest.mark.parametrize("name", BATCHES)
def test_matches_reference(name):
    ref = _reference(name)
    solver, sol = _port(name)
    got = tp.lanes_of(solver, sol, tt.SolverStatus)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.status == tt.SolverStatus.Solved
        tp.assert_lane_matches(r, g, [r, r], [g, g])
    # one plan for every lane: the JAX package's, bucket for bucket
    assert solver.plan.nnzL > 0 and solver.iteration_history().shape == (len(got), 201, 9)

"""The port's BatchSolver against the JAX package's, lane by lane, on the
PSD triangle cone: B = 4 lanes of the JAX bench's strictly complementary
SDP (bench.py:194-256, here at n = 6: NonnegativeConeT(12) and
PSDTriangleConeT(4), KKT N = 28; each lane's PSD scaling is a [B, 1, 4, 4]
batch), through ``direct_solve_method`` "auto" and "pallas", both packages
at f64 on the CPU, under the parity contract of tests/_torch_parity.py.
This batch's solutions are pinned only loosely by the default tolerances
(``PINNED_BY_TOLERANCE``, ``OBJECTIVE_PINNED_BY_TOLERANCE`` and
``SOLUTION_PINNED_BY_SPREAD`` there say how far, and why).

test_torch_batch.py's check that a lane alone and in the batch agree to
1e-12 does not hold here: a matrix-vector product of one lane and of the
batch round apart by 1e-16 at N = 28 (torch on the CPU sums them in other
orders), and this problem's end game carries that to 2e-12 by its eighth
iteration."""

import pytest

import _torch_parity as tp


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_batch_matches_reference(method):
    tp.assert_batch_matches_reference("bench_sdp", method)

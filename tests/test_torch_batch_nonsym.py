"""The port's BatchSolver against the JAX package's, lane by lane, on the
nonsymmetric cones: B = 3 entropy maximizations over k = 3 exponential
cones, one draw of the constraints per lane, and B = 3 allocations over
k = 3 generalized power cones, one draw of the prices per lane (B = k, so
that a per-lane quantity broadcast over the cones, or the reverse, fails),
through ``direct_solve_method`` "auto" and "pallas", both packages at f64
on the CPU, under the parity contract of tests/_torch_parity.py; the
entropy lanes' x, z and s are pinned only loosely by the default
tolerances (the reference's own two backends differ beyond 1e-7), so each
entry may lie twice as far from the reference's as the reference's lies
from its own solve at 100x tighter tolerances, as in
test_torch_solver_nonsym.py.  A
generalized power cone allows no primal-dual scaling, so every step of
that batch runs the barrier backtracking under dual scaling, with each
lane's own α.  Then: a lane's result does not depend on its position or
its company (the lanes of test_torch_batch.py's check, 1e-12 relative).
The lanes against the JAX package: test_torch_batch_nonsym_entropy.py and
_genpow.py, files of two tests, which pytest-xdist's loadfile scheduling
runs beside tests/test_df_lu.py."""

import pytest

import _torch_parity as tp
import test_torch_batch as tb

NAMES = ["entropy", "genpow"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_lane_does_not_depend_on_position(name, method):
    order = [2, 0, 1]
    tb._assert_lanes_equal(tb._lanes(name, method, tuple(order)),
                           tb._lanes(name, method, take=order))
    for i in range(3):
        tb._assert_lanes_equal(tb._lanes(name, method, (i,)), tb._lanes(name, method, take=[i]))

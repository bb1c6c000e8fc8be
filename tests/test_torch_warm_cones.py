"""Warm starts of clarabel_tpu_torch against the JAX package on layouts of
their own, as test_torch_warm.py states its contract: an entropy
maximization (exponential cones) re-solved after a 1 % change of b, and
test_batch.py's batch warm start.  A file of two tests (each layout's JAX
compiles), which pytest-xdist's loadfile scheduling runs beside
tests/test_df_lu.py.
"""

import numpy as np
import pytest

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
import test_batch
from test_torch_warm import _assert_same, _both


def test_warm_start_exp_cone():
    """A warm re-solve of the entropy maximization after a 1 % change of
    its constraints' right-hand side (the exponential cones keep their warm
    iterate: the interior shift moves only the symmetric cones).  Both
    packages start from the JAX package's first solution: each package's
    own first solutions differ by up to ~1e-5 here (the solution is pinned
    only to the solver's tolerances; test_torch_solver_nonsym.py), which a
    warm start would carry into its first row."""
    P, q, A, b, cones = tp.entropy_max()
    b2 = b.copy()
    b2[-4:] *= 1.01
    settings = ct.DefaultSettings(verbose=False, presolve_enable=False)
    solvers = _both(P, q, A, b, cones, settings)
    first = solvers["jax"].solve()
    start = (first.x, first.s, first.z)
    sols = {}
    for name, s in solvers.items():
        s.update_b(b2)
        sols[name] = (s.solve(warm_start=start), s.solve())
    _assert_same({k: v[0] for k, v in sols.items()}, atol=1e-6)
    warm, cold = sols["port"]
    assert warm.status == cold.status == tt.SolverStatus.Solved
    assert abs(warm.obj_val - cold.obj_val) <= 1e-6 * max(1.0, abs(cold.obj_val))


def test_batch_warm_start():
    B = 4
    P, q, A, b, cones = test_batch.qp_batch(B, seed=7)
    settings = ct.DefaultSettings(verbose=False)
    ref = ct.BatchSolver(P, q, A, b, cones, settings)
    port = tt.BatchSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(settings),
                          device="cpu")
    out = {}
    for name, solver in (("jax", ref), ("port", port)):
        cold = solver.solve()
        out[name] = (cold, solver.solve(warm_start=cold))
    cold, warm = out["port"]
    assert all(s == tt.SolverStatus.Solved for s in warm.statuses())
    np.testing.assert_array_equal(warm.iterations, out["jax"][1].iterations)
    assert np.abs(warm.x - out["jax"][1].x).max() <= 1e-7
    assert np.allclose(warm.x, cold.x, atol=1e-6)
    assert (warm.iterations <= cold.iterations).all()
    hist = port.iteration_history()
    assert hist.shape[0] == B and hist.shape[2] == 9
    # the triple form, in the user's row order
    triple = port.solve(warm_start=(cold.x, cold.s, cold.z))
    np.testing.assert_array_equal(triple.iterations, warm.iterations)
    with pytest.raises(ValueError, match="batch dimensions"):
        port.solve(warm_start=(cold.x[:, 1:], cold.s, cold.z))

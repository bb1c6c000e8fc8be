"""Whole f32 solves of clarabel_tpu_torch on the dense KKT methods that need
the compensated f32 stack, against the JAX package's f32 solves, both on
the CPU: "auto" → "lu" → the double-float LU on test_f32_paths.py's
exponential-cone problem, "pallas" (the LDLᵀ's f32 twin;
the JAX kernel in interpret mode) on a small portfolio QP, and a B = 3
BatchSolver batch of that exponential-cone problem at three right-hand
sides through "auto" (the double-float LU, one factor per iteration for the
whole batch), each lane against the JAX package's solve of it alone.  The
Jacobi route (``factor_jacobi`` above DF_LU_MAX_DIM) is held to the JAX
package in test_torch_df_lu.py.

Tolerances, as tests/test_torch_f32.py states them: both packages run the
same f32 arithmetic and round it in other orders (XLA reassociates
reductions and contracts products into sums), and near the end of a solve
cond(K) amplifies that: the same status, iterations within 1, the
objective within 1e-4 relative (ten times the f32 gap tolerance), x and z
within 1e-3 of the larger of 1 and their largest entry (the JAX package's
own f32 tolerance, test_f32_paths.py:39).  The exponential-cone problem's
dual is pinned only by the 1e-4 tolerances: the JAX package's "auto" and
"qdldl" solves put z 1e-2 apart, on either side of the closed-form dual
z* = (-1, x* - 1, e^-x*, ...), so there the port's z is held to within
twice the JAX package's own distance from z* (or 1e-3).  A lane of the
port's batch equals the same lane solved as a batch of one, bit for bit.
One JAX compile here (the portfolio QP's in test_torch_f32_dense_qp.py, a
file of one test that pytest-xdist's loadfile scheduling runs beside
tests/test_df_lu.py; two more in test_torch_df_lu.py), each solve computed
once: the batch's three lanes share the exponential-cone problem's
compiled solve, which the JAX package caches on the layout, the settings
and the shapes.
"""

import functools

import jax
import numpy as np
import pytest

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu_torch.kkt import df_ldl

OBJ_REL, X_REL = 1e-4, 1e-3


def f32_settings(**kw):
    """test_f32_paths.py's f32 settings."""
    return ct.DefaultSettings(
        verbose=False,
        tol_gap_abs=1e-4, tol_gap_rel=1e-4, tol_feas=1e-4,
        tol_infeas_abs=1e-4, tol_infeas_rel=1e-4,
        iterative_refinement_abstol=1e-6, iterative_refinement_reltol=1e-7,
        **kw,
    )


def _expcone(x_star=5.0):
    """test_f32_paths.py's test_f32_expcone: max x s.t. y e^{x/y} ≤ z,
    y = 1, z = e^x* (its x* = 5)."""
    A = np.vstack([-np.eye(3), np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])])
    b = np.concatenate([np.zeros(3), [1.0, np.exp(x_star)]])
    return np.zeros((3, 3)), np.array([-1.0, 0.0, 0.0]), A, b, [ct.ExponentialConeT(),
                                                                ct.ZeroConeT(2)]


def z_star(x_star=5.0):
    """The closed-form dual of :func:`_expcone` (the zero cone's
    multipliers equal the exp cone's last two entries)."""
    return np.array([-1.0, x_star - 1.0, np.exp(-x_star), x_star - 1.0, np.exp(-x_star)])


#: the batch's lanes: x* = 4, 5 and 6
BATCH_X_STAR = (4.0, 5.0, 6.0)


PROBLEMS = {
    ("expcone", "auto"): (_expcone, lambda: f32_settings()),
    ("portfolio_qp", "pallas"): (
        lambda: tp._portfolio_qp(n=6, k=2, seed=3),
        lambda: ct.DefaultSettings.for_float32(verbose=False, direct_solve_method="pallas")),
    # held to the JAX package in test_torch_df_lu.py: the plain f32 LU, and
    # "lu" with DF_LU_MAX_DIM at 0 in both packages (the Jacobi LU)
    ("expcone", "qdldl"): (_expcone, lambda: f32_settings(direct_solve_method="qdldl")),
    ("expcone", "jacobi"): (_expcone, lambda: f32_settings(direct_solve_method="lu")),
}


@functools.cache
def _reference(key, *args):
    make, settings = PROBLEMS[key]
    solver = ct.DefaultSolver(*make(*args), settings(), dtype="float32",
                              device=jax.devices("cpu")[0])
    solver.solve()
    return solver


def reference(key, *args):
    """The JAX package's f32 solve (of ``make(*args)``), its Pallas kernel
    in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        tp.interpret_pallas(mp)
        return _reference(key, *args)


@functools.cache
def port(key):
    make, settings = PROBLEMS[key]
    P, q, A, b, cones = make()
    solver = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(settings()),
                              dtype="float32", device="cpu")
    solver.solve()
    return solver


def assert_f32_close(got, ref, z_star=None):
    """``got`` and ``ref``: (status, iterations, obj_val, x, z) of a solve or
    lane; ``z_star`` the exact dual where the tolerances leave z loose."""
    status, iters, obj, x, z = got
    rstatus, riters, robj, rx, rz = ref
    assert int(status) == int(rstatus)
    assert abs(iters - riters) <= 1
    assert abs(obj - robj) <= OBJ_REL * max(1.0, abs(robj))
    scale = lambda v: X_REL * max(1.0, np.abs(v).max())
    assert np.abs(x - rx).max() <= scale(rx)
    if z_star is None:
        assert np.abs(z - rz).max() <= scale(rz)
    else:
        assert np.abs(z - z_star).max() <= max(2 * np.abs(rz - z_star).max(), scale(z_star))


def _outcome(solver):
    s = solver.solution
    return s.status, s.iterations, s.obj_val, s.x, s.z


def assert_solve_matches_reference(key):
    got, ref = port(key), reference(key)
    assert got.solution.status == tt.SolverStatus.Solved
    assert_f32_close(_outcome(got), _outcome(ref),
                     z_star() if key[0] == "expcone" else None)
    assert got.info.linear_solver.name == ref.info.linear_solver.name


@pytest.mark.parametrize("key", [("expcone", "auto")])
def test_f32_dense_matches_reference(key):
    assert_solve_matches_reference(key)


def test_auto_routes_exp_to_the_double_float_lu(monkeypatch):
    """At f32 "auto" resolves an exponential-cone layout to "lu", and "lu"
    factors with the double-float LU once per iteration; its aliases take
    the plain pivoted LU (the JAX package's loop.py:764-781)."""
    calls = []
    factor = df_ldl.factor
    monkeypatch.setattr(df_ldl, "factor", lambda *a, **k: calls.append(1) or factor(*a, **k))
    P, q, A, b, cones = _expcone()
    for method, df_calls in (("auto", True), ("lu", True), ("qdldl", False), ("dense", False),
                             ("faer", False)):
        calls.clear()
        s = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones),
                             tp.port_settings(f32_settings(direct_solve_method=method)),
                             dtype="float32", device="cpu")
        sol = s.solve()
        assert sol.status == tt.SolverStatus.Solved, method
        assert len(calls) == (sol.iterations if df_calls else 0), method


def _batch():
    lanes = [_expcone(x) for x in BATCH_X_STAR]
    P, q, A, b = (np.stack([lane[j] for lane in lanes]) for j in range(4))
    return P, q, A, b, lanes[0][4]


def batch_reference(i):
    """The JAX package's f32 solve of lane ``i`` alone: the same problem,
    settings and compiled solve as ("expcone", "auto"), at x* of lane i."""
    x_star = BATCH_X_STAR[i]
    return reference(("expcone", "auto"), *(() if x_star == 5.0 else (x_star,)))


@functools.cache
def batch_port(lanes=None):
    P, q, A, b, cones = _batch()
    if lanes is not None:
        P, q, A, b = (v[list(lanes)] for v in (P, q, A, b))
    solver = tt.BatchSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(f32_settings()),
                            dtype="float32", device="cpu")
    return solver, solver.solve()


def _lane(sol, i):
    return sol.status[i], sol.iterations[i], sol.obj_val[i], sol.x[i], sol.z[i]


def test_f32_exp_batch_matches_reference_lane_by_lane():
    _, got = batch_port()
    assert all(s == tt.SolverStatus.Solved for s in got.statuses())
    for i, x_star in enumerate(BATCH_X_STAR):
        assert_f32_close(_lane(got, i), _outcome(batch_reference(i)), z_star(x_star))
        assert abs(got.x[i][0] - x_star) <= 1e-2


def test_f32_exp_batch_lane_equals_its_solve_alone(monkeypatch):
    """Each lane computes what it does alone (a batch of one), bit for bit:
    the compensated residuals, dots and Δτ sums reduce over each lane's own
    last dimension.  One double-float factor per iteration serves every
    lane."""
    solver, sol = batch_port()
    for i in range(len(sol.status)):
        _, alone = batch_port((i,))
        for f in ("status", "iterations", "x", "z", "s", "obj_val"):
            np.testing.assert_array_equal(getattr(sol, f)[i], getattr(alone, f)[0], err_msg=f)
    calls = []
    factor = df_ldl.factor
    monkeypatch.setattr(df_ldl, "factor", lambda K, *a, **k: calls.append(K.shape) or factor(
        K, *a, **k))
    again = solver.solve()
    assert len(calls) == int(again.iterations.max())
    assert all(shape[0] == len(sol.status) for shape in calls)

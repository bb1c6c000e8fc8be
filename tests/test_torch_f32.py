"""f32 solves of clarabel_tpu_torch through the structured Schur paths
against the JAX package's f32 solves, both on the CPU: the Schur cases of
the JAX package's test_f32_paths.py and test_schur_lowrank.py, and the JAX
bench's box-QP batch at a reduced size.

Tolerances.  Both packages run the same f32 arithmetic and round it in other
orders (XLA reassociates reductions), and near the end of a solve cond(K)
amplifies that: the port is held to the same status, an iteration count
within 1, the objective within 1e-4 relative (ten times the for_float32 gap
tolerance; the JAX package's own f32-vs-f64 anchor is 1e-3,
test_schur_lowrank.py:151) and x within 1e-3 of the larger of 1 and |x|∞
(the JAX package's own f32 x tolerance, test_f32_paths.py:39); an
infeasibility certificate, scaled to unit inf-norm, within 5e-3 (its lane
tolerance, test_schur_lowrank.py:216).  Every reference result is computed
once per module.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt

OBJ_REL, X_REL, CERT = 1e-4, 1e-3, 5e-3


def test_for_float32_matches_reference():
    """The port's f32 preset is the JAX package's, field for field."""
    assert (dataclasses.asdict(tt.DefaultSettings.for_float32(verbose=False))
            == dataclasses.asdict(ct.DefaultSettings.for_float32(verbose=False)))


def f32_settings(**kw):
    """test_f32_paths.py's f32 settings."""
    return ct.DefaultSettings(
        verbose=False,
        tol_gap_abs=1e-4, tol_gap_rel=1e-4, tol_feas=1e-4,
        tol_infeas_abs=1e-4, tol_infeas_rel=1e-4,
        iterative_refinement_abstol=1e-6, iterative_refinement_reltol=1e-7,
        **kw,
    )


def _eq_constrained():
    A1 = np.array([[0.0, 1.0, 1.0], [0.0, 1.0, -1.0]])
    A = np.vstack([A1, np.eye(3), -np.eye(3)])
    b = np.concatenate([[2.0, 0.0], 5 * np.ones(6)])
    return np.eye(3), np.zeros(3), A, b, [ct.ZeroConeT(2), ct.NonnegativeConeT(6)]


def _infeasible_lp():
    A = 2.0 * np.vstack([np.eye(3), -np.eye(3)])
    b = np.ones(6)
    b[0] = -1.0
    b[3] = -1.0
    return np.zeros((3, 3)), np.array([3.0, -2.0, 1.0]), A, b, [ct.NonnegativeConeT(6)]


def _socp():
    P = np.array([
        [1.4652521089139698, 0.6137176286085666, -1.1527861771130112],
        [0.6137176286085666, 2.219109946678485, -1.4400420548730628],
        [-1.1527861771130112, -1.4400420548730628, 1.6014483534926371],
    ])
    A = np.vstack([2.0 * np.eye(3), -2.0 * np.eye(3), np.eye(3)])
    b = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    return P, np.array([0.1, -2.0, 1.0]), A, b, [ct.NonnegativeConeT(6), ct.SecondOrderConeT(3)]


def _ill_scaled_equalities():
    """An equality block with a 1e4 scale spread and a nearly dependent row
    (test_f32_paths.py:113-135)."""
    rng = np.random.default_rng(7)
    n = 12
    M = rng.normal(size=(n, n)) / np.sqrt(n)
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    G = rng.normal(size=(3, n))
    G[0] *= 1e4
    G[2] = G[1] * (1.0 + 1e-6)
    h = G @ rng.normal(size=n) * 0.1
    A = np.vstack([G, np.eye(n), -np.eye(n)])
    b = np.concatenate([h, np.ones(2 * n)])
    return P, q, A, b, [ct.ZeroConeT(3), ct.NonnegativeConeT(2 * n)]


PROBLEMS = {
    "eq_constrained": (_eq_constrained, f32_settings),
    "infeasible_lp": (_infeasible_lp, f32_settings),
    "socp": (_socp, f32_settings),
    "ill_scaled_equalities": (_ill_scaled_equalities,
                              lambda: ct.DefaultSettings.for_float32(verbose=False)),
    "random_socp": (lambda: tp._random_socp(np.random.default_rng(200)),
                    lambda: ct.DefaultSettings.for_float32(verbose=False)),
}


@functools.cache
def solved(name, package, dtype="float32"):
    """Problem ``name`` solved by ``package`` ("jax" or "port") on the CPU
    at ``dtype``, with its f32 settings (the f64 defaults at f64)."""
    make, settings = PROBLEMS[name]
    P, q, A, b, cones = make()
    s = settings() if dtype == "float32" else ct.DefaultSettings(verbose=False)
    if package == "jax":
        solver = ct.DefaultSolver(P, q, A, b, cones, s, dtype=dtype,
                                  device=jax.devices("cpu")[0])
    else:
        solver = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(s),
                                  dtype=dtype, device="cpu")
    solver.solve()
    return solver


def assert_f32_close(got, ref):
    """Hold the port's f32 solution to the JAX package's (module docstring)."""
    assert got.status.name == ref.status.name
    assert abs(got.iterations - ref.iterations) <= 1
    if ref.status == ct.SolverStatus.PrimalInfeasible:
        unit = lambda v: v / np.max(np.abs(v))
        assert np.max(np.abs(unit(got.z) - unit(ref.z))) <= CERT
        return
    assert abs(got.obj_val - ref.obj_val) <= OBJ_REL * max(1.0, abs(ref.obj_val))
    scale = max(1.0, float(np.max(np.abs(ref.x))))
    assert np.max(np.abs(got.x - ref.x)) <= X_REL * scale


@pytest.mark.parametrize("name, method", [
    ("eq_constrained", "schur_diag"),
    ("infeasible_lp", "schur_diag"),
    ("socp", "schur_lr"),
    ("random_socp", "schur_lr"),
])
def test_f32_auto_matches_reference(name, method):
    """test_f32_eq_constrained_schur_diag (equality rows on the δ-proxy),
    test_f32_infeasibility_certificate, test_f32_socp_schur (auto picks
    schur_lr on an SOC layout) and one seed of
    test_f32_socp_schur_lr_end_to_end, through the port's "auto"."""
    got, ref = solved(name, "port"), solved(name, "jax")
    assert got.info.linear_solver.name == ref.info.linear_solver.name == method
    assert_f32_close(got.solution, ref.solution)


def test_f32_reaches_the_reference_tests_oracles():
    """The JAX package's own f32 assertions, on the port's solves: the
    equality-constrained QP at x = (0, 1, 1), the SOCP at -0.8459 and the
    random SOCP within 1e-3 of the f64 LU objective."""
    eq = solved("eq_constrained", "port").solution
    assert eq.status == tt.SolverStatus.Solved
    assert np.linalg.norm(eq.x - np.array([0.0, 1.0, 1.0])) <= 1e-3
    assert abs(solved("socp", "port").solution.obj_val - (-0.8459)) <= 1e-3
    assert solved("infeasible_lp", "port").solution.status == tt.SolverStatus.PrimalInfeasible
    lr, lu = solved("random_socp", "port").solution, solved("random_socp", "port", "float64").solution
    assert lr.status == lu.status == tt.SolverStatus.Solved
    assert abs(lr.obj_val - lu.obj_val) <= 1e-3 * max(1.0, abs(lu.obj_val))


def test_f32_schur_diag_ill_scaled_equalities():
    """test_f32_paths.py:113-162 on the port: its f32 schur_diag either
    reaches the LU solution with the equality rows satisfied, or fails
    loudly -- never a silently wrong Solved.  The oracle is the JAX
    package's f64 LU solution: its f32 LU runs the double-float
    factorization, which alone takes over a minute on the CPU."""
    got = solved("ill_scaled_equalities", "port")
    lu = solved("ill_scaled_equalities", "jax", "float64").solution
    assert got.info.linear_solver.name == "schur_diag"
    assert lu.status == ct.SolverStatus.Solved
    sol = got.solution
    if sol.status in (tt.SolverStatus.Solved, tt.SolverStatus.AlmostSolved):
        P, q, A, b, _ = _ill_scaled_equalities()
        G, h = A[:3], b[:3]
        assert np.max(np.abs(sol.x - lu.x)) < 5e-3
        assert np.max(np.abs(G @ sol.x - h) / np.maximum(1, np.abs(h))) < 1e-3
    else:
        assert sol.status in (tt.SolverStatus.NumericalError,
                              tt.SolverStatus.InsufficientProgress)


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------


def _socp_batch(B=4):
    """test_schur_lowrank.py:192-200: one random SOCP, q shifted per lane."""
    P, q, A, b, cones = tp._random_socp(np.random.default_rng(3))
    tile = lambda v: np.stack([v] * B)
    return tile(P), np.stack([q + 0.01 * i for i in range(B)]), tile(A), tile(b), cones


def _box_qp_batch(B=4, n=8, seed=0):
    """The JAX bench's batched box QP (bench.py:75-82) at B = 4, n = 8:
    P = MMᵀ/n + I/2, -1 ≤ x ≤ 1."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n)
    A = np.tile(np.vstack([np.eye(n), -np.eye(n)]), (B, 1, 1))
    return P, rng.normal(size=(B, n)), A, np.ones((B, 2 * n)), [ct.NonnegativeConeT(2 * n)]


BATCHES = {"socp": _socp_batch, "box_qp": _box_qp_batch}


@functools.cache
def batch_solved(name, package):
    P, q, A, b, cones = BATCHES[name]()
    s = ct.DefaultSettings.for_float32(verbose=False)
    if package == "jax":
        return ct.BatchSolver(P, q, A, b, cones, s, dtype="float32",
                              device=jax.devices("cpu")[0]).solve()
    return tt.BatchSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(s),
                          dtype="float32", device="cpu").solve()


@pytest.mark.parametrize("name", list(BATCHES))
def test_f32_batch_matches_reference(name):
    """Every lane Solved and held to the JAX BatchSolver's lane."""
    got, ref = batch_solved(name, "port"), batch_solved(name, "jax")
    assert all(s == tt.SolverStatus.Solved for s in got.statuses()), got.statuses()
    for i in range(len(ref.status)):
        lane = lambda sol: tp.Lane(sol.statuses()[i], int(sol.iterations[i]), sol.x[i],
                                   sol.z[i], sol.s[i], float(sol.obj_val[i]),
                                   float(sol.obj_val_dual[i]), None)
        assert_f32_close(lane(got), lane(ref))


def test_batched_socp_lane_matches_single_solve():
    """test_batched_socp_through_schur_lr: lane 0 of the port's batch against
    the port's own single solve (presolve off, as a batch runs), within the
    JAX package's 5e-3."""
    P, q, A, b, cones = _socp_batch()
    single = tt.DefaultSolver(
        P[0], q[0], A[0], b[0], tp.port_cones(cones),
        tp.port_settings(ct.DefaultSettings.for_float32(verbose=False, presolve_enable=False)),
        dtype="float32", device="cpu").solve()
    np.testing.assert_allclose(batch_solved("socp", "port").x[0], single.x, atol=5e-3)

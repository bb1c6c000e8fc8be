"""Data updates, settings updates, termination callbacks and warm starts of
clarabel_tpu_torch against the JAX package, at f64 on the CPU: the dense
cases of tests/test_data_updating.py, the callback, update_settings and
warm-start cases of tests/test_api_misc.py, test_batch.py's batch warm
start, and a warm start of an entropy maximization (exponential cones).

Each case applies the same calls to a solver of each package.  Held to:
the same status and the same iteration count (warm starts included), and
x within 1e-7 of the JAX package's (1e-7 absolute: these problems are well
conditioned, and both packages factor with the same pivoted LU); besides,
each of test_data_updating.py's own checks, on the port: the updated solve
within 1e-7 of a fresh solve of the updated data (1e-9 for the no-ops)."""

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
import test_batch
import test_data_updating as tdu
from clarabel_tpu_torch.timers import host_read

PKGS = {"jax": ct, "port": tt}


def _solver(pkg, P, q, A, b, cones, settings):
    if pkg is ct:
        return ct.DefaultSolver(P, q, A, b, cones, settings)
    return tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(settings),
                            device="cpu")


def _both(P, q, A, b, cones, settings):
    return {name: _solver(pkg, P, q, A, b, cones, settings) for name, pkg in PKGS.items()}


def _assert_same(sols, atol=1e-7):
    j, p = sols["jax"], sols["port"]
    assert p.status.name == j.status.name
    assert p.iterations == j.iterations
    assert np.linalg.norm(p.x - j.x) <= atol


# -----------------------------------------------------------------
# data updating (test_data_updating.py)
# -----------------------------------------------------------------


def _P2():
    P, *_ = tdu.updating_data()
    P2 = P.copy()
    P2[0, 0] = 100.0
    return P2


def _A2():
    _, _, A, *_ = tdu.updating_data()
    A2 = A.copy()
    A2[1, 1] = -1000.0
    return A2


# case -> (the forms P and A take at construction, whether to solve before
# the update, the update, the updated data as (P, q, A, b))
UPDATES = {
    "P_matrix_form": ("dense", True, lambda s: s.update_P(_P2()),
                      lambda P, q, A, b: (_P2(), q, A, b)),
    "P_vector_form": ("sparse", True, lambda s: s.update_P(np.array([100.0, 1.0, 20000.0])),
                      lambda P, q, A, b: (_P2(), q, A, b)),
    "P_tuple": ("sparse", True, lambda s: s.update_P((np.array([1, 2]), np.array([3.0, 5.0]))),
                lambda P, q, A, b: (np.array([[P[0, 0], 3.0], [3.0, 5.0]]), q, A, b)),
    "A_matrix_form": ("dense", False, lambda s: s.update_A(_A2()),
                      lambda P, q, A, b: (P, q, _A2(), b)),
    "A_tuple": ("sparse", True, lambda s: s.update_A((np.array([2]), np.array([-1000.0]))),
                lambda P, q, A, b: (P, q, _A2(), b)),
    "A_vector_form": ("sparse", True,
                      lambda s: s.update_A(np.array([-1.0, -1000.0, -1.0, 1.0])),
                      lambda P, q, A, b: (P, q, _A_vec(A), b)),
    "q_and_b": ("dense", True,
                lambda s: (s.update_q(np.array([500.0, -200.0])),
                           s.update_b(np.array([2.0, 1.0, 3.0, 1.0]))),
                lambda P, q, A, b: (P, np.array([500.0, -200.0]), A, np.array([2.0, 1.0, 3.0, 1.0]))),
    "b_tuple": ("dense", False, lambda s: s.update_b((np.array([0, 2]), np.array([0.5, 2.0]))),
                lambda P, q, A, b: (P, q, A, np.array([0.5, 1.0, 2.0, 1.0]))),
    "q_tuple": ("dense", True, lambda s: s.update_q(([1], [-1000.0])),
                lambda P, q, A, b: (P, np.array([q[0], -1000.0]), A, b)),
    "combined": ("dense", False, lambda s: s.update_data(P=_P2(), b=2.0 * np.ones(4)),
                 lambda P, q, A, b: (_P2(), q, A, 2.0 * b)),
    # P -> 0 switches the start to the LP initialization, and back
    "P_to_zero_and_back": ("dense", True,
                           lambda s: (s.update_P(np.zeros((2, 2))), s.solve(), s.update_P(_P2())),
                           lambda P, q, A, b: (_P2(), q, A, b)),
}


def _A_vec(A):
    """test_data_updating.py's A_vector_form update: the second nonzero of
    A in CSC order set to -1000."""
    A2 = sp.csc_matrix(A)
    A2.data[1] = -1000.0
    return A2.toarray()


@pytest.mark.parametrize("case", list(UPDATES))
def test_update_matches_reference(case):
    form, solve_first, update, updated = UPDATES[case]
    P, q, A, b, cones, settings = tdu.updating_data()
    if form == "sparse":
        P, A = sp.csc_matrix(P), sp.csc_matrix(A)
    solvers = _both(P, q, A, b, cones, settings)
    for s in solvers.values():
        if solve_first:
            s.solve()
        update(s)
    sols = {k: s.solve() for k, s in solvers.items()}
    _assert_same(sols)
    P0, q0, A0, b0, *_ = tdu.updating_data()
    fresh = _solver(tt, *updated(P0, q0, A0, b0), cones, settings).solve()
    assert np.linalg.norm(sols["port"].x - fresh.x) <= 1e-7


def test_update_noops():
    P, q, A, b, cones, settings = tdu.updating_data()
    empty = (np.zeros(0, np.int64), np.zeros(0))
    for name, s in _both(P, q, A, b, cones, settings).items():
        s0 = s.solve()
        s.update_P(empty)
        s.update_A(empty)
        s.update_q(empty)
        s.update_b(empty)
        s1 = s.solve()
        assert np.linalg.norm(s1.x - s0.x) <= 1e-9, name
        assert s1.iterations == s0.iterations


@pytest.mark.parametrize("b0", [1e30, 1e21])
def test_update_rejected_after_presolve(b0):
    """A row presolve removes forbids updates (test_data_updating.py's two
    rejection cases); without a removed row, updates stay allowed."""
    P, q, A, b, cones, _ = tdu.updating_data()
    settings = ct.DefaultSettings(verbose=False, presolve_enable=True)
    b2 = b.copy()
    b2[0] = b0
    for name, s in _both(P, q, A, b2, cones, settings).items():
        assert not s.is_data_update_allowed(), name
        with pytest.raises(ValueError):
            s.update_b(b)
    ok = _both(P, q, A, b, cones, settings)
    for s in ok.values():
        assert s.is_data_update_allowed()
        s.update_q(np.zeros(2))
    _assert_same({k: s.solve() for k, s in ok.items()})


# -----------------------------------------------------------------
# callbacks and settings (test_api_misc.py)
# -----------------------------------------------------------------


def _tiny_qp():
    return np.eye(1), np.zeros(1), np.eye(1), np.ones(1), [ct.NonnegativeConeT(1)]


def test_termination_callback():
    P, q, A, b, cones = _tiny_qp()
    solvers = _both(P, q, A, b, cones, ct.DefaultSettings(verbose=False))
    for s in solvers.values():
        s.set_termination_callback(lambda info: info.iterations >= 3)
    sols = {k: s.solve() for k, s in solvers.items()}
    assert sols["port"].status == tt.SolverStatus.CallbackTerminated
    _assert_same(sols)
    for s in solvers.values():
        s.unset_termination_callback()
    sols = {k: s.solve() for k, s in solvers.items()}
    assert sols["port"].status == tt.SolverStatus.Solved
    _assert_same(sols)


def test_callback_with_state():
    P, q, A, b, cones = _tiny_qp()
    calls = {}
    sols = {}
    for name, s in _both(P, q, A, b, cones, ct.DefaultSettings(verbose=False)).items():
        calls[name] = []
        s.set_termination_callback(
            lambda info, c=calls[name]: (c.append(info.iterations), len(c) >= 2)[1])
        sols[name] = s.solve()
    assert sols["port"].status == tt.SolverStatus.CallbackTerminated
    assert calls["port"] == calls["jax"] == [0, 1]
    _assert_same(sols)


def test_callback_costs_one_read_per_iteration():
    """Without a callback the solve reads the device as often as before;
    a callback adds exactly one read per pass of the loop (the iterations
    and the final check)."""
    P, q, A, b, cones = tp.PROBLEMS["exp_feasible"]()
    solver = _solver(tt, P, q, A, b, cones, ct.DefaultSettings(verbose=False))
    host_read.count = 0
    cold = solver.solve()
    without = host_read.count
    passes = []
    solver.set_termination_callback(lambda info: passes.append(info.iterations) and False)
    host_read.count = 0
    sol = solver.solve()
    assert sol.status == cold.status == tt.SolverStatus.Solved
    assert sol.iterations == cold.iterations
    assert len(passes) == cold.iterations + 1
    assert host_read.count == without + len(passes)


def test_update_settings():
    P, q, A, b, cones = _tiny_qp()
    solvers = _both(P, q, A, b, cones, ct.DefaultSettings(verbose=False))
    for s in solvers.values():
        s.update_settings(type(s.settings)(verbose=False, max_iter=1))
    sols = {k: s.solve() for k, s in solvers.items()}
    assert sols["port"].status == tt.SolverStatus.MaxIterations
    _assert_same(sols)
    with pytest.raises(tt.SettingsError):
        solvers["port"].update_settings(tt.DefaultSettings(verbose=False, presolve_enable=False))


# -----------------------------------------------------------------
# warm starts (test_api_misc.py, test_batch.py)
# -----------------------------------------------------------------


def test_warm_start():
    rng = np.random.default_rng(0)
    n = 8
    M = rng.normal(size=(n, n)) / np.sqrt(n)
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.ones(2 * n)
    cones = [ct.NonnegativeConeT(2 * n)]
    settings = ct.DefaultSettings(verbose=False, presolve_enable=False)
    q2 = q + 0.01 * rng.normal(size=n)
    warm, cold = {}, {}
    for name, s in _both(P, q, A, b, cones, settings).items():
        first = s.solve()
        s.update_q(q2)
        warm[name] = s.solve(warm_start=first)
        cold[name] = s.solve()
    _assert_same(warm)
    _assert_same(cold)
    assert warm["port"].status == tt.SolverStatus.Solved
    assert np.allclose(warm["port"].x, cold["port"].x, atol=1e-6)
    assert warm["port"].iterations <= cold["port"].iterations


def test_warm_start_cuts_iterations():
    rng = np.random.default_rng(7)
    n = 60
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.normal(size=n)
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.ones(2 * n)
    cones = [ct.NonnegativeConeT(2 * n)]
    settings = ct.DefaultSettings(verbose=False)
    sols = {}
    for name, s in _both(P, q, A, b, cones, settings).items():
        cold = s.solve()
        sols[name] = (cold, s.solve(warm_start=(cold.x, cold.s, cold.z)))
    _assert_same({k: v[1] for k, v in sols.items()})
    cold, warm = sols["port"]
    assert warm.status == tt.SolverStatus.Solved
    assert warm.iterations < cold.iterations
    assert warm.obj_val == pytest.approx(cold.obj_val, abs=1e-7)
    with pytest.raises(ValueError, match="dimensions"):
        _solver(tt, P, q, A, b, cones, settings).solve(warm_start=(cold.x[1:], cold.s, cold.z))


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

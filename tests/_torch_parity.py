"""Shared helpers of the ``test_torch_*`` parity tests: the oracle problems
of the basic suites, and the contract a solve of the port is held to
against the JAX package (:func:`assert_port_matches_reference`).

Each problem is built as numpy data from the basic suites' own builders
(``test_basic_*.py``), so the port is held to exactly the problems the JAX
package is.  The JAX side runs its Pallas LDLᵀ kernel in interpret mode,
as the JAX package's own CPU runs do.
"""

import dataclasses
import functools

import numpy as np

import clarabel_tpu as ct
import clarabel_tpu.kkt.pallas_ldl as jax_pallas_ldl
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import convert

import test_basic_lp
import test_basic_qp
import test_basic_socp
import test_basic_eq_and_unconstrained as test_basic_eq


def _lp_primal_infeasible():
    P, q, A, b, cones = test_basic_lp.lp_data()
    b[0] = -1.0
    b[3] = -1.0
    return P, q, A, b, cones


def _lp_dual_infeasible():
    P, _, A, b, cones = test_basic_lp.lp_data()
    A[3, 0] = 1.0
    return P, np.array([1.0, 0.0, 0.0]), A, b, cones


def _lp_dual_infeasible_ill_cond():
    P, _, A, b, cones = test_basic_lp.lp_data()
    A[0, 0] = np.finfo(np.float64).eps
    A[3, 0] = 0.0
    return P, np.array([1.0, 0.0, 0.0]), A, b, cones


def _qp_primal_infeasible():
    P, q, A, b, cones = test_basic_qp.qp_data()
    b[0] = -1.0
    b[3] = -1.0
    return P, q, A, b, cones


def _qp_dual_infeasible_ill_cond():
    P, q, _, _, _ = test_basic_qp.qp_data_dual_inf()
    return P, q, np.array([[1.0, 1.0]]), np.array([1.0]), [ct.NonnegativeConeT(1)]


def _qp_singleton_soc():
    P, q, A, b, _ = test_basic_qp.qp_data()
    return P, q, A, b, [ct.SecondOrderConeT(1)] * 6


def _socp_mixed_dims():
    P, q, A, b, _ = test_basic_socp.socp_data()
    return P, q, A, b, [ct.NonnegativeConeT(3), ct.SecondOrderConeT(6)]


def _socp_infeasible():
    P, q, A, b, cones = test_basic_socp.socp_data()
    b[6] = -10.0
    return P, q, A, b, cones


def _eq(P, q, A, b, cones):
    return lambda: (P, np.asarray(q, float), A, np.asarray(b, float), cones)


def _portfolio_qp(n=24, k=3, seed=0):
    """Markowitz long-only portfolio: min ½xᵀ(γΣ)x − μᵀx, 1ᵀx = 1, x ≥ 0,
    Σ = F Fᵀ + D (Boyd & Vandenberghe §4.4.1)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, k)) / np.sqrt(k)
    D = rng.uniform(0.05, 0.2, size=n)
    mu = rng.normal(0.05, 0.1, size=n)
    P = 2.0 * (F @ F.T + np.diag(D))
    A = np.vstack([np.ones((1, n)), -np.eye(n)])
    b = np.concatenate([[1.0], np.zeros(n)])
    return P, -mu, A, b, [ct.ZeroConeT(1), ct.NonnegativeConeT(n)]


def _portfolio_socp(n=16, k=3, sigma=0.25, seed=1):
    """Risk-constrained portfolio: max μᵀx s.t. 1ᵀx = 1, x ≥ 0,
    ‖[Fᵀx; D^{1/2}x]‖₂ ≤ σ."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, k)) / np.sqrt(k)
    D = rng.uniform(0.05, 0.2, size=n)
    mu = rng.normal(0.05, 0.1, size=n)
    A = np.vstack([
        np.ones((1, n)),
        -np.eye(n),
        np.zeros((1, n)),
        -F.T,
        -np.diag(np.sqrt(D)),
    ])
    b = np.concatenate([[1.0], np.zeros(n), [sigma], np.zeros(k + n)])
    cones = [ct.ZeroConeT(1), ct.NonnegativeConeT(n), ct.SecondOrderConeT(1 + k + n)]
    return np.zeros((n, n)), -mu, A, b, cones


PROBLEMS = {
    "lp_feasible": test_basic_lp.lp_data,
    "lp_primal_infeasible": _lp_primal_infeasible,
    "lp_dual_infeasible": _lp_dual_infeasible,
    "lp_dual_infeasible_ill_cond": _lp_dual_infeasible_ill_cond,
    "qp_univariate": _eq(np.eye(1), [0.0], np.eye(1), [1.0], [ct.NonnegativeConeT(1)]),
    "qp_feasible": test_basic_qp.qp_data,
    "qp_singleton_soc": _qp_singleton_soc,
    "qp_primal_infeasible": _qp_primal_infeasible,
    "qp_dual_infeasible": test_basic_qp.qp_data_dual_inf,
    "qp_dual_infeasible_ill_cond": _qp_dual_infeasible_ill_cond,
    "socp_feasible": test_basic_socp.socp_data,
    "socp_feasible_mixed_dims": _socp_mixed_dims,
    "socp_infeasible": _socp_infeasible,
    "eq_feasible": _eq(np.eye(3), np.zeros(3), test_basic_eq.A1, [2.0, 0.0],
                       [ct.ZeroConeT(2)]),
    "eq_primal_infeasible": _eq(np.eye(3), np.zeros(3), test_basic_eq.A2,
                                np.ones(4), [ct.ZeroConeT(4)]),
    "eq_dual_infeasible": _eq(np.diag([0.0, 1.0, 1.0]), np.ones(3), test_basic_eq.A1,
                              [2.0, 0.0], [ct.ZeroConeT(2)]),
    "unconstrained_feasible": _eq(np.eye(3), [1.0, 2.0, -3.0], np.zeros((0, 3)),
                                  np.zeros(0), []),
    "unconstrained_dual_infeasible": _eq(np.zeros((3, 3)), [1.0, 0.0, 0.0],
                                         np.zeros((0, 3)), np.zeros(0), []),
    "portfolio_qp": _portfolio_qp,
    "portfolio_socp": _portfolio_socp,
}


def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas LDLᵀ in interpret mode (the CPU has no
    TPU); nothing in the JAX package changes."""
    monkeypatch.setattr(
        jax_pallas_ldl, "make_ldl_factor",
        functools.partial(jax_pallas_ldl.make_ldl_factor, interpret=True),
    )


@functools.cache
def reference(name, method):
    """The JAX package's solver for problem ``name``, after its solve.  The
    caller runs it with the Pallas kernel in interpret mode."""
    P, q, A, b, cones = PROBLEMS[name]()
    settings = ct.DefaultSettings(verbose=False, direct_solve_method=method)
    ref = ct.DefaultSolver(P, q, A, b, cones, settings)
    ref.solve()
    return ref


@functools.cache
def port(name, method):
    """The port's solver for problem ``name`` on the CPU, after its solve,
    built through ``convert`` from the JAX package's settings and cones."""
    P, q, A, b, cones = PROBLEMS[name]()
    settings = ct.DefaultSettings(verbose=False, direct_solve_method=method)
    solver = tt.DefaultSolver(
        P, q, A, b,
        convert.cones_from_specs(convert.cone_specs(cones)),
        convert.settings_from_dict(dataclasses.asdict(settings)),
        device="cpu",
    )
    solver.solve()
    return solver


def _direction(v):
    return v / max(float(np.max(np.abs(v), initial=0.0)), 1e-300)


def assert_port_matches_reference(name, method):
    """Solve problem ``name`` through both packages and hold the port to
    the reference.

    Always: the same status and KKT backend name.  Solved: x, z and s
    within 1e-7 of the reference's inf-norm (at least 1) and the objectives
    within 1e-9 relative.

    What comes out of an ill-conditioned KKT system is held to the
    packages' own reproducibility: the *spread*, the larger of the two
    packages' differences between their own two KKT backends (pivoted LU
    and the LDLᵀ) on the same problem.  The backends sum in different
    orders, and near the end of a solve -- or all along, for a certificate
    of infeasibility -- cond(K) amplifies that rounding.  Where the
    reference's backends agree on the iteration count, the port's count is
    equal; every history row before the terminating one lies within
    1e-6·|ref| + 1e-10 + 2·spread of the reference's (1e-10 is 100x below
    the 1e-8 tolerances that end a solve); and an infeasibility
    certificate (z for primal, x for dual infeasibility), scaled to unit
    inf-norm, lies within 1e-6 + 2·spread (its length is the arbitrary
    scale of a ray).  Where the reference's backends disagree on the count
    (a singular KKT matrix, whose refined solves are rounding noise), the
    port's count lies within their range.
    """
    ref, got = reference(name, method), port(name, method)
    rs, ps = ref.solution, got.solution
    assert ps.status == rs.status
    assert got.info.linear_solver.name == ref.info.linear_solver.name

    pairs = [(reference(name, "auto"), reference(name, "pallas")),
             (port(name, "auto"), port(name, "pallas"))]
    counts = [s.solution.iterations for s in pairs[0]]
    if counts[0] != counts[1]:
        assert min(counts) <= ps.iterations <= max(counts)
        return
    assert ps.iterations == rs.iterations

    def spread(get):
        return np.maximum(*(np.abs(get(a) - get(b)) for a, b in pairs))

    rows = rs.iterations  # the terminating row is compared through the status
    history = lambda s: s.iteration_history[:rows]
    bound = 1e-6 * np.abs(history(ref)) + 1e-10 + 2.0 * spread(history)
    err = np.abs(history(got) - history(ref))
    assert np.all(err <= bound), np.max(err / bound)

    if rs.status == ct.SolverStatus.Solved:
        for v in ("x", "z", "s"):
            r, p = getattr(rs, v), getattr(ps, v)
            scale = max(1.0, float(np.max(np.abs(r), initial=0.0)))
            assert np.max(np.abs(p - r), initial=0.0) <= 1e-7 * scale, v
        for v in ("obj_val", "obj_val_dual"):
            r, p = getattr(rs, v), getattr(ps, v)
            assert abs(p - r) <= 1e-9 * max(1.0, abs(r)), v
    elif rs.status.is_infeasible():
        cert = "z" if rs.status == ct.SolverStatus.PrimalInfeasible else "x"
        unit = lambda s: _direction(getattr(s.solution, cert))
        err = np.abs(unit(got) - unit(ref))
        assert np.all(err <= 1e-6 + 2.0 * spread(unit)), cert
        assert np.isnan(ps.obj_val) and np.isnan(ps.obj_val_dual)

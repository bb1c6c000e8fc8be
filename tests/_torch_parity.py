"""Shared helpers of the ``test_torch_*`` parity tests: the oracle problems
of the basic suites and the batches of the batch suite, and the contract a
solve of the port is held to against the JAX package
(:func:`assert_lane_matches`, for one problem or one lane of a batch).

Each problem is built as numpy data from the basic suites' own builders
(``test_basic_*.py``, ``test_batch.py``), so the port is held to exactly
the problems the JAX package is.  The JAX side runs its Pallas LDLᵀ kernel
in interpret mode, as the JAX package's own CPU runs do.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import clarabel_tpu as ct
import clarabel_tpu.kkt.pallas_ldl as jax_pallas_ldl
import clarabel_tpu_torch as tt
from clarabel_tpu import json_io as jax_json_io
from clarabel_tpu_torch import convert, json_io
from clarabel_tpu_torch.kkt import dense as tdense

import test_basic_lp
import test_basic_qp
import test_basic_socp
import test_basic_eq_and_unconstrained as test_basic_eq
import test_basic_expcone
import test_basic_powcone
import test_basic_sdp
import test_batch


# Every test_torch_* module imports this one.  The test workers share the
# CPU's cores, and the problems here are small: one intra-op thread per
# worker keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)


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


def _sdp_empty_cone():
    P, q, A, b, cones = test_basic_sdp.sdp_data()
    return P, q, A, b, cones + [ct.PSDTriangleConeT(0)]


def _sdp_primal_infeasible():
    P, q, A, b, cones = test_basic_sdp.sdp_data()
    return (P, q, np.vstack([A, -A]), np.concatenate([b, np.zeros(6)]),
            cones + [ct.PSDTriangleConeT(3)])


def _sdp_mixed_with_soc():
    """test_basic_sdp.py's PSD + SOC mixture: b is 5·I in svec form, so
    x = 0 is strictly feasible for both blocks."""
    P, _, A, _, cones = test_basic_sdp.sdp_data()
    b = np.array([5.0, 0.0, 5.0, 0.0, 0.0, 5.0])
    return (P, np.ones(6), np.vstack([A, -np.eye(6)]), np.concatenate([b, np.zeros(6)]),
            cones + [ct.SecondOrderConeT(6)])


def _eq(P, q, A, b, cones):
    return lambda: (P, np.asarray(q, float), A, np.asarray(b, float), cones)


def _portfolio_qp(n=12, k=3, seed=0):
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


def _portfolio_socp(n=8, k=3, sigma=0.25, seed=1):
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


def _random_socp(rng, n=8, p=2, n_nn=4, soc=5):
    """The JAX package's test_schur_lowrank.py problem: zero, NN and one SOC."""
    P = np.eye(n) * 0.5
    q = rng.standard_normal(n)
    A1 = rng.standard_normal((p, n))
    A = np.vstack([A1, -np.eye(n)[:n_nn], rng.standard_normal((soc, n))])
    b = np.concatenate([A1 @ np.ones(n), np.ones(n_nn) * 5, np.zeros(soc)])
    b[p + n_nn] = 10.0
    return P, q, A, b, [ct.ZeroConeT(p), ct.NonnegativeConeT(n_nn), ct.SecondOrderConeT(soc)]


def _exp_primal_infeasible():
    P, q, A, b, cones = test_basic_expcone.expcone_data()
    b[4] = -1.0
    return P, q, A, b, cones


def _pow_pair(kind):
    """test_basic_powcone.py's feasible problem with two power cones, or
    the same two as generalized power cones."""
    if kind == "pow":
        return lambda: test_basic_powcone._pow_problem([ct.PowerConeT(0.6), ct.PowerConeT(0.1)])
    return lambda: test_basic_powcone._pow_problem(
        [ct.GenPowerConeT([0.6, 0.4], 1), ct.GenPowerConeT([0.1, 0.9], 1)])


def _mixed_conic():
    """The reference's mixed_conic.rs problem (test_mixed_conic.py): zero,
    NN, SOC, power and exponential cones over three variables."""
    n = 3
    cones = [ct.ZeroConeT(3), ct.NonnegativeConeT(3), ct.SecondOrderConeT(3),
             ct.PowerConeT(0.5), ct.ExponentialConeT()]
    return np.eye(n), np.ones(n), np.vstack([np.eye(n)] * 5), np.zeros(5 * n), cones


def entropy_max(n=8, p=2, q=2, seed=5):
    """Entropy maximization (Boyd & Vandenberghe §7.2; CVXPY's entropy
    maximization example): max −Σ xᵢ log xᵢ s.t. Fx = g, Gx ≤ h, the data
    drawn around a point x₀ of the simplex.  Over (t, x), minimize −Σ tᵢ
    with one exponential cone per i on (tᵢ, xᵢ, 1)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(size=n)
    x0 /= x0.sum()
    F = rng.normal(size=(p, n))
    G = rng.normal(size=(q, n))
    g, h = F @ x0, G @ x0 + rng.uniform(size=q)
    A_exp = np.zeros((3 * n, 2 * n))
    A_exp[0::3, :n] = -np.eye(n)
    A_exp[1::3, n:] = -np.eye(n)
    b_exp = np.tile([0.0, 0.0, 1.0], n)
    zero = np.zeros((p, n))
    A = np.vstack([A_exp, np.hstack([zero, F]), np.hstack([np.zeros((q, n)), G])])
    b = np.concatenate([b_exp, g, h])
    q_obj = np.concatenate([-np.ones(n), np.zeros(n)])
    cones = [ct.ExponentialConeT()] * n + [ct.ZeroConeT(p), ct.NonnegativeConeT(q)]
    return np.zeros((2 * n, 2 * n)), q_obj, A, b, cones


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
    # the nonsymmetric cones: test_basic_expcone.py, test_basic_powcone.py
    "exp_feasible": test_basic_expcone.expcone_data,
    "exp_primal_infeasible": _exp_primal_infeasible,
    "exp_dual_infeasible": _eq(np.zeros((3, 3)), [-1.0, 0.0, 0.0], -np.eye(3), np.zeros(3),
                               [ct.ExponentialConeT()]),
    "pow_feasible": _pow_pair("pow"),
    "pow_primal_infeasible": _eq(np.zeros((3, 3)), np.zeros(3),
                                 np.vstack([-np.eye(3), [[1.0, 0.0, 0.0]]]),
                                 [0.0, 0.0, 0.0, -1.0], [ct.PowerConeT(0.5), ct.ZeroConeT(1)]),
    "pow_dual_infeasible": _eq(np.zeros((3, 3)), [0.0, 0.0, -1.0], -np.eye(3), np.zeros(3),
                               [ct.PowerConeT(0.5)]),
    "genpow_feasible": _pow_pair("genpow"),
    "genpow_primal_infeasible": _eq(np.zeros((4, 4)), np.zeros(4),
                                    np.vstack([-np.eye(4), [[1.0, 0.0, 0.0, 0.0]]]),
                                    [0.0, 0.0, 0.0, 0.0, -1.0],
                                    [ct.GenPowerConeT([0.5, 0.5], 2), ct.ZeroConeT(1)]),
    "genpow_dual_infeasible": _eq(np.zeros((4, 4)), [0.0, 0.0, -1.0, 0.0], -np.eye(4),
                                  np.zeros(4), [ct.GenPowerConeT([0.5, 0.5], 2)]),
    "mixed_conic": _mixed_conic,
    # the same, with the scaling switch forced (every step below 0.999
    # retries under dual scaling), as test_mixed_conic.py re-solves it
    "mixed_conic_dual_scaling": _mixed_conic,
    "entropy": entropy_max,
    # the PSD triangle cone: test_basic_sdp.py
    "sdp_feasible": test_basic_sdp.sdp_data,
    "sdp_empty_cone": _sdp_empty_cone,
    "sdp_primal_infeasible": _sdp_primal_infeasible,
    "sdp_mixed_with_soc": _sdp_mixed_with_soc,
}

#: settings a problem of PROBLEMS is solved with, besides the method
PROBLEM_SETTINGS = {"mixed_conic_dual_scaling": dict(min_switch_step_length=0.999)}

#: problems (of PROBLEMS, and batches of BATCHES) whose solution the
#: default tolerances pin only loosely: the reference's own "auto" and
#: "pallas" solutions differ there beyond the contract's 1e-7 (exp_feasible's
#: z by 1.5e-5 at scale 4, 37x the bound; entropy's z by up to 1,300x;
#: sdp_mixed_with_soc's x, z and s by 5.9e-7, each 3.7e-6 from the optimum)
PINNED_BY_TOLERANCE = {"exp_feasible", "entropy", "sdp_mixed_with_soc", "bench_sdp"}
#: of those, the problems whose objective the default tolerances pin only
#: loosely too: the reference's own "auto" and "pallas" objectives of
#: sdp_mixed_with_soc differ by 2.1e-9 (its last step's length is set by
#: a PSD block whose z is 1e-12, rounding noise), beyond the contract's
#: 1e-9; those of bench_sdp's lane 2 by 9.7e-10, each 1.3e-9 from the
#: optimum's
OBJECTIVE_PINNED_BY_TOLERANCE = {"sdp_mixed_with_soc", "bench_sdp"}
#: of those, the problems whose x, z and s the optimum pins no better than
#: the reference's own backends reproduce them: bench_sdp at n = 6 leaves
#: four of the ten PSD rows out of A, so complementarity alone pins their
#: z, and the reference's "auto" and "pallas" z differ there by 1.5e-4,
#: each on its own side of the optimum
SOLUTION_PINNED_BY_SPREAD = {"bench_sdp"}

#: the tolerances of the reference's solve that stands in for the problem's
#: optimum: 100x below the defaults (on exp_feasible it lands within 9e-7
#: of the closed-form z, the default solve 1e-4 away)
_OPTIMUM_TOLERANCES = dict(tol_gap_abs=1e-10, tol_gap_rel=1e-10, tol_feas=1e-10,
                           tol_ktratio=1e-8)


def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas LDLᵀ in interpret mode (the CPU has no
    TPU); nothing in the JAX package changes."""
    monkeypatch.setattr(
        jax_pallas_ldl, "make_ldl_factor",
        functools.partial(jax_pallas_ldl.make_ldl_factor, interpret=True),
    )


def _mixed_status_lp_batch():
    """One feasible and one primal-infeasible LP (test_batch.py:59-73)."""
    n = 3
    P = np.zeros((2, n, n))
    q = np.tile(np.array([3.0, -2.0, 1.0]), (2, 1))
    A = np.tile(2.0 * np.vstack([np.eye(3), -np.eye(3)]), (2, 1, 1))
    b = np.ones((2, 6))
    b[1, 0] = -1.0
    b[1, 3] = -1.0
    return P, q, A, b, [ct.NonnegativeConeT(6)]


def _mu_draws(problem, B, seed):
    """B instances of a portfolio problem sharing its Σ, each with its own
    expected returns μ: the scenario batch of a portfolio optimizer."""
    P, _, A, b, cones = problem()
    n = P.shape[0]
    mu = np.random.default_rng(seed).normal(0.05, 0.1, size=(B, n))
    tile = lambda v: np.tile(v, (B,) + (1,) * v.ndim)
    return tile(P), -mu, tile(A), tile(b), cones


def bench_sdp_batch(B=4, n=6, dmat=4, seed=2):
    """The JAX bench's batched SDP (bench.py:194-256): strictly complementary
    instances built from a known primal-dual optimal pair -- interior x*,
    complementary s* ⊥ z* on NonnegativeConeT(2n) (a quarter of the rows
    active) and on PSDTriangleConeT(dmat) (S*, Z* PSD on orthogonal
    complements), then b = Ax* + s*, q = -(Px* + Aᵀz*)."""
    tri = dmat * (dmat + 1) // 2
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n)
    Apsd = np.zeros((tri, n))
    Apsd[:tri, :min(tri, n)] = -np.eye(tri)[:, :min(tri, n)]
    A = np.tile(np.vstack([np.eye(n), -np.eye(n), Apsd]), (B, 1, 1))
    x_star = 0.5 * rng.normal(size=(B, n))
    s_nn = rng.uniform(0.5, 1.5, (B, 2 * n))
    z_nn = np.zeros((B, 2 * n))
    act = rng.uniform(size=(B, 2 * n)) < 0.25
    z_nn[act] = rng.uniform(0.5, 1.5, act.sum())
    s_nn[act] = 0.0
    Qo, _ = np.linalg.qr(rng.normal(size=(B, dmat, dmat)))
    k = dmat // 2
    S = np.einsum("bik,bk,bjk->bij", Qo[:, :, :k], rng.uniform(0.5, 1.5, (B, k)), Qo[:, :, :k])
    Z = np.einsum("bik,bk,bjk->bij", Qo[:, :, k:], rng.uniform(0.5, 1.5, (B, dmat - k)),
                  Qo[:, :, k:])
    svec = lambda X: np.stack([X[:, i, j] * (1.0 if i == j else np.sqrt(2.0))
                               for j in range(dmat) for i in range(j + 1)], axis=-1)
    s_star = np.concatenate([s_nn, svec(S)], axis=1)
    z_star = np.concatenate([z_nn, svec(Z)], axis=1)
    b = np.einsum("bmn,bn->bm", A, x_star) + s_star
    q = -(np.einsum("bij,bj->bi", P, x_star) + np.einsum("bmn,bm->bn", A, z_star))
    return P, q, A, b, [ct.NonnegativeConeT(2 * n), ct.PSDTriangleConeT(dmat)]


def _bench_socp_batch(B=4, n=6, seed=1):
    """The JAX bench's batched SOCP (bench.py:156-167): box constraints and
    one SecondOrderConeT(n + 1) bounding the norm of x, here at n = 6."""
    rng = np.random.default_rng(seed)
    dsoc = n + 1
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n))
    Asoc = np.zeros((dsoc, n))
    Asoc[1:, :n] = -np.eye(dsoc - 1)[:, :n]
    A = np.tile(np.vstack([np.eye(n), -np.eye(n), Asoc]), (B, 1, 1))
    b = np.tile(np.concatenate([np.ones(2 * n), [10.0], np.zeros(dsoc - 1)]), (B, 1))
    return P, q, A, b, [ct.NonnegativeConeT(2 * n), ct.SecondOrderConeT(dsoc)]


def _entropy_batch(B=3, n=3, seed=20):
    """B entropy maximizations (:func:`entropy_max`) of n = 3, one
    exponential cone per variable, each lane its own draw of (F, g, G, h)."""
    lanes = [entropy_max(n=n, p=1, q=1, seed=seed + i) for i in range(B)]
    stack = lambda j: np.stack([lane[j] for lane in lanes])
    return stack(0), stack(1), stack(2), stack(3), lanes[0][4]


def _genpow_batch(B=3, k=3, seed=21):
    """B resource allocations over k geometric means: maximize Σ tⱼ with
    tⱼ ≤ x_{j0}^0.6 x_{j1}^0.4 (one GenPowerConeT([0.6, 0.4], 1) on
    (x_{j0}, x_{j1}, tⱼ) per j) and the budget cᵀx ≤ 1, each lane its own
    draw of the prices c."""
    n = 3 * k
    A = np.zeros((3 * k + 1, n))
    for j in range(k):
        A[3 * j:3 * j + 3, [2 * j, 2 * j + 1, 2 * k + j]] = -np.eye(3)
    prices = np.random.default_rng(seed).uniform(0.5, 2.0, size=(B, 2 * k))
    A = np.tile(A, (B, 1, 1))
    A[:, -1, :2 * k] = prices
    b = np.tile(np.concatenate([np.zeros(3 * k), [1.0]]), (B, 1))
    q = np.tile(np.concatenate([np.zeros(2 * k), -np.ones(k)]), (B, 1))
    cones = [ct.GenPowerConeT([0.6, 0.4], 1)] * k + [ct.NonnegativeConeT(1)]
    return np.zeros((B, n, n)), q, A, b, cones


BATCHES = {
    # B = 5, n = 4, m = 8: B is neither n nor m
    "box_qp": lambda: test_batch.qp_batch(5),
    # B = n = 4: a per-lane scalar broadcast the wrong way would go unseen
    "box_qp_b_eq_n": lambda: test_batch.qp_batch(4, seed=3),
    "mixed_status_lp": _mixed_status_lp_batch,
    "portfolio_qp": lambda: _mu_draws(_portfolio_qp, 3, seed=10),
    "portfolio_socp": lambda: _mu_draws(_portfolio_socp, 3, seed=11),
    "bench_socp": _bench_socp_batch,
    # B = k = 3 exponential / generalized power cones
    "entropy": _entropy_batch,
    "genpow": _genpow_batch,
    # B = 4 lanes of the bench's strictly complementary SDP at n = 6
    "bench_sdp": bench_sdp_batch,
}


def port_cones(cones):
    """The JAX package's cones as the port's."""
    return convert.cones_from_specs(convert.cone_specs(cones))


def port_settings(settings):
    """The JAX package's settings as the port's."""
    return convert.settings_from_dict(dataclasses.asdict(settings))


@functools.cache
def reference(name, method):
    """The JAX package's solver for problem ``name``, after its solve.  The
    caller runs it with the Pallas kernel in interpret mode."""
    P, q, A, b, cones = PROBLEMS[name]()
    settings = ct.DefaultSettings(verbose=False, direct_solve_method=method,
                                  **PROBLEM_SETTINGS.get(name, {}))
    ref = ct.DefaultSolver(P, q, A, b, cones, settings)
    ref.solve()
    return ref


@functools.cache
def port(name, method):
    """The port's solver for problem ``name`` on the CPU, after its solve,
    built through ``convert`` from the JAX package's settings and cones."""
    P, q, A, b, cones = PROBLEMS[name]()
    settings = ct.DefaultSettings(verbose=False, direct_solve_method=method,
                                  **PROBLEM_SETTINGS.get(name, {}))
    solver = tt.DefaultSolver(
        P, q, A, b, port_cones(cones), port_settings(settings), device="cpu",
    )
    solver.solve()
    return solver


@functools.cache
def batch_reference(name, method):
    """The JAX package's BatchSolver for batch ``name`` and its solution.
    The caller runs it with the Pallas kernel in interpret mode."""
    P, q, A, b, cones = BATCHES[name]()
    settings = ct.DefaultSettings(verbose=False, direct_solve_method=method)
    solver = ct.BatchSolver(P, q, A, b, cones, settings)
    return solver, solver.solve()


@functools.cache
def batch_port(name, method, lanes=None):
    """The port's BatchSolver for batch ``name`` on the CPU, or for the
    lanes ``lanes`` (a tuple of indices, in that order) of it, and its
    solution."""
    P, q, A, b, cones = BATCHES[name]()
    if lanes is not None:
        P, q, A, b = (v[list(lanes)] for v in (P, q, A, b))
    settings = ct.DefaultSettings(verbose=False, direct_solve_method=method)
    solver = tt.BatchSolver(P, q, A, b, port_cones(cones), port_settings(settings),
                            device="cpu")
    return solver, solver.solve()


@functools.cache
def reference_optimum(name):
    """The JAX package's solution of problem ``name`` at tolerances 100x
    below the defaults (through "auto"), as a :class:`Lane`; None unless
    ``name`` is in PINNED_BY_TOLERANCE."""
    if name not in PINNED_BY_TOLERANCE:
        return None
    P, q, A, b, cones = PROBLEMS[name]()
    ref = ct.DefaultSolver(P, q, A, b, cones,
                           ct.DefaultSettings(verbose=False, **_OPTIMUM_TOLERANCES))
    ref.solve()
    assert ref.solution.status == ct.SolverStatus.Solved
    return lane_of(ref)


@functools.cache
def batch_reference_optimum(name):
    """The lanes of batch ``name`` as :func:`reference_optimum` solves them
    (the JAX package's BatchSolver), or None."""
    if name not in PINNED_BY_TOLERANCE:
        return None
    P, q, A, b, cones = BATCHES[name]()
    solver = ct.BatchSolver(P, q, A, b, cones,
                            ct.DefaultSettings(verbose=False, **_OPTIMUM_TOLERANCES))
    lanes = lanes_of(solver, solver.solve(), ct.SolverStatus)
    assert all(lane.status == ct.SolverStatus.Solved for lane in lanes)
    return lanes


@dataclasses.dataclass
class Lane:
    """One solution as the contract compares it: of a single solve, or one
    lane of a batch.  ``status`` is its package's SolverStatus."""

    status: object
    iterations: int
    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    obj_val: float
    obj_val_dual: float
    history: np.ndarray


def lane_of(solver):
    """The solution of a single solve (either package's DefaultSolver)."""
    s = solver.solution
    return Lane(s.status, s.iterations, s.x, s.z, s.s, s.obj_val, s.obj_val_dual,
                solver.iteration_history)


def lanes_of(solver, solution, status_type):
    """Each lane of a batch solve (either package's BatchSolver)."""
    history = solver.iteration_history()
    return [
        Lane(status_type(int(solution.status[i])), int(solution.iterations[i]),
             solution.x[i], solution.z[i], solution.s[i], float(solution.obj_val[i]),
             float(solution.obj_val_dual[i]), history[i])
        for i in range(len(solution.status))
    ]


def _direction(v):
    return v / max(float(np.max(np.abs(v), initial=0.0)), 1e-300)


def assert_port_matches_reference(name, method, pair=("auto", "pallas")):
    """Solve problem ``name`` through both packages and hold the port to
    the reference: the same status and KKT backend name, and
    :func:`assert_lane_matches` with the backend spread taken between the
    two methods of ``pair`` in each package."""
    ref, got = reference(name, method), port(name, method)
    assert got.solution.status == ref.solution.status
    assert got.info.linear_solver.name == ref.info.linear_solver.name
    assert_lane_matches(
        lane_of(ref), lane_of(got),
        [lane_of(reference(name, m)) for m in pair],
        [lane_of(port(name, m)) for m in pair],
        optimum=reference_optimum(name),
        pin_objective=name in OBJECTIVE_PINNED_BY_TOLERANCE,
    )


def assert_lane_matches(ref, got, ref_pair, got_pair, optimum=None, pin_objective=False,
                        pin_by_spread=False):
    """Hold the port's solution ``got`` to the reference's ``ref``, each a
    :class:`Lane`; ``ref_pair`` and ``got_pair`` are the same problem's
    solutions through two KKT backends in each package: the pivoted LU
    ("auto") and the LDLᵀ ("pallas"), or one method twice, which leaves no
    spread.

    Always: the same status.  Solved: x, z and s within 1e-7 of the
    reference's inf-norm (at least 1) and the objectives within 1e-9
    relative.

    What comes out of an ill-conditioned KKT system is held to the
    packages' own reproducibility: the *spread*, the larger of the two
    packages' differences between their own two KKT backends on the same
    problem.  The backends sum in different orders, and near the end of a
    solve -- or all along, for a certificate of infeasibility -- cond(K)
    amplifies that rounding.  Where the
    reference's backends agree on the iteration count, the port's count is
    equal; every history row before the terminating one lies within
    1e-6·|ref| + 1e-10 + 2·spread of the reference's (1e-10 is 100x below
    the 1e-8 tolerances that end a solve); and an infeasibility
    certificate (z for primal, x for dual infeasibility), scaled to unit
    inf-norm, lies within 1e-6 + 2·spread (its length is the arbitrary
    scale of a ray).  Where the reference's backends disagree on the count
    (a singular KKT matrix, whose refined solves are rounding noise), the
    port's count lies within their range.

    ``optimum`` (:func:`reference_optimum`, for a problem of
    PINNED_BY_TOLERANCE) is the reference's solution of the same problem at
    tolerances 100x tighter.  With it, each entry of a Solved x, z and s may
    also lie up to twice as far from the reference's as the reference's
    lies from the optimum: the distance two solutions can have when each is
    as accurate as the reference.  It is a quantity of the reference alone,
    so a fault of the port cannot widen its own bound.  The objectives keep
    1e-9, unless ``pin_objective`` (a problem of
    OBJECTIVE_PINNED_BY_TOLERANCE) gives them the same allowance: twice the
    reference objective's distance from the optimum's.  ``pin_by_spread`` (a
    problem of SOLUTION_PINNED_BY_SPREAD) adds to the bound of each entry of
    x, z and s twice its spread.
    """
    assert got.status == ref.status

    pairs = [tuple(ref_pair), tuple(got_pair)]
    counts = [s.iterations for s in pairs[0]]
    if counts[0] != counts[1]:
        assert min(counts) <= got.iterations <= max(counts)
        return
    assert got.iterations == ref.iterations

    def spread(get):
        return np.maximum(*(np.abs(get(a) - get(b)) for a, b in pairs))

    rows = ref.iterations  # the terminating row is compared through the status
    history = lambda s: s.history[:rows]
    bound = 1e-6 * np.abs(history(ref)) + 1e-10 + 2.0 * spread(history)
    err = np.abs(history(got) - history(ref))
    assert np.all(err <= bound), np.max(err / bound)

    if ref.status == ct.SolverStatus.Solved:
        for v in ("x", "z", "s"):
            r, p = getattr(ref, v), getattr(got, v)
            scale = max(1.0, float(np.max(np.abs(r), initial=0.0)))
            accuracy = 0.0 if optimum is None else np.abs(r - getattr(optimum, v))
            if pin_by_spread:
                accuracy = accuracy + spread(lambda s: getattr(s, v))
            assert np.all(np.abs(p - r) <= 1e-7 * scale + 2.0 * accuracy), v
        for v in ("obj_val", "obj_val_dual"):
            r, p = getattr(ref, v), getattr(got, v)
            accuracy = abs(r - getattr(optimum, v)) if pin_objective else 0.0
            assert abs(p - r) <= 1e-9 * max(1.0, abs(r)) + 2.0 * accuracy, v
    elif ref.status.is_infeasible():
        cert = "z" if ref.status == ct.SolverStatus.PrimalInfeasible else "x"
        unit = lambda s: _direction(getattr(s, cert))
        err = np.abs(unit(got) - unit(ref))
        assert np.all(err <= 1e-6 + 2.0 * spread(unit)), cert
        assert np.isnan(got.obj_val) and np.isnan(got.obj_val_dual)


def assert_batch_matches_reference(name, method):
    """Solve batch ``name`` through both packages' BatchSolver and hold
    each lane of the port to the reference's with :func:`assert_lane_matches`;
    besides, every history row past a lane's last one is NaN in both
    packages (a frozen lane writes no row)."""
    methods = ("auto", "pallas")
    ref = {m: lanes_of(*batch_reference(name, m), ct.SolverStatus) for m in methods}
    got = {m: lanes_of(*batch_port(name, m), tt.SolverStatus) for m in methods}
    optimum = batch_reference_optimum(name) or [None] * len(ref[method])
    assert len(got[method]) == len(ref[method])
    for i, (r, g) in enumerate(zip(ref[method], got[method])):
        assert_lane_matches(r, g, [ref[m][i] for m in methods], [got[m][i] for m in methods],
                            optimum=optimum[i],
                            pin_objective=name in OBJECTIVE_PINNED_BY_TOLERANCE,
                            pin_by_spread=name in SOLUTION_PINNED_BY_SPREAD)
        for lane in (r, g):
            assert np.all(np.isnan(lane.history[lane.iterations + 1:])), i
            assert not np.any(np.all(np.isnan(lane.history[:lane.iterations + 1]), axis=1)), i


def assert_f32_matches(got, ref, f64, iterations=2):
    """The f32 contract of a solve of the port (``got``, a :class:`Lane`)
    against the JAX package's f32 solve of the same problem (``ref``) and an
    f64 solve of it (``f64``): the same status (by name); on a Solved
    problem the objectives within 1e-4 relative of each other and each
    within 1e-4 relative of the f64 one, x within 1e-3·(1 + ‖x‖∞) of the
    JAX package's; the iteration counts within ``iterations``."""
    assert got.status.name == ref.status.name, (got.status.name, ref.status.name)
    assert abs(got.iterations - ref.iterations) <= iterations, (got.iterations, ref.iterations)
    if ref.status.name != "Solved":
        return
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))
    assert rel(got.obj_val, ref.obj_val) <= 1e-4, (got.obj_val, ref.obj_val)
    for lane in (got, ref):
        assert rel(lane.obj_val, f64.obj_val) <= 1e-4, (lane.obj_val, f64.obj_val)
    scale = 1.0 + float(np.max(np.abs(ref.x), initial=0.0))
    assert np.max(np.abs(np.asarray(got.x) - np.asarray(ref.x)), initial=0.0) <= 1e-3 * scale


#: one problem of each cone kind (of PROBLEMS), for the JSON file tests
FILE_KINDS = {
    "zero": "eq_feasible",
    "nonnegative": "qp_feasible",
    "second_order": "socp_feasible",
    "exponential": "exp_feasible",
    "power": "pow_feasible",
    "genpower": "genpow_feasible",
    "psd": "sdp_feasible",
}


def check_jax_file_loads(kind, tmp_path, monkeypatch):
    """A file the JAX package writes (dense path) loads in the port with
    the same data, and the port's solve of it matches the JAX package's
    solve of the same file within the parity contract; the backend spread
    is each package's "auto" against "pallas" on the same problem (the
    file holds the original data: no presolve reduction here).  Each kind
    is tested (``test_jax_files_load_in_the_port``) in the solver parity
    file of its problem (test_torch_solver.py, _qp.py, _socp.py,
    _nonsym.py, _pow.py, _sdp.py), where those JAX reference solves are
    made anyway."""
    interpret_pallas(monkeypatch)
    name = FILE_KINDS[kind]
    P, q, A, b, cones = PROBLEMS[name]()
    ref = ct.DefaultSolver(P, q, A, b, cones,
                           ct.DefaultSettings(verbose=False, direct_solve_method="auto"))
    path = tmp_path / "jax.json"
    ref.save_to_file(path)

    P, q, A, b, cones, settings = json_io.load_problem(path)
    P_r, q_r, A_r, b_r, cones_r, settings_r = jax_json_io.load_problem(path)
    assert (P != P_r).nnz == 0 and (A != A_r).nnz == 0
    assert np.array_equal(q, q_r) and np.array_equal(b, b_r)
    assert tuple(cones) == port_cones(cones_r)
    assert settings == port_settings(settings_r)

    jax_solver = ct.DefaultSolver.load_from_file(path)
    jax_solver.solve()
    port_solver = tt.DefaultSolver.load_from_file(path, device="cpu")
    port_solver.solve()
    assert jax_solver._presolver is None
    pair = ("auto", "pallas")
    assert_lane_matches(lane_of(jax_solver), lane_of(port_solver),
                           [lane_of(reference(name, m)) for m in pair],
                           [lane_of(port(name, m)) for m in pair],
                           optimum=reference_optimum(name),
                           pin_objective=name in OBJECTIVE_PINNED_BY_TOLERANCE)


# ---------------------------------------------------------------------------
# f32 "auto" routes around the sparse path (test_torch_f32_sparse_routes.py,
# test_torch_f32_sparse.py)


def _route_banded_sdp():
    import chip_smoke

    P, q, A, b, _ = chip_smoke.banded_sdp(77)
    return P, q, A, b, [ct.PSDTriangleConeT(77)]


def _route_maxcut_dual():
    import chip_smoke

    P, q, A, b = chip_smoke.maxcut_dual(78, 2, 1)[:4]
    return P, q, A, b, [ct.PSDTriangleConeT(78)]


#: name -> (the problem, sparse after the cost model)
F32_ROUTES = {"chordal_sdp": (_route_banded_sdp, True), "veto_dense": (_route_maxcut_dual, False)}


@functools.cache
def f32_route_reference(name):
    P, q, A, b, cones = F32_ROUTES[name][0]()
    solver = ct.DefaultSolver(P, q, A, b, cones, ct.DefaultSettings.for_float32(verbose=False),
                              dtype="float32", device=jax.devices("cpu")[0])
    solver.solve()
    return solver


def f32_route_port(name, dtype):
    P, q, A, b, cones = F32_ROUTES[name][0]()
    make = tt.DefaultSettings.for_float32 if dtype == "float32" else tt.DefaultSettings
    solver = tt.DefaultSolver(P, q, A, b, port_cones(cones), make(verbose=False),
                              dtype=dtype, device="cpu")
    solver.solve()
    return solver


def check_f32_route(name):
    """The port's f32 "auto" solve of route ``name`` (of F32_ROUTES)
    against the JAX package's: the routes' fields (``_sparse``, the linear
    solver's name, dimension and nnz(L), the cost model's decision) and the
    f32 contract (:func:`assert_f32_matches`)."""
    ref = f32_route_reference(name)
    got = f32_route_port(name, "float32")
    sparse = F32_ROUTES[name][1]
    assert got._sparse == ref._sparse == sparse
    assert got._chordal is not None and ref._chordal is not None
    for field in ("name", "dim", "nnzL"):
        assert getattr(got.info.linear_solver, field) == getattr(ref.info.linear_solver, field)
    assert got.info.linear_solver.cost_model["decision"] == \
        ref.info.linear_solver.cost_model["decision"] == ("multifrontal" if sparse else "dense")
    if not sparse:  # the dense f32 "lu" above the double-float LU's sizes
        assert got.info.linear_solver.dim > tdense.DF_LU_MAX_DIM
    f64 = f32_route_port(name, "float64")
    assert_f32_matches(lane_of(got), lane_of(ref), lane_of(f64))


# ---------------------------------------------------------------------------
# the double-float LU past the one-block kernels' order
# (test_torch_df_lu_large.py, test_torch_df_lu_large_solve.py)

#: past 512, not a multiple of 32 or of the grid factor's panel width 8
DF_LARGE_N = 545


def df_split(K):
    """An f64 matrix as its f32 (hi, lo) pair."""
    hi = K.astype(np.float32)
    return hi, (K - hi.astype(np.float64)).astype(np.float32)


def df_large_matrix():
    """tests/test_df_lu.py's split-scale quasidefinite K (cond ~ 1e8) at
    DF_LARGE_N (n = 136, m = 409), f64."""
    import test_df_lu

    return test_df_lu._quasidef(DF_LARGE_N // 4, DF_LARGE_N - DF_LARGE_N // 4, 5.0, seed=11)

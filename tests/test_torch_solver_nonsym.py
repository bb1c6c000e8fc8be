"""Whole-solve parity of clarabel_tpu_torch with the JAX package on the
exponential, power and generalized power cones: the problems of
tests/test_basic_expcone.py and tests/test_basic_powcone.py (each feasible,
primal infeasible and dual infeasible), the reference's mixed_conic.rs
problem (zero, NN, SOC, power and exponential cones; test_mixed_conic.py),
also with the scaling switch forced, and a small entropy maximization
(n = 8), through ``direct_solve_method`` "auto" (pivoted LU at f64) and
"pallas" (the quasidefinite LDLᵀ), both packages at f64 on the CPU.

Tolerances: the parity contract of tests/_torch_parity.py.  On
exp_feasible and entropy (``PINNED_BY_TOLERANCE``) the default tolerances
pin some entries only loosely -- the reference's own "auto" and "pallas"
z differ by 1.5e-5 on exp_feasible (scale 4), beyond the contract's 1e-7
-- so there each entry of x, z and s may lie twice as far from the
reference's as the reference's lies from its own solve at 100x tighter
tolerances; their objectives keep 1e-9.

The generalized power cones allow no primal-dual scaling, so their solves
run the dual-scaling barrier backtracking on every step; the forced switch
runs the retries of the strategy checkpoints.

Each problem also solves as a BatchSolver of two copies of itself, each
lane held to the JAX package's DefaultSolver under the same contract.
"""

import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt

ONE = [
    ("mixed_conic", "pallas"),
    # every step below 0.999 switches to dual scaling and retries
    ("mixed_conic_dual_scaling", "auto"),
    # the LDLᵀ end game of this certificate is checked below
    ("exp_primal_infeasible", "auto"),
]
BOTH = ["exp_feasible", "exp_dual_infeasible", "pow_feasible", "pow_primal_infeasible",
        "pow_dual_infeasible", "genpow_feasible", "genpow_primal_infeasible",
        "genpow_dual_infeasible", "entropy"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", BOTH)
def test_port_matches_reference(name, method):
    tp.assert_port_matches_reference(name, method)


@pytest.mark.parametrize("name, method", ONE)
def test_port_matches_reference_one_backend(name, method):
    """One backend, held to the contract without a spread (``pair`` is the
    method twice), which keeps the reference's compiles few."""
    tp.assert_port_matches_reference(name, method, pair=(method, method))


@functools.cache
def _batch_lanes(name, method):
    """The lanes of the port's BatchSolver over two copies of problem
    ``name``, through ``method``."""
    P, q, A, b, cones = tp.PROBLEMS[name]()
    two = lambda v: np.stack([np.asarray(v, np.float64)] * 2)
    settings = tp.port_settings(ct.DefaultSettings(
        verbose=False, direct_solve_method=method, **tp.PROBLEM_SETTINGS.get(name, {})))
    solver = tt.BatchSolver(two(P), two(q), two(A), two(b), tp.port_cones(cones), settings,
                            device="cpu")
    return tp.lanes_of(solver, solver.solve(), tt.SolverStatus)


@pytest.mark.parametrize("name, method", [(n, m) for n in BOTH for m in ("auto", "pallas")] + ONE)
def test_batch_lanes_match_reference(name, method):
    pair = ("auto", "pallas") if name in BOTH else (method, method)
    ref = {m: tp.lane_of(tp.reference(name, m)) for m in pair}
    for i in range(2):
        got = {m: _batch_lanes(name, m)[i] for m in pair}
        tp.assert_lane_matches(ref[method], got[method], [ref[m] for m in pair],
                               [got[m] for m in pair], optimum=tp.reference_optimum(name))


def test_exp_primal_infeasible_ldl_end_game():
    """exp_primal_infeasible through "pallas": in both packages the LDLᵀ
    path leaves the LU path at iteration 7 (the JAX package's by 8 %, the
    port's by 1.4 % in the costs), where the certificate's end game
    amplifies the factors' rounding (the JAX package's interpret-mode
    kernel and the port's plain twin round differently: the next test
    shows they compute the same factorization); the reference
    then takes 10 iterations, the port 8.  Held to: the status; history
    rows 0-6 within 1e-6 relative plus 1e-10 plus twice the two packages'
    own LU-vs-LDLᵀ spread; the certificate z, scaled to unit inf-norm,
    within twice the reference's own spread of its two backends'
    certificates (the direction of a ray in the certificate cone is not
    unique: 0.03 apart there); and at most 2 iterations fewer."""
    name = "exp_primal_infeasible"
    ref = {m: tp.lane_of(tp.reference(name, m)) for m in ("auto", "pallas")}
    got = {m: tp.lane_of(tp.port(name, m)) for m in ("auto", "pallas")}
    r, g = ref["pallas"], got["pallas"]
    assert g.status == r.status == tt.SolverStatus.PrimalInfeasible
    assert r.iterations - 2 <= g.iterations <= r.iterations
    rows = slice(0, 7)
    spread = np.maximum(np.abs(ref["auto"].history[rows] - r.history[rows]),
                        np.abs(got["auto"].history[rows] - g.history[rows]))
    bound = 1e-6 * np.abs(r.history[rows]) + 1e-10 + 2.0 * spread
    assert np.all(np.abs(g.history[rows] - r.history[rows]) <= bound)
    unit = {k: tp._direction(v.z) for k, v in ref.items()}
    cert_spread = np.abs(unit["auto"] - unit["pallas"])
    assert np.all(np.abs(tp._direction(g.z) - unit["pallas"]) <= 2.0 * cert_spread + 1e-6)
    assert np.isnan(g.obj_val)


def _exact_ldl(K, n, eps, delta):
    """The LDLᵀ of ``K`` (float64 [N, N]) in exact rational arithmetic,
    with the kernels' regularization (a pivot d with d·sign < eps becomes
    delta·sign, sign +1 on the first n rows), rounded to float64 at the end:
    the packed layout's upper triangle (Lᵀ above the diagonal, D on it)."""
    N = K.shape[0]
    eps, delta = Fraction(eps), Fraction(delta)
    F = [[Fraction(float(v)) for v in row] for row in K]
    for j in range(N):
        sign = 1 if j < n else -1
        d = F[j][j] if F[j][j] * sign >= eps else delta * sign
        row = F[j][j + 1:]
        col = [v / d for v in row]
        for a in range(j + 1, N):
            for c in range(j + 1, N):
                F[a][c] -= col[a - j - 1] * row[c - j - 1]
        F[j][j] = d
        F[j][j + 1:] = col
    return np.array([[float(F[a][c]) if c >= a else 0.0 for c in range(N)] for a in range(N)])


def test_exp_primal_infeasible_ldl_end_game_is_rounding(monkeypatch):
    """The witness for the end game above: on every KKT matrix of the
    port's "pallas" solve of exp_primal_infeasible (iterations 0-7), the
    JAX package's Pallas kernel (interpret mode) and the port's plain twin
    compute the same factorization -- each lies within 1e-11 of the exact
    rational LDLᵀ of that K (relative to its largest entry; measured: at
    most 1.4e-12, the twin closer at iteration 7) -- yet at iteration 7
    (cond(K) 6e14) the two factors' solves of one right-hand side differ
    by more than 1 % (measured: 9 %), so their rounding alone can move the
    certificate's end game."""
    from clarabel_tpu_torch.kkt import pallas_ldl as port_ldl

    name = "exp_primal_infeasible"
    factored = []
    factor = port_ldl.ldl_factor

    def recording(K, n, m, settings, variant="auto"):
        factored.append((K.clone(), n, m, settings))
        return factor(K, n, m, settings, variant)

    monkeypatch.setattr(port_ldl, "ldl_factor", recording)
    P, q, A, b, cones = tp.PROBLEMS[name]()
    settings = ct.DefaultSettings(verbose=False, direct_solve_method="pallas")
    tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(settings),
                     device="cpu").solve()
    assert len(factored) == 8  # the start and iterations 1-7
    for K, n, m, port_settings in factored:
        N = n + m
        jax_packed = tp.jax_pallas_ldl.make_ldl_factor(n, m, settings, jnp.float64)(
            jnp.asarray(K.numpy()))[0][1][0]
        jax_factor = np.triu(np.asarray(jax_packed)[:N, :N])
        port_factor = np.triu(factor(K, n, m, port_settings)[0][1][0].numpy())
        exact = _exact_ldl(K.numpy(), n, settings.dynamic_regularization_eps,
                           settings.dynamic_regularization_delta)
        scale = np.max(np.abs(exact))
        for got in (jax_factor, port_factor):
            assert np.max(np.abs(got - exact)) <= 1e-11 * scale
    rhs = np.random.default_rng(0).normal(size=N)
    x_jax = np.asarray(tp.jax_pallas_ldl.ldl_solve(jax_packed, N, jnp.asarray(rhs)))
    x_port = port_ldl.ldl_solve(torch.as_tensor(port_factor), N, torch.as_tensor(rhs)).numpy()
    assert np.max(np.abs(x_jax - x_port)) > 1e-2 * np.max(np.abs(x_port))


def test_f32_with_an_exponential_cone_raises():
    """At f32, "auto" resolves to "lu" on a nonsymmetric layout, which
    needs the compensated f32 stack (ROADMAP item 12b)."""
    P, q, A, b, cones = tp.PROBLEMS["exp_feasible"]()
    with pytest.raises(NotImplementedError, match="item 12b"):
        tt.DefaultSolver(P, q, A, b, tp.port_cones(cones),
                         tt.DefaultSettings.for_float32(verbose=False),
                         dtype="float32", device="cpu")


@pytest.mark.parametrize("method", ["schur_diag", "schur_lr", "schur"])
def test_schur_methods_demote_to_lu(method):
    """The structured Schur paths represent no nonsymmetric scaling: an
    explicit request runs LU, as the JAX package's _kkt_prepare demotes it
    ("schur" has no demotion there and factors the full K), with LU's
    result bit for bit."""
    P, q, A, b, cones = tp.PROBLEMS["genpow_feasible"]()
    solve = lambda m: tt.DefaultSolver(
        P, q, A, b, tp.port_cones(cones),
        tt.DefaultSettings(verbose=False, direct_solve_method=m), device="cpu").solve()
    got, lu = solve(method), solve("lu")
    assert got.status == tt.SolverStatus.Solved
    if method != "schur":
        assert got.iterations == lu.iterations
        np.testing.assert_array_equal(got.x, lu.x)
    else:
        assert abs(got.obj_val - lu.obj_val) <= 1e-7

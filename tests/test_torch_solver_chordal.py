"""Solves through the chordal decomposition of clarabel_tpu_torch: the
reference's chordal oracle problem (tests/test_sdp_chordal.py, PSD(6)
beside two power cones; reference: tests/sdp_chordal.rs) at f64 on the CPU.

- In all 12 combinations of {compact} x {complete_dual} x {merge_method},
  as the JAX package's own test solves it: Solved, the objective within
  1e-6 and x within 1e-5 of the port's solve without decomposition, and
  the completed dual PSD (min eigenvalue above -1e-7).
- In three of them -- the default (compact, completed, clique-graph
  merging), the standard transform, and no merging without completion --
  held to the JAX package's solve through "auto": the same status and
  iterations, the primal and dual objectives within 1e-9 relative, x and s
  within 1e-7 of the reference's inf-norm (at least 1), and the dual
  through what the problem pins: its stationarity residual ‖Px + q + Aᵀz‖∞
  and complementarity sᵀz within 1e-9 of the reference's own.  The dual
  is not unique: the JAX package's own LU and LDLᵀ solves put z 2.3e-5
  apart (8.6e-6 on the standard transform), so z is not compared entry
  for entry.
- A warm start through the clique transform (``decomp_warm_start``) from
  the JAX package's cold solution: the same status and iterations as the
  JAX package's warm solve from it, and the objective within 1e-8
  relative, the gap tolerance that ends both solves (its 15 iterations
  from a mapped iterate that is not feasible carry rounding further than
  a cold solve's: the JAX package's own cold and warm objectives are 9e-9
  relative apart).
"""

import functools

import numpy as np
import pytest

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt

import test_sdp_chordal

CONFIGS = [(compact, complete, merge) for compact in (False, True)
           for complete in (False, True) for merge in ("none", "parent_child", "clique_graph")]
#: the configurations also held to the JAX package
REFERENCE_CONFIGS = [(True, True, "clique_graph"), (False, True, "clique_graph"),
                     (True, False, "none")]


def _settings(compact, complete, merge, **extra):
    return ct.DefaultSettings(
        verbose=False, chordal_decomposition_compact=compact,
        chordal_decomposition_complete_dual=complete,
        chordal_decomposition_merge_method=merge, **extra)


def _solver(package, config=None):
    """A solver of ``package`` ("jax" or "port") under ``config``, or with
    the decomposition off (``config`` None)."""
    P, q, A, b, cones = test_sdp_chordal.sdp_chordal_data()
    settings = (ct.DefaultSettings(verbose=False, chordal_decomposition_enable=False)
                if config is None else _settings(*config))
    if package == "jax":
        return ct.DefaultSolver(P, q, A, b, cones, settings)
    return tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(settings),
                            device="cpu")


@functools.cache
def _solve(package, config=None):
    """:func:`_solver` after its cold solve."""
    solver = _solver(package, config)
    solver.solve()
    return solver


def _svec_to_mat(x):
    n = int((np.sqrt(8 * len(x) + 1) - 1) / 2)
    M = np.zeros((n, n))
    k = 0
    for j in range(n):
        for i in range(j + 1):
            M[i, j] = M[j, i] = x[k] if i == j else x[k] / np.sqrt(2.0)
            k += 1
    return M


@pytest.mark.parametrize("compact, complete, merge", CONFIGS)
def test_all_configs_solve(compact, complete, merge):
    solver = _solve("port", (compact, complete, merge))
    sol = solver.solution
    assert sol.status == tt.SolverStatus.Solved
    assert (solver._chordal is None) == (merge == "parent_child")
    plain = _solve("port").solution
    assert plain.status == tt.SolverStatus.Solved
    assert abs(sol.obj_val - plain.obj_val) <= 1e-6
    assert np.linalg.norm(sol.x - plain.x) <= 1e-5
    if complete:
        assert np.linalg.eigvalsh(_svec_to_mat(sol.z[1:22])).min() >= -1e-7


def _dual_residuals(sol):
    P, q, A, b, _ = test_sdp_chordal.sdp_chordal_data()
    return np.max(np.abs(P @ sol.x + q + A.T @ sol.z)), float(sol.s @ sol.z)


@pytest.mark.parametrize("compact, complete, merge", REFERENCE_CONFIGS)
def test_configs_match_reference(compact, complete, merge):
    ref = _solve("jax", (compact, complete, merge)).solution
    got = _solve("port", (compact, complete, merge)).solution
    assert ref.status == ct.SolverStatus.Solved and got.status == tt.SolverStatus.Solved
    assert got.iterations == ref.iterations
    for v in ("obj_val", "obj_val_dual"):
        r, p = getattr(ref, v), getattr(got, v)
        assert abs(p - r) <= 1e-9 * max(1.0, abs(r)), v
    for v in ("x", "s"):
        r, p = getattr(ref, v), getattr(got, v)
        assert np.max(np.abs(p - r)) <= 1e-7 * max(1.0, np.max(np.abs(r))), v
    for r, p in zip(_dual_residuals(ref), _dual_residuals(got)):
        assert abs(p - r) <= 1e-9


def test_warm_start_through_the_transform():
    cold = _solve("jax", REFERENCE_CONFIGS[0]).solution
    start = (cold.x, cold.s, cold.z)
    ref = _solver("jax", REFERENCE_CONFIGS[0]).solve(warm_start=start)
    got = _solver("port", REFERENCE_CONFIGS[0]).solve(warm_start=start)
    assert ref.status == ct.SolverStatus.Solved and got.status == tt.SolverStatus.Solved
    assert got.iterations == ref.iterations
    assert abs(got.obj_val - ref.obj_val) <= 1e-8 * max(1.0, abs(ref.obj_val))

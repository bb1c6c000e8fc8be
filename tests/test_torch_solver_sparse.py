"""Whole-solve parity of clarabel_tpu_torch with the JAX package on the
sparse multifrontal KKT path (``direct_solve_method="multifrontal"``), both
packages at f64 on the CPU, under the parity contract of
tests/_torch_parity.py: the same status, iteration count and KKT backend;
x, z and s within 1e-7; the objectives within 1e-9 relative; every history
row within 1e-6 relative (+1e-10) of the reference's.

- LP, QP, SOCP with a dense Hs block (SOC of 3 rows) and with the rank-2
  expansion (above 4 rows), the exponential cone, the generalized power
  cone (rank-3 expansion), primal and dual infeasibility certificates and a
  chordally decomposed SDP, each against the same problem through the JAX
  package's multifrontal engine.  The power cone and the exponential
  cone's certificate end game are rounding-sensitive in the reference
  itself, so there the contract's bounds widen by the spread between each
  package's multifrontal and LU solves (the harness's documented pattern).
- The "auto" route: a problem past the size gate goes to the multifrontal
  engine in both packages, one whose CPU cost model vetoes it comes back to
  the dense path in both; the ``linear_solver`` fields and the cost model's
  inputs and decision are equal (constructions only).
- CSC data updates (nzval vectors, (index, value) pairs, whole matrices of
  the same structure) and a warm start, each solve against the reference's
  (test_torch_solver_sparse_updates.py, a file of one test that
  pytest-xdist's loadfile scheduling runs beside tests/test_df_lu.py); an
  update to zero values keeps the structure (the port alone: the JAX
  package's sum drops the zeros from its structure there).
- ``BatchSolver`` with "multifrontal" runs what the JAX BatchSolver runs
  there (pivoted LU on each lane), lane by lane.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import chip_smoke
import clarabel_tpu as ct
import clarabel_tpu_torch as tt

MF = "multifrontal"


@pytest.mark.parametrize("name", [
    "lp_feasible", "qp_feasible", "socp_feasible", "portfolio_socp", "exp_feasible",
    "genpow_feasible", "lp_primal_infeasible", "qp_dual_infeasible",
])
def test_multifrontal_matches_reference(name):
    tp.assert_port_matches_reference(name, MF, pair=(MF, MF))
    ref, got = tp.reference(name, MF), tp.port(name, MF)
    for field in ("name", "nnzA", "nnzL", "dim"):
        assert getattr(got.info.linear_solver, field) == getattr(ref.info.linear_solver, field)
    assert got._skkt.soc_expanded == ref._skkt.soc_expanded
    assert got._skkt.genpow_expanded == ref._skkt.genpow_expanded


def test_expansions_are_exercised():
    assert tp.port("portfolio_socp", MF)._skkt.soc_expanded == (True,)
    assert tp.port("socp_feasible", MF)._skkt.soc_expanded == (False,)
    assert tp.port("genpow_feasible", MF)._skkt.genpow_expanded


@pytest.mark.parametrize("name", ["pow_feasible", "exp_primal_infeasible"])
def test_multifrontal_matches_reference_within_backend_spread(name):
    tp.assert_port_matches_reference(name, MF, pair=(MF, "auto"))


def _banded_sdp(n=6):
    """A PSD cone on a banded X: chordal decomposition splits it into
    cliques (the port's guard test's problem)."""
    pairs = [(i, j) for j in range(n) for i in range(j + 1) if j - i <= 1]
    tri = n * (n + 1) // 2
    A = np.zeros((tri, len(pairs)))
    for k, (i, j) in enumerate(pairs):
        A[j * (j + 1) // 2 + i, k] = -1.0
    q = np.array([-1.0 if i == j else 0.2 for i, j in pairs])
    return np.eye(len(pairs)), q, A, np.zeros(tri), n


def test_chordal_sdp_matches_reference():
    P, q, A, b, n = _banded_sdp()
    ref = ct.DefaultSolver(P, q, A, b, [ct.PSDTriangleConeT(n)],
                           ct.DefaultSettings(verbose=False, direct_solve_method=MF))
    got = tt.DefaultSolver(P, q, A, b, [tt.PSDTriangleConeT(n)],
                           tt.DefaultSettings(verbose=False, direct_solve_method=MF), device="cpu")
    ref.solve()
    got.solve()
    assert got._chordal is not None and ref._chordal is not None
    assert got._sparse and got.info.linear_solver.name == MF
    r, g = tp.lane_of(ref), tp.lane_of(got)
    tp.assert_lane_matches(r, g, [r, r], [g, g])


def _nn_qp(n=3000):
    eye = sp.eye(n, format="csc")
    return eye, np.ones(n), eye, np.ones(n), [ct.NonnegativeConeT(n)]


ROUTES = {
    # past the size gate, diagonal: the multifrontal engine
    "nn_qp_3000": _nn_qp,
    # the dual max-cut of a sparse graph: the chordal analysis makes it
    # sparse enough, then the CPU cost model sends it back to dense LU
    "maxcut_dual_veto": lambda: chip_smoke.maxcut_dual(80, 3, 0)[:4] + ([ct.PSDTriangleConeT(80)],),
}


@pytest.mark.parametrize("name", ROUTES)
def test_auto_route_matches_reference(name):
    P, q, A, b, cones = ROUTES[name]()
    ref = ct.DefaultSolver(P, q, A, b, cones, ct.DefaultSettings(verbose=False))
    got = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tt.DefaultSettings(verbose=False),
                           device="cpu")
    assert got._sparse == ref._sparse == (name == "nn_qp_3000")
    for field in ("name", "nnzA", "nnzL", "dim"):
        assert getattr(got.info.linear_solver, field) == getattr(ref.info.linear_solver, field)
    rcm, gcm = ref.info.linear_solver.cost_model, got.info.linear_solver.cost_model
    assert rcm.keys() == gcm.keys()
    assert {k: v for k, v in rcm.items() if k != "provenance"} == \
        {k: v for k, v in gcm.items() if k != "provenance"}
    assert gcm["decision"] == ("multifrontal" if got._sparse else "dense")


def _box_qp(n=30, seed=2):
    rng = np.random.default_rng(seed)
    P = sp.diags([2.0 + rng.random(n), -0.5 * np.ones(n - 1), -0.5 * np.ones(n - 1)],
                 [0, 1, -1], format="csc")
    A = sp.vstack([sp.eye(n), -sp.eye(n), sp.csr_matrix(np.ones((1, n)))], format="csc")
    b = np.concatenate([np.ones(2 * n), [1.0]])
    return P, rng.normal(size=n), A, b


def test_update_to_zero_keeps_the_structure():
    """An update that zeroes P's values keeps the sparse structure (its
    explicit zeros) and turns the problem into an LP, whose start the
    solve function then takes: the same solution as an LP built with
    P = 0 (within 1e-7)."""
    P, q, A, b = _box_qp()
    n = q.size
    cones = [tt.NonnegativeConeT(2 * n), tt.ZeroConeT(1)]
    settings = tt.DefaultSettings(verbose=False, direct_solve_method=MF, presolve_enable=False)
    s = tt.DefaultSolver(P, q, A, b, cones, settings, device="cpu")
    s.update_P(sp.triu(P, format="csc").data * 0.0)
    assert s._p_is_zero and s._P.nnz == P.nnz
    lp = tt.DefaultSolver(sp.csc_matrix((n, n)), q, A, b, cones, settings, device="cpu")
    got, ref = s.solve(), lp.solve()
    assert got.status == ref.status == tt.SolverStatus.Solved
    assert np.max(np.abs(got.x - ref.x)) <= 1e-7 * max(1.0, np.max(np.abs(ref.x)))


def test_batch_solver_multifrontal_runs_lu_as_the_reference():
    """The JAX BatchSolver resolves "multifrontal" to its dense pivoted LU
    factor (its loop's method resolution); the port's does the same: each
    lane equal to the reference's, and bit for bit to the port's "auto"
    (LU at f64) batch."""
    ref = tp.lanes_of(*tp.batch_reference("box_qp", MF), ct.SolverStatus)
    got = tp.lanes_of(*tp.batch_port("box_qp", MF), tt.SolverStatus)
    lu = tp.lanes_of(*tp.batch_port("box_qp", "auto"), tt.SolverStatus)
    assert len(got) == len(ref)
    for r, g, u in zip(ref, got, lu):
        tp.assert_lane_matches(r, g, [r, r], [g, g])
        assert g.iterations == u.iterations and np.array_equal(g.x, u.x)

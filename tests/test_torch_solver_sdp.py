"""Whole-solve parity of clarabel_tpu_torch with the JAX package on the PSD
triangle cone: the problems of tests/test_basic_sdp.py (the reference's
3 x 3 SDP, the same with an empty PSD cone, a primal infeasible one and a
PSD + SOC mixture) through ``direct_solve_method`` "auto" (pivoted LU at
f64) and "pallas" (the quasidefinite LDLᵀ), both packages at f64 on the
CPU, under the parity contract of tests/_torch_parity.py (the same status,
iterations and KKT backend name; x, z and s within 1e-7; the objectives
within 1e-9 relative).

Then the routing of the JAX package's auto backend: a large problem goes
to its sparse multifrontal engine, where PSD blocks may send it only
tentatively, to come back to the dense path after the chordal analysis.
On the problems of tests/test_psd_auto_route.py and a max-cut SDP above
the size gate, the port builds its dense solver exactly where the JAX
package returns to the dense path before its multifrontal analysis, with
the same decomposition and KKT backend, and raises naming ROADMAP item 14
exactly where the JAX package goes on to that analysis.  Constructions
only: nothing is solved.

f32 with a PSD cone raises, naming ROADMAP item 12b.
"""

import numpy as np
import pytest

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt

import test_psd_auto_route

NAMES = ["sdp_feasible", "sdp_empty_cone", "sdp_primal_infeasible", "sdp_mixed_with_soc"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_port_matches_reference(name, method):
    tp.assert_port_matches_reference(name, method)


def test_reference_solution():
    """The reference's own oracle (basic_sdp.rs): x and the objective."""
    solver = tp.port("sdp_feasible", "auto")
    assert solver.solution.status == tt.SolverStatus.Solved
    import test_basic_sdp

    assert np.linalg.norm(solver.solution.x - test_basic_sdp.REFSOL) <= 1e-6
    assert abs(solver.info.cost_primal - test_basic_sdp.REFOBJ) <= 1e-6


# -----------------------------------------------------------------
# routing
# -----------------------------------------------------------------


def maxcut_sdp(order, seed=0):
    """The max-cut SDP relaxation in primal form (Goemans-Williamson):
    minimize <C, X> over X = svec⁻¹(x) ⪰ 0 with diag(X) = 1, C = -L/4 of
    a random weighted graph.  No sparsity to decompose: every svec entry
    of X is a variable."""
    rng = np.random.default_rng(seed)
    W = np.triu(rng.uniform(size=(order, order)) * (rng.uniform(size=(order, order)) < 0.1), 1)
    W = W + W.T
    C = -(np.diag(W.sum(axis=1)) - W) / 4.0
    tri = order * (order + 1) // 2
    pairs = [(i, j) for j in range(order) for i in range(j + 1)]
    q = np.array([C[i, j] * (1.0 if i == j else np.sqrt(2.0)) for i, j in pairs])
    diag = [p for p, (i, j) in enumerate(pairs) if i == j]
    A_eq = np.zeros((order, tri))
    A_eq[np.arange(order), diag] = 1.0
    A = np.vstack([-np.eye(tri), A_eq])
    b = np.concatenate([np.zeros(tri), np.ones(order)])
    return (np.zeros((tri, tri)), q, A, b,
            [ct.PSDTriangleConeT(order), ct.ZeroConeT(order)])


def _dense_psd_block():
    """test_psd_auto_route.py's small dense SDP (d = 90): dense again after
    the chordal analysis, whose decomposition it keeps."""
    rng = np.random.default_rng(0)
    d, n = 90, 50
    tri = d * (d + 1) // 2
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.normal(size=n)
    A = np.zeros((tri, n))
    A[:n, :n] = -np.eye(n)
    b = np.zeros(tri)
    b[[j * (j + 1) // 2 + j for j in range(d)]] = 1.0
    return P, q, A, b, [ct.PSDTriangleConeT(d)]


def _banded_nn_qp():
    """test_psd_auto_route.py's cost-model problem: sparse, no PSD cone."""
    import scipy.sparse as sp

    n = 1200
    P = sp.diags([2.0 * np.ones(n), -0.8 * np.ones(n - 1), -0.8 * np.ones(n - 1)],
                 [0, 1, -1], format="csc")
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    q = np.random.default_rng(1).standard_normal(n)
    return P, q, A, np.ones(2 * n), [ct.NonnegativeConeT(2 * n)]


ROUTES = {
    "banded_250": lambda: test_psd_auto_route.banded_sdp(250),
    "banded_140": lambda: test_psd_auto_route.banded_sdp(140),
    "dense_psd_block": _dense_psd_block,
    "banded_nn_qp": _banded_nn_qp,
    "maxcut_60": lambda: maxcut_sdp(60),
}


@pytest.mark.parametrize("name", ROUTES)
def test_routing_matches_reference(name):
    P, q, A, b, cones = ROUTES[name]()
    ref = ct.DefaultSolver(P, q, A, b, cones, ct.DefaultSettings(verbose=False))
    # the JAX package builds its multifrontal analysis (``_skkt``) once it
    # goes on past the post-chordal re-check, whether or not its cost
    # model then vetoes it
    multifrontal = hasattr(ref, "_skkt")
    settings = tt.DefaultSettings(verbose=False)
    if multifrontal:
        with pytest.raises(NotImplementedError, match="item 14"):
            tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), settings, device="cpu")
        return
    assert not ref._sparse
    got = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), settings, device="cpu")
    assert (got._chordal is None) == (ref._chordal is None)
    assert got.info.linear_solver.name == ref.info.linear_solver.name
    assert got.info.linear_solver.dim == ref.info.linear_solver.dim
    assert got._layout.cones == tp.port_cones(ref._layout.cones)


def test_routing_covers_both_decisions():
    """The problems above take both routes in the JAX package."""
    decisions = {hasattr(ct.DefaultSolver(*ROUTES[name](),
                                          ct.DefaultSettings(verbose=False)), "_skkt")
                 for name in ("banded_140", "maxcut_60")}
    assert decisions == {True, False}


# -----------------------------------------------------------------
# f32
# -----------------------------------------------------------------


@pytest.mark.parametrize("batch", [False, True], ids=["DefaultSolver", "BatchSolver"])
@pytest.mark.parametrize("method", ["auto", "lu", "pallas", "schur_lr"])
def test_f32_with_psd_raises(method, batch):
    """f32 through any KKT method on a PSD layout needs the compensated f32
    stack ("auto" resolves to "lu" and "schur_lr" demotes to it)."""
    P, q, A, b, cones = tp.PROBLEMS["sdp_feasible"]()
    settings = tt.DefaultSettings.for_float32(verbose=False, direct_solve_method=method)
    with pytest.raises(NotImplementedError, match="item 12b"):
        if batch:
            two = lambda v: np.stack([v, v])
            tt.BatchSolver(two(P), two(q), two(A), two(b), tp.port_cones(cones), settings,
                           dtype="float32", device="cpu")
        else:
            tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), settings, dtype="float32",
                             device="cpu")

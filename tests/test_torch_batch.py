"""The port's BatchSolver against the JAX package's, lane by lane: box QPs
(B = 5 with n = 4 and m = 8, and B = n = 4) and a batch of one feasible and
one primal-infeasible LP, through ``direct_solve_method`` "auto" (batched
pivoted LU at f64) and "pallas" (the quasidefinite LDLᵀ), both packages at
f64 on the CPU.  Then what a batch must not depend on: the order of its
lanes and their company; and the options the port does not run yet."""

import numpy as np
import pytest

import _torch_parity as tp
import clarabel_tpu_torch as tt

NAMES = ["box_qp", "box_qp_b_eq_n", "mixed_status_lp"]
EXACT = ("status", "iterations")
VALUES = ("x", "z", "s", "obj_val", "obj_val_dual", "r_prim", "r_dual")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    tp.interpret_pallas(monkeypatch)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_batch_matches_reference(name, method):
    tp.assert_batch_matches_reference(name, method)


def _lanes(name, method, lanes=None, take=slice(None)):
    """The outputs of the port's batch solve of ``name`` (of its lanes
    ``lanes``), at the lanes ``take`` of that solve."""
    solver, sol = tp.batch_port(name, method, lanes)
    out = {f: getattr(sol, f)[take] for f in EXACT + VALUES}
    out["history"] = solver.iteration_history()[take]
    return out


def _assert_lanes_equal(got, want):
    """Statuses and iterations equal; every value within 1e-12 relative."""
    for f in EXACT:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in VALUES + ("history",):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-12, atol=0, equal_nan=True,
                                   err_msg=f)


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_lane_permutation_permutes_outputs(name, method):
    B = len(tp.BATCHES[name]()[1])
    order = np.random.default_rng(0).permutation(B).tolist()
    if order == sorted(order):
        order = order[::-1]
    _assert_lanes_equal(_lanes(name, method, tuple(order)), _lanes(name, method, take=order))


@pytest.mark.parametrize("method", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_lane_equals_batch_of_one(name, method):
    for i in range(len(tp.BATCHES[name]()[1])):
        _assert_lanes_equal(_lanes(name, method, (i,)), _lanes(name, method, take=[i]))


@pytest.mark.parametrize("n, variant", [(4, "unrolled"), (130, "blocked")])
def test_pallas_factors_the_whole_batch_at_once(monkeypatch, n, variant):
    """Each factor of a "pallas" batch solve takes all B KKT matrices in
    one call, through the variant the JAX package picks at that size
    (unrolled at N <= 256, blocked above)."""
    from clarabel_tpu_torch.kkt import pallas_ldl

    calls = []
    factor = pallas_ldl.ldl_factor

    def recording(K, n_, m_, settings, variant="auto"):
        calls.append((tuple(K.shape), pallas_ldl._resolve_variant(variant, n_ + m_)))
        return factor(K, n_, m_, settings, variant)

    monkeypatch.setattr(pallas_ldl, "ldl_factor", recording)
    B = 3
    P, q, A, b, cones = tp._mu_draws(lambda: tp._portfolio_qp(n=n, k=3), B, seed=5)
    sol = tt.BatchSolver(P, q, A, b, tp.port_cones(cones),
                         tt.DefaultSettings(verbose=False, direct_solve_method="pallas"),
                         device="cpu").solve()
    assert all(s == tt.SolverStatus.Solved for s in sol.statuses())
    N = 2 * n + 1
    assert calls and set(calls) == {((B, N, N), variant)}
    # the start's factor and one per iteration of the slowest lane
    assert len(calls) == sol.iterations.max() + 1

"""The port's SparseBatchSolver: B sparse problems of one pattern through
one multifrontal plan, f64 on the CPU.

- Against the JAX package's SparseBatchSolver, lane by lane, under the
  parity contract of tests/_torch_parity.py (the same status and
  iterations, every history row within 1e-6 relative, x, z and s within
  1e-7, the objectives within 1e-9 relative): the banded QP batch of the
  JAX package's own tests (B = 3, n = 60, the fused DIA assembly) and its
  NN + SOC lane batch (B = 2, n = 12: the rank-2 SOC expansion, the
  assembly through Kvals).  Two JAX constructions in all, made once, in
  test_torch_sparse_batch_reference.py (a file of two tests, which
  pytest-xdist's loadfile scheduling runs beside tests/test_df_lu.py).
- Against the port's own DefaultSolver "multifrontal" (held to the JAX
  package by test_torch_solver_sparse.py), lane by lane under the same
  contract: a feasible and a primal-infeasible lane in one batch, an
  exponential-cone batch, a PSD batch, and warm re-solves after
  ``update_values`` of q and b, then of P.
- What a lane must not depend on: its company (a lane among very different
  lanes equals it among copies of itself, bit for bit) -- the reductions
  that once covered one problem (the refinement's norms, the static
  regularization's ε, the equilibration's cost scale, the factor's ``ok``)
  now reduce over a lane's own entries.
- The contract's edges: a differing pattern raises, ``plan`` and
  ``iteration_history()``.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import loop
from clarabel_tpu_torch.kkt import dense as kkt_dense

import test_sparse_batch as jsb

MF = "multifrontal"


def _nn_soc_batch(B=2, n=12, seed=3):
    """The JAX package's test_sparse_batch_socp_lane batch."""
    rng = np.random.default_rng(seed)
    P = sp.eye(n, format="csc")
    A = sp.vstack([sp.eye(n), sp.eye(n)], format="csc")
    q = rng.standard_normal((B, n))
    b = np.tile(np.concatenate([np.ones(n), np.zeros(n)]), (B, 1))
    b[:, n] = 2.0
    return [P] * B, q, [A] * B, b, [ct.NonnegativeConeT(n), ct.SecondOrderConeT(n)]


BATCHES = {
    "banded_qp": lambda: jsb.banded_qp_batch(3),
    "nn_soc": _nn_soc_batch,
}


def _settings(pkg, **kw):
    return pkg.DefaultSettings(verbose=False, direct_solve_method=MF, **kw)


@functools.cache
def _reference(name):
    P, q, A, b, cones = BATCHES[name]()
    solver = ct.SparseBatchSolver(P, q, A, b, cones, _settings(ct))
    return tp.lanes_of(solver, solver.solve(), ct.SolverStatus)


def _port(name):
    P, q, A, b, cones = BATCHES[name]()
    solver = tt.SparseBatchSolver(P, q, A, b, tp.port_cones(cones), _settings(tt), device="cpu")
    return solver, solver.solve()


def _alone(P, q, A, b, cones, warm_start=None, **settings):
    """DefaultSolver "multifrontal" on one lane, as a parity Lane."""
    s = tt.DefaultSolver(P, q, A, b, cones, _settings(
        tt, presolve_enable=False, chordal_decomposition_enable=False, **settings), device="cpu")
    s.solve(warm_start=warm_start)
    return tp.lane_of(s)


def _assert_lanes_equal_alone(problem, sol, solver, warm=None):
    """Each lane of ``sol`` against the lane alone (warm-started from the
    same iterate where ``warm`` gives one), under the parity contract."""
    P, q, A, b, cones = problem
    got = tp.lanes_of(solver, sol, tt.SolverStatus)
    for i, g in enumerate(got):
        ws = None if warm is None else (warm.x[i], warm.s[i], warm.z[i])
        r = _alone(P[i], q[i], A[i], b[i], cones, warm_start=ws)
        tp.assert_lane_matches(r, g, [r, r], [g, g])
    return got


def _mixed_statuses(n=20):
    P = sp.csc_matrix((n, n))
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    b_inf = np.ones(2 * n)
    b_inf[n] = -2.0
    return [P, P], np.ones((2, n)), [A, A], np.stack([np.ones(2 * n), b_inf]), \
        [tt.NonnegativeConeT(2 * n)]


def _exp_batch(B=3, n=4, seed=20):
    """min ½‖x − c‖² + ½‖t − d‖² with (x_i, 1, t_i) in the exponential cone
    (e^x_i ≤ t_i), per lane its own c and d = 3·e^c: every nonsymmetric
    code path of the batch (the cones' Hessian blocks through the Kvals
    assembly, the scaling strategies, the step-length searches) with the
    cones slack at the optimum.  Where they bind, the exponential cone's
    end game amplifies rounding: a lane alone and in a batch (whose dot
    products sum in another order) then end ~1e-5 apart in x, as the JAX
    package's own solves of one problem through two backends do."""
    rng = np.random.default_rng(seed)
    nv = 2 * n  # (x, t)
    rows = []
    for i in range(n):  # s = b - A v = (x_i, 1, t_i)
        r = np.zeros((3, nv))
        r[0, i] = -1.0
        r[2, n + i] = -1.0
        rows.append(r)
    A = sp.csc_matrix(np.vstack(rows))
    c = rng.normal(size=(B, n))
    q = np.concatenate([-c, -3.0 * np.exp(c)], axis=1)
    b = np.tile(np.tile([0.0, 1.0, 0.0], n), (B, 1))
    return [sp.eye(nv, format="csc")] * B, q, [A] * B, b, [tt.ExponentialConeT()] * n


def _psd_batch(B=2, n=3, seed=22):
    """min ½‖x‖² + qᵀx with the svec of X = mat(x) + I·c in the PSD cone,
    per lane its own q and shift c."""
    rng = np.random.default_rng(seed)
    tri = n * (n + 1) // 2
    A = -sp.eye(tri, format="csc")
    diag = [j * (j + 1) // 2 + j for j in range(n)]
    b = np.zeros((B, tri))
    b[:, diag] = rng.uniform(0.1, 0.5, (B, 1))
    return [sp.eye(tri, format="csc")] * B, rng.standard_normal((B, tri)), [A] * B, b, \
        [tt.PSDTriangleConeT(n)]


OTHER = {"mixed_statuses": _mixed_statuses, "exp_cone": _exp_batch, "psd": _psd_batch}


@pytest.mark.parametrize("name", OTHER)
def test_lanes_equal_default_solver(name):
    problem = OTHER[name]()
    P, q, A, b, cones = problem
    solver = tt.SparseBatchSolver(P, q, A, b, cones, _settings(tt), device="cpu")
    sol = solver.solve()
    got = _assert_lanes_equal_alone(problem, sol, solver)
    want = ([tt.SolverStatus.Solved, tt.SolverStatus.PrimalInfeasible]
            if name == "mixed_statuses" else [tt.SolverStatus.Solved] * len(got))
    assert [g.status for g in got] == want
    if name == "exp_cone":
        assert not solver._layout.is_symmetric
    if name == "psd":
        assert solver._layout.num_psd == 1


def test_update_values_and_warm_start():
    """q and b moved, then a warm solve from the cold batch: each lane as
    DefaultSolver's warm solve of it from the same iterate; then P's values
    scaled in canonical CSC order, a cold solve: each lane as DefaultSolver's
    cold solve of the scaled lane.  The plan is never rebuilt."""
    Ps, q, A, b, cones = jsb.banded_qp_batch(2, n=30, seed=5)
    cones = tp.port_cones(cones)
    solver = tt.SparseBatchSolver(Ps, q, A, b, cones, _settings(tt), device="cpu")
    plan = solver.plan
    first = solver.solve()
    q2, b2 = q + 0.01, b + 0.05
    solver.update_values(q=q2, b=b2)
    warm = solver.solve(warm_start=first)
    got = _assert_lanes_equal_alone((Ps, q2, [A] * 2, b2, cones), warm, solver, warm=first)
    assert all(g.iterations < f for g, f in zip(got, first.iterations))
    P_data = np.stack([P.tocsc().sorted_indices().data for P in Ps])
    solver.update_values(P_data=1.5 * P_data)
    again = solver.solve()
    _assert_lanes_equal_alone(([1.5 * P for P in Ps], q2, [A] * 2, b2, cones), again, solver)
    assert solver.plan is plan
    with pytest.raises(ValueError, match="P_data"):
        solver.update_values(P_data=P_data[:, :-1])
    with pytest.raises(ValueError, match="warm start"):
        solver.solve(warm_start=(first.x[:1], first.s, first.z))


def test_pattern_mismatch_raises():
    Ps, q, A, b, cones = jsb.banded_qp_batch(2)
    bad = Ps[1].copy().tolil()
    bad[0, 40] = bad[40, 0] = 1e-3
    with pytest.raises(ValueError, match="sparsity pattern"):
        tt.SparseBatchSolver([Ps[0], bad.tocsc()], q, A, b, tp.port_cones(cones), device="cpu")


def _company_witness(name):
    """Lane 0 of ``name`` in a batch with two very different lanes, and
    among two copies of itself."""
    P, q, A, b, cones = BATCHES[name]()
    if not isinstance(A, list):
        A = [A] * len(q)
    cones = tp.port_cones(cones)
    # lane 1: P and q scaled by 1e3 (another cost scale, another static
    # ε, other refinement norms); lane 2: b scaled by 1e-3
    mixed = ([P[0], 1e3 * P[1], P[2 % len(P)]], np.stack([q[0], 1e3 * q[1], q[-1]]),
             [A[0]] * 3, np.stack([b[0], b[1], 1e-3 * b[-1]]))
    copies = ([P[0]] * 3, np.stack([q[0]] * 3), [A[0]] * 3, np.stack([b[0]] * 3))
    out = []
    for P_, q_, A_, b_ in (mixed, copies):
        solver = tt.SparseBatchSolver(P_, q_, A_, b_, cones, _settings(tt), device="cpu")
        sol = solver.solve()
        out.append((sol, solver.iteration_history()))
    return out


@pytest.mark.parametrize("name", BATCHES)
def test_lane_does_not_depend_on_its_company(name):
    (mixed, h_mixed), (copies, h_copies) = _company_witness(name)
    assert mixed.iterations[1] != mixed.iterations[0] or not np.array_equal(h_mixed[1],
                                                                            h_mixed[0])
    for f in ("status", "iterations", "x", "z", "s", "obj_val", "obj_val_dual"):
        assert np.array_equal(getattr(mixed, f)[0], getattr(copies, f)[0], equal_nan=True), f
    assert np.array_equal(h_mixed[0], h_copies[0], equal_nan=True)


def test_refinement_norms_are_per_lane():
    """The refined multifrontal solve of a batch, with right-hand sides 1e8
    apart in scale: each lane's x within 1e-14 relative of the same solve
    of the lane alone, and the small lane refined (its x moved ~1e-8 from
    the unrefined solve) -- one norm over the batch would have stopped its
    sweeps at once.  Not bit for bit: a bucket of one front takes BLAS's
    matrix-vector product alone and the batched product in a batch, which
    sum in other orders.  A [B, N] right-hand side reads as one per lane
    (B = 2 is also the width of the loop's 2-RHS solves); the multifrontal
    solve of a batch refuses anything but [B, N, r]."""
    from clarabel_tpu_torch.cones import ops as cone_ops
    from clarabel_tpu_torch.kkt import sparse as kkt_sparse

    Ps, q, A, b, cones = jsb.banded_qp_batch(2, n=20, seed=8)
    solver = tt.SparseBatchSolver(Ps, q, A, b, tp.port_cones(cones), _settings(tt),
                                  device="cpu")
    P, A_ = solver._P.predia(), solver._A.predia()
    layout, ctx = solver._layout, (solver._skkt, solver._skkt_data)

    def prepare(P, A, batch):
        state = cone_ops.set_identity_scaling(layout, torch.float64, "cpu", batch)
        return loop._kkt_prepare(layout, solver.settings, torch.float64, solver.n, False, P, A,
                                 state, sparse_kkt=ctx)

    factors, K, ok = prepare(P, A_, (2,))
    assert ok.shape == (2,) and bool(ok.all())
    N = solver._skkt.N
    rhs = torch.as_tensor(np.random.default_rng(9).normal(size=(2, N)))
    rhs[1] *= 1e8
    x, okr = loop.solve_kkt_refined(factors, K, rhs, solver.settings)
    assert x.shape == (2, N) and okr.shape == (2,) and bool(okr.all())
    for i in range(2):
        fi, Ki, _ = prepare(P.with_data(P.data[i]).predia(), A_.with_data(A_.data[i]).predia(),
                            ())
        xi, oki = loop.solve_kkt_refined(fi, Ki, rhs[i], solver.settings)
        raw = kkt_sparse.solve(*fi[1], rhs[i])
        scale = float(xi.abs().max())
        assert float((x[i] - xi).abs().max()) <= 1e-14 * scale and bool(oki)
        assert float((xi - raw).abs().max()) >= 1e-10 * scale  # the lane's sweeps ran
    # the refinement itself on [B, N, 1]: the same solution, per-lane ok
    xr, okr = kkt_dense.solve_refined(factors, K, rhs.unsqueeze(-1), solver.settings)
    assert torch.equal(xr[..., 0], x) and okr.shape == (2,)
    with pytest.raises(ValueError, match=r"\[B, N, r\]"):
        kkt_sparse.solve(*factors[1], rhs)

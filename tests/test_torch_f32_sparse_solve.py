"""Whole f32 solves of clarabel_tpu_torch on the sparse multifrontal path
against the JAX package's f32 solves of the same problems, on the CPU, under
``tests/_torch_parity.assert_f32_matches``: the same status, iterations
within 2, objectives within 1e-4 relative of each other and each within
1e-4 of the port's f64 solve, x within 1e-3·(1 + ‖x‖∞).

- the JAX bench's banded QP at n = 200 (a DIA recipe: the fused factor and
  the recipe matvec's ``.df``);
- the reference's zero + SOC problem at d = 60, its SOC on the rank-2
  expansion (the segment matvec's ``.df``), reached at this size by
  lowering ``SOC_NO_EXPANSION_MAX_SIZE_F32`` in both packages' ``kkt.sparse``
  (an attribute patched for the test; f32 keeps SOCs up to 256 dense);
- the basic generalized power cone program (its cone kept dense at f32);
- an entropy maximization over 8 exponential cones (``stable_inverse``);
- ``SparseBatchSolver(dtype="float32")`` on the JAX package's banded QP
  batch (B = 4, n = 60), lane by lane against the JAX package's f32
  SparseBatchSolver and the port's f64 batch.

Each port solve runs with counters on the refinement's compensated products
(``.df`` of the DIA and the segment matvec), on ``cones.ops.mul_hs_df`` and
on the lo-complete Δτ (``loop._dtau_terms_df``): at f32 the refinement
runs through ``.df``, and the Δs recovery takes the K-consistent route
through it, never ``mul_hs_df``; the Δτ stays plain (the sparse path's COO
P); at f64 none of them runs.  Besides, the banded QP solved through the
unblocked kernel's route (``multifrontal._diag_factor_ldl``, its plain twin
on the CPU) ends as the pivot scan's route does.
"""

import collections
import functools

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import chip_smoke
import clarabel_tpu as ct
import clarabel_tpu.kkt.sparse as jsparse
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import loop as tloop
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.kkt import multifrontal as tmf
from clarabel_tpu_torch.kkt import sparse as tsparse

import test_sparse_batch as jsb

MF = "multifrontal"


def _banded_qp():
    P, q, A, b, _ = chip_smoke.banded_qp(200, 1)
    return P, q, A, b, [ct.NonnegativeConeT(400)]


def _soc(n=60, seed=3):
    """test_f32_paths.py's zero + SOC problem at d = 60: min ½‖x‖² + qᵀx
    with Σx = 1 and x in the SOC."""
    rng = np.random.default_rng(seed)
    A = sp.vstack([sp.csc_matrix(np.ones((1, n))), -sp.eye(n)], format="csc")
    b = np.concatenate([[1.0], np.zeros(n)])
    return (sp.eye(n, format="csc"), rng.standard_normal(n), A, b,
            [ct.ZeroConeT(1), ct.SecondOrderConeT(n)])


def _genpow():
    """test_f32_paths.py's basic generalized power cone program."""
    A = np.vstack([-np.eye(4), [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0]]])
    return (sp.csc_matrix((4, 4)), np.array([0.0, 0.0, -1.0, 0.0]), sp.csc_matrix(A),
            np.array([0, 0, 0, 0, 1.0, 1.0, 0.5]), [ct.GenPowerConeT([0.5, 0.5], 2),
                                                    ct.ZeroConeT(3)])


def _entropy(k=8):
    """test_f32_paths.py's entropy maximization at k = 8: max Σ t_i with
    (t_i, p_i, 1) in the exponential cone, Σ p = 1, p ≥ 0."""
    nn = 2 * k
    q = np.zeros(nn)
    q[k:] = -1.0
    Aexp, bexp = np.zeros((3 * k, nn)), np.zeros(3 * k)
    for i in range(k):
        Aexp[3 * i, k + i] = -1.0
        Aexp[3 * i + 1, i] = -1.0
        bexp[3 * i + 2] = 1.0
    Asum = np.zeros((1, nn))
    Asum[0, :k] = 1.0
    Apos = np.hstack([-np.eye(k), np.zeros((k, k))])
    A = np.vstack([Aexp, Asum, Apos])
    b = np.concatenate([bexp, [1.0], np.zeros(k)])
    cones = [ct.ExponentialConeT()] * k + [ct.ZeroConeT(1), ct.NonnegativeConeT(k)]
    return sp.csc_matrix((nn, nn)), q, sp.csc_matrix(A), b, cones


#: name -> (the problem, what the solve must exercise)
PROBLEMS = {
    "banded_qp": (_banded_qp, "dia"),
    "soc_expanded": (_soc, "segment"),
    "genpow": (_genpow, "dia"),
    "entropy": (_entropy, "dia"),
}


def expand_small_socs(monkeypatch):
    """SOCs above 4 rows take the rank-2 expansion at f32 too, in both
    packages (the reference's threshold; f32 keeps them dense up to 256)."""
    for module in (jsparse, tsparse):
        monkeypatch.setattr(module, "SOC_NO_EXPANSION_MAX_SIZE_F32", 4)


@functools.cache
def jax_f32(name):
    """The JAX package's f32 multifrontal solve of problem ``name``, as a
    Lane, and whether it expanded its SOCs."""
    P, q, A, b, cones = PROBLEMS[name][0]()
    solver = ct.DefaultSolver(P, q, A, b, cones,
                              ct.DefaultSettings.for_float32(verbose=False,
                                                             direct_solve_method=MF),
                              dtype="float32", device=jax.devices("cpu")[0])
    solver.solve()
    return tp.lane_of(solver), solver._skkt.soc_expanded


def port_solve(name, dtype):
    P, q, A, b, cones = PROBLEMS[name][0]()
    make = (tt.DefaultSettings.for_float32 if dtype == "float32" else tt.DefaultSettings)
    solver = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones),
                              make(verbose=False, direct_solve_method=MF), dtype=dtype,
                              device="cpu")
    solver.solve()
    return solver


def counters(monkeypatch):
    """Counts of the compensated sparse products (by matvec path), of
    ``mul_hs_df`` and of the lo-complete Δτ in what runs next."""
    calls = collections.Counter()
    dia_mv, seg_df = tsparse._dia_mv, tsparse.sym_matvec_df

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def dia(*args):
        mv = dia_mv(*args)
        mv.df = counted("dia", mv.df)
        return mv

    monkeypatch.setattr(tsparse, "_dia_mv", dia)
    monkeypatch.setattr(tsparse, "sym_matvec_df", counted("segment", seg_df))
    monkeypatch.setattr(tops, "mul_hs_df", counted("mul_hs_df", tops.mul_hs_df))
    monkeypatch.setattr(tloop, "_dtau_terms_df", counted("dtau_df", tloop._dtau_terms_df))
    return calls


@pytest.mark.parametrize("name", ["soc_expanded"])
def test_f32_multifrontal_matches_reference(name, monkeypatch):
    check_f32_multifrontal(name, monkeypatch)


def check_f32_multifrontal(name, monkeypatch):
    """The f32 multifrontal solve of problem ``name`` against the JAX
    package's, with SOCs above 4 rows expanded in both packages
    (:func:`expand_small_socs`) and :func:`counters` on its compensated
    products;
    the banded QP, the entropy problem and the generalized power cone are
    held in test_torch_f32_sparse_solve_qp.py and _nonsym.py, files of one
    and two tests that pytest-xdist's loadfile scheduling runs beside
    tests/test_df_lu.py."""
    expand_small_socs(monkeypatch)
    calls = counters(monkeypatch)
    ref, jax_expanded = jax_f32(name)
    got = port_solve(name, "float32")
    assert got._sparse and got.info.linear_solver.name == MF
    assert got._skkt.soc_expanded == jax_expanded
    assert got._skkt.soc_expanded == ((True,) if name == "soc_expanded" else ())
    assert not got._skkt.genpow_expanded
    assert got._skkt.nonsym == (name in ("genpow", "entropy"))
    path = PROBLEMS[name][1]
    assert bool(got._skkt.dia_offsets) == (path == "dia")
    assert bool(got._skkt.dia_recipe) == (name == "banded_qp")
    # the refinement and the Δs recovery through the compensated product of
    # the problem's matvec path; no mul_hs_df, no lo-complete Δτ
    assert calls[path] > 0 and calls["dia" if path == "segment" else "segment"] == 0
    assert calls["mul_hs_df"] == 0 and calls["dtau_df"] == 0, calls
    calls.clear()
    f64 = port_solve(name, "float64")
    assert not calls, calls  # f64 refines plainly
    tp.assert_f32_matches(tp.lane_of(got), ref, tp.lane_of(f64))
    assert got.solution.status == tt.SolverStatus.Solved


def test_f32_multifrontal_through_the_kernel_route(monkeypatch):
    """The banded QP at f32 with the fronts' diagonal blocks factored
    through ``_diag_factor_ldl`` (the kernel's route; its plain twin on a
    CPU tensor) ends as the pivot scan's route does: the same status,
    iterations within 2 and objectives within 1e-4 relative."""
    scan = port_solve("banded_qp", "float32").solution
    monkeypatch.setattr(tmf, "mf_factor", functools.partial(tmf.mf_factor,
                                                            diag_fn=tmf._diag_factor_ldl))
    twin = port_solve("banded_qp", "float32").solution
    assert twin.status == scan.status == tt.SolverStatus.Solved
    assert abs(twin.iterations - scan.iterations) <= 2
    assert abs(twin.obj_val - scan.obj_val) <= 1e-4 * max(1.0, abs(scan.obj_val))


@functools.cache
def _batch_reference():
    P, q, A, b, cones = jsb.banded_qp_batch(4, n=60, seed=11)
    settings = ct.DefaultSettings.for_float32(verbose=False, direct_solve_method="multifrontal")
    solver = ct.SparseBatchSolver(P, q, A, b, cones, settings, dtype="float32")
    return tp.lanes_of(solver, solver.solve(), ct.SolverStatus)


@functools.cache
def _batch_port(dtype):
    P, q, A, b, cones = jsb.banded_qp_batch(4, n=60, seed=11)
    make = tt.DefaultSettings.for_float32 if dtype == "float32" else tt.DefaultSettings
    solver = tt.SparseBatchSolver(P, q, A, b, tp.port_cones(cones),
                                  make(verbose=False, direct_solve_method="multifrontal"),
                                  dtype=dtype, device="cpu")
    return tp.lanes_of(solver, solver.solve(), tt.SolverStatus)


@pytest.mark.parametrize("lane", range(4))
def test_f32_sparse_batch_lane_matches_reference(lane):
    got = _batch_port("float32")[lane]
    assert got.x.dtype == np.float32
    tp.assert_f32_matches(got, _batch_reference()[lane], _batch_port("float64")[lane])

"""f32 on the routes into and around the sparse path of clarabel_tpu_torch,
against the JAX package's f32 solves of the same problems on the CPU, under
``tests/_torch_parity.assert_f32_matches`` (the same status, iterations
within 2, objectives within 1e-4 relative of each other and of the port's
f64 solve, x within 1e-3·(1 + ‖x‖∞)):

- "auto" on the JAX bench's banded SDP at tri(77): past the size gate,
  chordally decomposed, the CPU cost model keeps the multifrontal engine;
  the f32 PSD Hs values of the cliques enter the assembled K (the sparse
  path takes no K_lo);
- "auto" on the dual max-cut of a sparse order-78 graph: decomposed, then
  the cost model's veto sends it back to the dense path, where f32 "lu"
  takes the Jacobi-equilibrated LU (N above ``DF_LU_MAX_DIM``);
The routes' fields (``_sparse``, the linear solver's name, dimension and
nnz(L), the cost model's decision) equal the JAX package's.  The routes
alone (constructions) of two more problems are held in
``test_torch_f32_sparse.py``.
"""

import functools

import jax
import pytest

import _torch_parity as tp
import chip_smoke
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu_torch.kkt import dense as tdense



def _banded_sdp():
    P, q, A, b, _ = chip_smoke.banded_sdp(77)
    return P, q, A, b, [ct.PSDTriangleConeT(77)]


def _maxcut_dual():
    P, q, A, b = chip_smoke.maxcut_dual(78, 2, 1)[:4]
    return P, q, A, b, [ct.PSDTriangleConeT(78)]


#: name -> (the problem, sparse after the cost model)
ROUTES = {"chordal_sdp": (_banded_sdp, True), "veto_dense": (_maxcut_dual, False)}


@functools.cache
def jax_f32(name):
    P, q, A, b, cones = ROUTES[name][0]()
    solver = ct.DefaultSolver(P, q, A, b, cones, ct.DefaultSettings.for_float32(verbose=False),
                              dtype="float32", device=jax.devices("cpu")[0])
    solver.solve()
    return solver


def port_solve(name, dtype):
    P, q, A, b, cones = ROUTES[name][0]()
    make = tt.DefaultSettings.for_float32 if dtype == "float32" else tt.DefaultSettings
    solver = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), make(verbose=False),
                              dtype=dtype, device="cpu")
    solver.solve()
    return solver


@pytest.mark.parametrize("name", ROUTES)
def test_f32_auto_route_matches_reference(name):
    ref = jax_f32(name)
    got = port_solve(name, "float32")
    sparse = ROUTES[name][1]
    assert got._sparse == ref._sparse == sparse
    assert got._chordal is not None and ref._chordal is not None
    for field in ("name", "dim", "nnzL"):
        assert getattr(got.info.linear_solver, field) == getattr(ref.info.linear_solver, field)
    assert got.info.linear_solver.cost_model["decision"] == \
        ref.info.linear_solver.cost_model["decision"] == ("multifrontal" if sparse else "dense")
    if not sparse:  # the dense f32 "lu" above the double-float LU's sizes
        assert got.info.linear_solver.dim > tdense.DF_LU_MAX_DIM
    f64 = port_solve(name, "float64")
    tp.assert_f32_matches(tp.lane_of(got), tp.lane_of(ref), tp.lane_of(f64))

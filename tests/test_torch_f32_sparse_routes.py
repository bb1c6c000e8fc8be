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
alone (constructions) of two more problems, and the whole "veto_dense"
solve (its JAX f32 compile alone takes over a minute, more than a file of
one or two tests may take beside tests/test_df_lu.py under pytest-xdist's
loadfile scheduling), are held in ``test_torch_f32_sparse.py``; both files
run ``_torch_parity.check_f32_route``.
"""

import pytest

import _torch_parity as tp


@pytest.mark.parametrize("name", ["chordal_sdp"])
def test_f32_auto_route_matches_reference(name):
    tp.check_f32_route(name)

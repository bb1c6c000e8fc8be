"""A whole f32 solve of a strictly complementary SDP through clarabel_tpu_torch
against the JAX package's, both on the CPU, as test_torch_f32_psd_solve.py
states it: the same status, iterations within 4, the objective within 1e-4
relative, x and z within 1e-3 of the larger of 1 and their largest entry.
A file of one test (one JAX f32 compile, about 30 s), which pytest-xdist's
loadfile scheduling runs beside tests/test_df_lu.py.
"""

import jax
import numpy as np

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from test_torch_f32_psd_solve import F32, _strict_comp_sdp


def test_f32_sdp_solve_matches_the_jax_package():
    """A strictly complementary SDP (PSDTriangleConeT(3), n = 4) at f32
    through "auto" (the double-float LU with K_lo), against the JAX
    package's solve of it: the one JAX compile here."""
    P, q, A, b, cones, x, s, z = _strict_comp_sdp(1, 4, 3, 0)
    P, q, A, b = P[0], q[0], A[0], b[0]
    ref = ct.DefaultSolver(P, q, A, b, [ct.PSDTriangleConeT(3)], F32, dtype="float32",
                           device=jax.devices("cpu")[0]).solve()
    solver = tt.DefaultSolver(P, q, A, b, cones, tp.port_settings(F32), dtype="float32",
                              device="cpu")
    got = solver.solve()
    assert solver.info.linear_solver.name == "lu"
    assert got.status == ref.status == tt.SolverStatus.Solved
    assert abs(got.iterations - ref.iterations) <= 4
    assert abs(got.obj_val - ref.obj_val) <= 1e-4 * max(1.0, abs(ref.obj_val))
    for g, r in ((got.x, ref.x), (got.z, ref.z)):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= 1e-3 * max(1.0, np.abs(r).max())
    assert np.abs(got.x - x[0]).max() <= 1e-3

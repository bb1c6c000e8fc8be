"""f32 on PSD layouts in clarabel_tpu_torch against the JAX package, both on
the CPU: the f32 centering recovery of ``loop.py`` and whole solves (the
double-float PSD scaling and the refinement they run are held to the JAX
package piece by piece in ``test_torch_f32_psd.py``).

Tolerances, and why:
- the centering direction within 1e-3 of the largest entry of the JAX
  package's kkt_solve of the same right-hand side on its own factors
  (test_torch_f32_psd_centering.py);
- a whole f32 solve of a strictly complementary SDP through "auto"
  (test_torch_f32_psd_sdp_solve.py, one JAX compile of about 30 s; each of
  these two in a file of its own, which pytest-xdist's loadfile scheduling
  runs beside tests/test_df_lu.py): the same status, iterations within
  4 (the JAX package's own spread on strictly complementary SDP end games,
  chip_smoke.SDP_ITERATIONS_APART), the objective within 1e-4 relative, x
  and z within 1e-3 of the larger of 1 and their largest entry (the f32
  tolerances of tests/test_torch_f32_dense.py);
- the batches, from the generator's own optimum (x*, s*, z*): every lane
  Solved through "auto" with x within 1e-3 of x*; a lane equal bit for bit
  to its solve as a batch of one.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (pins torch's threads)
import clarabel_tpu as ct
import clarabel_tpu_torch as tt

F32 = ct.DefaultSettings.for_float32(verbose=False)
SQRT2 = np.sqrt(2.0)


def _t(v):
    return torch.as_tensor(np.array(v))


def _svec(M):
    n = M.shape[-1]
    return np.array([M[i, j] * (1.0 if i == j else SQRT2) for j in range(n) for i in range(j + 1)])


# ---------------------------------------------------------------------
# the problems: strictly complementary SDPs from a known optimum
# ---------------------------------------------------------------------


def _strict_comp_sdp(B, n, d, seed, nn=0):
    """B strictly complementary problems from a known primal-dual optimum
    (the JAX bench's batched SDP, bench.py:194-256): x* interior, S* ⊥ Z* of
    ranks d//2 and d - d//2 on one PSDTriangleConeT(d) (rows s = -x[:tri]
    + b), NonnegativeConeT(nn) on ±x when nn = 2n, with a quarter of them
    active.  Returns (P, q, A, b, cones, x*, s*, z*)."""
    rng = np.random.default_rng(seed)
    tri = d * (d + 1) // 2
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(n)
    Apsd = np.zeros((tri, n))
    Apsd[:, :min(tri, n)] = -np.eye(tri)[:, :min(tri, n)]
    rows = [Apsd] if not nn else [np.eye(n), -np.eye(n), Apsd]
    A = np.tile(np.vstack(rows), (B, 1, 1))
    x = 0.5 * rng.normal(size=(B, n))
    s_nn, z_nn = rng.uniform(0.5, 1.5, (B, nn)), np.zeros((B, nn))
    act = rng.uniform(size=(B, nn)) < 0.25
    z_nn[act] = rng.uniform(0.5, 1.5, act.sum())
    s_nn[act] = 0.0
    Q, _ = np.linalg.qr(rng.normal(size=(B, d, d)))
    k = d // 2
    S = np.einsum("bik,bk,bjk->bij", Q[:, :, :k], rng.uniform(0.5, 1.5, (B, k)), Q[:, :, :k])
    Z = np.einsum("bik,bk,bjk->bij", Q[:, :, k:], rng.uniform(0.5, 1.5, (B, d - k)), Q[:, :, k:])
    s = np.concatenate([s_nn, np.stack([_svec(v) for v in S])], axis=1)
    z = np.concatenate([z_nn, np.stack([_svec(v) for v in Z])], axis=1)
    b = np.einsum("bmn,bn->bm", A, x) + s
    q = -(np.einsum("bij,bj->bi", P, x) + np.einsum("bmn,bm->bn", A, z))
    cones = ([tt.NonnegativeConeT(nn)] if nn else []) + [tt.PSDTriangleConeT(d)]
    return P, q, A, b, cones, x, s, z


# ---------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------


def _batch(method, P, q, A, b, cones):
    return tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings.for_float32(
        verbose=False, direct_solve_method=method), dtype="float32", device="cpu").solve()


def test_f32_sdp_batch_auto_and_lane_alone():
    """B = 4 of the JAX bench's SDP class (n = 16, NonnegativeConeT(32) and
    PSDTriangleConeT(4), N = 58) through "auto": every lane Solved, x within
    1e-3 of x*; each lane bit for bit its solve as a batch of one."""
    P, q, A, b, cones, x, _, _ = _strict_comp_sdp(4, 16, 4, 96, nn=32)
    sol = _batch("auto", P, q, A, b, cones)
    assert sol.statuses() == [tt.SolverStatus.Solved] * 4
    assert np.abs(sol.x - x).max() <= 1e-3
    for i in range(4):
        one = _batch("auto", P[[i]], q[[i]], A[[i]], b[[i]], cones)
        for f in ("x", "s", "z", "obj_val", "iterations"):
            np.testing.assert_array_equal(getattr(sol, f)[i], getattr(one, f)[0], err_msg=f)


@pytest.mark.parametrize("method", ["pallas", "schur"])
def test_f32_sdp_batch_other_methods(method):
    """The same batch through "pallas" (the LDLᵀ's f32 twin, refined
    against (K, K_lo)) and "schur" (the Schur complement of the f32 KKT).
    The JAX package's own "pallas" leaves 6 of this class's 64 lanes short
    of Solved and its "schur" solves 2 of them (scripts/
    f32_reference_status.py --problem sdp64, on the CPU): an unpivoted f32
    factor at cond(K) ~ 1/μ² ~ 1e10, and a condensation through Hs, whose
    NT blocks span [~μ, ~1/μ] there.  So
    each lane ends Solved, with x within 1e-3 of x*, or short of it after at
    least 4 iterations (the lanes' first 4 iterates are well conditioned);
    "pallas" solves at least 3 of the 4 lanes."""
    P, q, A, b, cones, x, _, _ = _strict_comp_sdp(4, 16, 4, 96, nn=32)
    sol = _batch(method, P, q, A, b, cones)
    names = [s.name for s in sol.statuses()]
    assert set(names) <= {"Solved", "AlmostSolved", "InsufficientProgress", "NumericalError"}
    for i, name in enumerate(names):
        if name == "Solved":
            assert np.abs(sol.x[i] - x[i]).max() <= 1e-3
        else:
            assert sol.iterations[i] >= 4
    if method == "pallas":
        assert names.count("Solved") >= 3


def test_f32_decomposed_psd_cone():
    """A PSD(6) cone whose [A; b] rows touch only a band decomposes into its
    cliques (the guard test's problem), and solves at f32 through "auto"
    within 1e-3 of its f64 solve."""
    n = 6
    pairs = [(i, j) for j in range(n) for i in range(j + 1) if j - i <= 1]
    A = np.zeros((21, len(pairs)))
    for k, (i, j) in enumerate(pairs):
        A[j * (j + 1) // 2 + i, k] = -1.0
    args = (np.eye(len(pairs)), -np.ones(len(pairs)), A, np.zeros(21), [tt.PSDTriangleConeT(n)])
    f32 = tt.DefaultSolver(*args, tt.DefaultSettings.for_float32(verbose=False),
                           dtype="float32", device="cpu")
    f64 = tt.DefaultSolver(*args, tt.DefaultSettings(verbose=False), device="cpu")
    assert f32._chordal is not None and f32.info.linear_solver.name == "lu"
    got, ref = f32.solve(), f64.solve()
    assert got.status == ref.status == tt.SolverStatus.Solved
    assert abs(got.obj_val - ref.obj_val) <= 1e-3 * max(1.0, abs(ref.obj_val))

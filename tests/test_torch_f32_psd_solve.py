"""f32 on PSD layouts in clarabel_tpu_torch against the JAX package, both on
the CPU: the f32 centering recovery of ``loop.py`` and whole solves (the
double-float PSD scaling and the refinement they run are held to the JAX
package piece by piece in ``test_torch_f32_psd.py``).

Tolerances, and why:
- the centering direction within 1e-3 of the largest entry of the JAX
  package's kkt_solve of the same right-hand side on its own factors;
- a whole f32 solve of a strictly complementary SDP through "auto", the one
  JAX compile of this file (about 30 s): the same status, iterations within
  4 (the JAX package's own spread on strictly complementary SDP end games,
  chip_smoke.SDP_ITERATIONS_APART), the objective within 1e-4 relative, x
  and z within 1e-3 of the larger of 1 and their largest entry (the f32
  tolerances of tests/test_torch_f32_dense.py);
- the batches, from the generator's own optimum (x*, s*, z*): every lane
  Solved through "auto" with x within 1e-3 of x*; a lane equal bit for bit
  to its solve as a batch of one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu import loop as jloop
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import loop as tloop
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import dense as tdense

F32 = ct.DefaultSettings.for_float32(verbose=False)
SQRT2 = np.sqrt(2.0)


def _t(v):
    return torch.as_tensor(np.array(v))


def _svec(M):
    n = M.shape[-1]
    return np.array([M[i, j] * (1.0 if i == j else SQRT2) for j in range(n) for i in range(j + 1)])


# ---------------------------------------------------------------------
# the f32 centering recovery (loop.py)
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


def test_centering_recovery_choice():
    """Three lanes at one interior iterate of the strictly complementary
    SDP, the combined step's α and the affine α_aff set per lane: lane 0
    collapsed after a healthy affine step (α = 0.02, α_aff = 0.9) takes the
    centering direction and its step; lane 1 (α = 0.5: not collapsed) and
    lane 2 (α_aff = 0.05: the affine step was short too) keep theirs.  The
    centering direction is the JAX package's kkt_solve of the same
    right-hand side on its own factors (the JAX package's loop.py:1193-1208),
    within 1e-3 of its largest entry."""
    P, q, A, b, cones, x, s, z = _strict_comp_sdp(1, 4, 3, 9)
    P, q, A, b = P[0], q[0], A[0], b[0]
    layout = TorchLayout(tt.cones.api.collapse_cones(cones))
    n = q.shape[0]
    rng = np.random.default_rng(10)
    # an interior iterate near the optimum
    zi = (z[0] + 0.05 * _svec(np.eye(3))).astype(np.float32)
    si = (s[0] + 0.05 * _svec(np.eye(3))).astype(np.float32)
    xi = (x[0] + 0.01 * rng.normal(size=n)).astype(np.float32)
    tau = kappa = np.float32(1.0)
    lanes = lambda v: torch.stack([_t(np.asarray(v, np.float32))] * 3)
    Pt, qt, At, bt = (lanes(v) for v in (P, q, A, b))
    X, S, Z = lanes(xi), lanes(si), lanes(zi)
    T, Kp = torch.ones(3), torch.ones(3)
    tset = tp.port_settings(F32)
    r = tloop.compute_residuals(Pt, qt, At, bt, X, S, Z, T, Kp)
    mu = tloop.calc_mu(layout, r, T, Kp)
    state, _ = tops.update_scaling(layout, tops.set_identity_scaling(
        layout, torch.float32, "cpu", (3,)), S, Z, mu, torch.zeros(3, dtype=torch.int32))
    factors, K, _ = tloop._kkt_prepare(layout, tset, torch.float32, n, False, Pt, At, state)
    assert isinstance(K, tuple) and factors[0] == "df_lu"
    variables = (X, S, Z, T, Kp)
    aff_rhs = (r.rx, tops.affine_ds(layout, state, S), r.rz, r.rtau, T * Kp)
    sol_c, _ = tdense.solve_refined(factors, K, torch.cat([-qt, bt], dim=-1), tset,
                                    want_lo=True)
    x2 = (sol_c[0][..., :n], sol_c[1][..., :n])
    z2 = (sol_c[0][..., n:], sol_c[1][..., n:])
    comb = tuple(torch.full_like(v, 7.0) for v in (X, S, Z, T, Kp))
    alpha = torch.tensor([0.02, 0.5, 0.02])
    alpha_aff = torch.tensor([0.9, 0.9, 0.05])
    tloop._centering_recovery.centering_steps = 0
    got, a, fail = tloop._centering_recovery(
        layout, tset, state, factors, K, Pt, qt, At, bt, x2, z2, r, mu, aff_rhs, variables,
        torch.zeros(3, dtype=torch.int32), False, comb, alpha, alpha_aff,
        torch.zeros(3, dtype=torch.bool), torch.zeros(3, dtype=torch.bool))
    assert int(tloop._centering_recovery.centering_steps) == 1
    assert not fail.any() and a[0] > 0.04 and a[1:].tolist() == pytest.approx([0.5, 0.02])
    for g, c in zip(got, comb):
        assert torch.equal(g[1:], c[1:]) and not torch.equal(g[0], c[0])

    # the JAX package's centering direction at the same iterate
    jl = JaxLayout(ct.cones.api.collapse_cones([ct.PSDTriangleConeT(3)]))
    J = lambda v: jnp.asarray(np.asarray(v, np.float32))
    jr = jloop.compute_residuals(J(P), J(q), J(A), J(b), J(xi), J(si), J(zi), J(tau), J(kappa))
    jmu = jloop.calc_mu(jl, jr, J(tau), J(kappa))
    jstate, _ = jops.update_scaling(jl, jops.set_identity_scaling(jl, jnp.float32), J(si),
                                    J(zi), jmu, 0)
    jfac, jK, _ = jloop._kkt_prepare(jl, F32, jnp.float32, n, False, J(P), J(A), jstate)
    jsc, _ = jloop.solve_kkt_refined(jfac, jK, jnp.concatenate([-J(q), J(b)]), F32, want_lo=True)
    jx2 = (jsc[0][:n], jsc[1][:n])
    jz2 = (jsc[0][n:], jsc[1][n:])
    jaff1 = jops.affine_ds(jl, jstate, J(si))
    shift = jops.combined_ds_shift(jl, jstate, jnp.zeros(jl.m, jnp.float32),
                                   jnp.zeros(jl.m, jnp.float32), jmu, J(zi))
    cent_rhs = (jnp.zeros(n, jnp.float32), jaff1 + shift, jnp.zeros(jl.m, jnp.float32),
                jnp.zeros((), jnp.float32), -jmu + J(tau) * J(kappa))
    jcent, _ = jloop.kkt_solve(jl, jstate, jfac, jK, J(P), J(q), J(A), J(b), jx2, jz2,
                               cent_rhs, (J(xi), J(si), J(zi), J(tau), J(kappa)), F32,
                               is_combined=True)
    for g, ref in zip(got, jcent):
        ref = np.asarray(ref, np.float64)
        assert np.abs(g[0].double().numpy() - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())


# ---------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------


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

"""The Schur-complement KKT paths of clarabel_tpu_torch ("schur_diag",
"schur_lr" and "schur") against the JAX package's, at f64 on the CPU.

Modules: the diagonal and diagonal-plus-rank-1 forms of Hs against the JAX
package's and against the port's own dense Hs (1e-12 relative, as
tests/test_torch_cones.py: the same arithmetic, summed in other orders);
each Schur engine's refined solve against the JAX engine's and against the
port's pivoted-LU solve (atol 1e-8, as the JAX package's
test_schur_lr_solve_matches_lu), one problem and a batch of three with one
lane whose Schur complement is indefinite.  The slice: whole solves through
each explicit method, held to the JAX package by the parity contract of
tests/_torch_parity.py, and the routing of a method on a layout it cannot
represent.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu.cones import api as japi, ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.kkt import dense as jdense
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import convert
from clarabel_tpu_torch.cones import api as tapi, ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import dense as tdense
from test_torch_cones import JL, TL, _interior

SETTINGS = ct.DefaultSettings(verbose=False)
PORT_SETTINGS = tp.port_settings(SETTINGS)


def _close(got, ref, rel=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * scale


@jax.jit
def _jax_hs_forms(s, z):
    """The JAX package's scalings at (s, z) and its (h, U) and diag(Hs)."""
    state, _ = jops.update_scaling(JL, jops.set_identity_scaling(JL, jnp.float64), s, z,
                                   jnp.asarray(1.0), jnp.asarray(0, jnp.int32))
    return jops.hs_diag_lowrank(JL, state, jnp.float64), jops.hs_diag(JL, state, jnp.float64)


def test_hs_diag_lowrank_matches_jax_and_hs_dense():
    rng = np.random.default_rng(11)
    s, z = _interior(rng, JL), _interior(rng, JL)
    tstate, tok = tops.update_scaling(TL, tops.set_identity_scaling(TL, torch.float64, "cpu"),
                                      torch.as_tensor(s), torch.as_tensor(z), None, None)
    assert bool(tok)
    h, U = tops.hs_diag_lowrank(TL, tstate, torch.float64, "cpu")
    (jh, jU), jdiag = _jax_hs_forms(jnp.asarray(s), jnp.asarray(z))
    _close(h, jh)
    _close(U, jU)
    # Hs = diag(h) + U Uᵀ, against the port's own dense Hs
    _close(torch.diag(h) + U @ U.T, tops.hs_dense(TL, tstate, torch.float64, "cpu"))
    _close(tops.hs_diag(TL, tstate, torch.float64, "cpu"), jdiag)
    # a batch of two: each lane its own
    hb, Ub = tops.hs_diag_lowrank(TL, {k: torch.stack([v, 2.0 * v]) for k, v in tstate.items()},
                                  torch.float64, "cpu", (2,))
    _close(hb[0], h)
    _close(Ub[0], U)


# the cones of each engine's module test: "schur_diag" represents zero/NN
# scalings only; "schur" is held on a layout without zero cones, as the JAX
# package's own tests hold it (their rows' H is only ε)
ENGINE_CONES = {
    "schur_diag": [ct.ZeroConeT(2), ct.NonnegativeConeT(5)],
    "schur_lr": [ct.ZeroConeT(2), ct.NonnegativeConeT(5), ct.SecondOrderConeT(4),
                 ct.SecondOrderConeT(3)],
    "schur": [ct.NonnegativeConeT(5), ct.SecondOrderConeT(4), ct.SecondOrderConeT(3)],
}


def _kkt_data(method, seed, indefinite=False):
    """P, A, an interior (s, z) and a right-hand side for ``method``'s
    layout, from a numpy seed; ``indefinite`` makes P = -1e3·I, so no Schur
    complement of the KKT matrix is positive definite."""
    cones = ENGINE_CONES[method]
    jl = JaxLayout(japi.collapse_cones(cones))
    n, m, p = 7, jl.m, jl.n_zero
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = -1e3 * np.eye(n) if indefinite else M @ M.T + np.eye(n)
    A = rng.standard_normal((m, n))
    s, z = _interior(rng, jl), _interior(rng, jl)
    s[:p] = 0.0
    return jl, P, A, s, z, rng.standard_normal(n + m)


@functools.cache
def _jax_engine(method, cones):
    """The JAX engine's refined solve for ``method`` on the layout of
    ``cones``, jitted once: (P, A, s, z, rhs) -> (x, ok)."""
    jl = JaxLayout(japi.collapse_cones(cones))

    def solve(P, A, s, z, rhs):
        state, ok_scale = jops.update_scaling(
            jl, jops.set_identity_scaling(jl, jnp.float64), s, z, jnp.asarray(1.0),
            jnp.asarray(0, jnp.int32))
        if method == "schur_diag":
            eq_mask = np.zeros(jl.m, np.float32)
            eq_mask[: jl.n_zero] = 1.0
            fac, K, okf = jdense.prepare_schur_diag(
                P, A, jops.hs_diag(jl, state, jnp.float64), SETTINGS, eq_mask)
        elif method == "schur_lr":
            h, U = jops.hs_diag_lowrank(jl, state, jnp.float64)
            fac, K, okf = jdense.prepare_schur_lowrank(P, A, h, U, SETTINGS, n_eq=jl.n_zero)
        else:
            K, K_reg = jdense.assemble(P, A, jops.hs_dense(jl, state, jnp.float64)[0], SETTINGS)
            fac, okf = jdense.factor_schur(K_reg, P.shape[0])
        x, oks = jdense.solve_refined(fac, K, rhs, SETTINGS)
        return x, ok_scale & okf & oks

    return jax.jit(solve)


def _jax_solve(method, jl, P, A, s, z, rhs):
    """The JAX engine's refined solve: (x, ok)."""
    x, ok = _jax_engine(method, tuple(ENGINE_CONES[method]))(
        *(jnp.asarray(v) for v in (P, A, s, z, rhs)))
    return np.asarray(x), bool(ok)


def _port_solve(method, jl, P, A, s, z, rhs):
    """The port's refined solves through ``method`` and through pivoted LU,
    over any leading batch dimension: (x, ok, x_lu)."""
    tl = TorchLayout(convert.cones_from_specs(convert.cone_specs(jl.cones)))
    T = lambda v: torch.as_tensor(v, dtype=torch.float64)
    P, A, s, z, rhs = map(T, (P, A, s, z, rhs))
    batch = rhs.shape[:-1]
    state, ok = tops.update_scaling(
        tl, tops.set_identity_scaling(tl, torch.float64, "cpu", batch), s, z, None, None)
    assert bool(ok.all())
    if method == "schur_diag":
        hs = tops.hs_diag(tl, state, torch.float64, "cpu", batch)
        fac, K, okf = tdense.prepare_schur_diag(
            P, A, hs, PORT_SETTINGS, tl.zero_row_mask(torch.float64, "cpu"))
    elif method == "schur_lr":
        h, U = tops.hs_diag_lowrank(tl, state, torch.float64, "cpu", batch)
        fac, K, okf = tdense.prepare_schur_lowrank(P, A, h, U, PORT_SETTINGS, n_eq=tl.n_zero)
    Hs = tops.hs_dense(tl, state, torch.float64, "cpu", batch)
    K_dense, K_reg = tdense.assemble(P, A, Hs, PORT_SETTINGS)
    if method == "schur":
        fac, okf = tdense.factor_schur(K_reg, P.shape[-1])
        K = K_dense
    x, oks = tdense.solve_refined(fac, K, rhs, PORT_SETTINGS)
    fac_lu, _ = tdense.factor(K_reg)
    x_lu, _ = tdense.solve_refined(fac_lu, K_dense, rhs, PORT_SETTINGS)
    return x.numpy(), (okf & oks).numpy(), x_lu.numpy()


@pytest.mark.parametrize("method", list(ENGINE_CONES))
def test_engine_solve_matches_jax_and_lu(method):
    data = _kkt_data(method, seed=100)
    x_ref, ok_ref = _jax_solve(method, *data)
    x, ok, x_lu = _port_solve(method, *data)
    assert ok_ref and bool(ok)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(x, x_lu, rtol=0, atol=1e-8)


@pytest.mark.parametrize("method", list(ENGINE_CONES))
def test_engine_batch_with_an_indefinite_lane(method):
    """B = 3: two lanes solve as they do alone (1e-12 relative: the same
    factorizations, batched); the third, whose Schur complement is
    indefinite, gets ``ok`` False, as it does in the JAX package, without
    raising or reaching the other lanes."""
    lanes = [_kkt_data(method, seed=100), _kkt_data(method, seed=101),
             _kkt_data(method, seed=102, indefinite=True)]
    jl = lanes[0][0]
    stacked = [np.stack([lane[i] for lane in lanes]) for i in range(1, 6)]
    x, ok, _ = _port_solve(method, jl, *stacked)
    assert ok.tolist() == [True, True, False]
    for i in (0, 1):
        x_one, ok_one, _ = _port_solve(method, *lanes[i])
        assert bool(ok_one)
        _close(x[i], x_one)
    assert not _jax_solve(method, *lanes[2])[1]


# --------------------------------------------------------------------------
# the slice: whole solves
# --------------------------------------------------------------------------

#: (problem, method): "schur" on an LP (NN cones only: the JAX package's
#: tests hold it on no zero cone), the two structured paths on a QP with a
#: zero cone (the δ-proxy of "schur_diag", the second-level elimination of
#: "schur_lr"), and "schur_lr" on an SOCP with zero and NN cones (which
#: "schur_diag" does not represent: test below)
SLICE_CASES = [("lp_feasible", "schur"), ("portfolio_qp", "schur_diag"),
               ("portfolio_qp", "schur_lr"), ("portfolio_socp", "schur_lr")]


@pytest.mark.parametrize("name, method", SLICE_CASES)
def test_port_matches_reference_through_schur(name, method):
    """The parity contract of tests/_torch_parity.py with no backend
    spread: the port's Schur path does the JAX path's arithmetic, so its
    iteration count is the reference's and every history row within
    1e-6·|ref| + 1e-10."""
    tp.assert_port_matches_reference(name, method, pair=(method, method))


def test_f64_explicit_schur_lr_oracle_accuracy():
    """Explicit schur_lr at f64 reaches the full 1e-8 oracle tier, held to
    the port's LU solve as the JAX package's own test holds its schur_lr
    (objective 1e-7, x 1e-6)."""
    P, q, A, b, cones = tp._random_socp(np.random.default_rng(7))
    solve = lambda method: tt.DefaultSolver(
        P, q, A, b, tp.port_cones(cones),
        tt.DefaultSettings(verbose=False, direct_solve_method=method), device="cpu").solve()
    lu, lr = solve("lu"), solve("schur_lr")
    assert lu.status == lr.status == tt.SolverStatus.Solved
    assert abs(lr.obj_val - lu.obj_val) <= 1e-7
    np.testing.assert_allclose(lr.x, lu.x, atol=1e-6)


def test_schur_lr_on_an_exp_layout_raises_for_the_cone():
    """The JAX package demotes schur_lr to LU on an exponential-cone layout.
    At f64 the port does too, bit for bit its "lu" solve; at f32 the
    demoted LU needs the compensated f32 stack, so the port raises for the
    cone's layout, naming item 12b."""
    A = np.vstack([-np.eye(3), [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    b = np.concatenate([np.zeros(3), [1.0, np.exp(5.0)]])
    cones = [tapi.ExponentialConeT(), tapi.ZeroConeT(2)]
    solve = lambda method: tt.DefaultSolver(
        np.zeros((3, 3)), np.array([-1.0, 0.0, 0.0]), A, b, cones,
        tt.DefaultSettings(verbose=False, direct_solve_method=method), device="cpu").solve()
    lr, lu = solve("schur_lr"), solve("lu")
    assert lr.status == tt.SolverStatus.Solved and lr.iterations == lu.iterations
    np.testing.assert_array_equal(lr.x, lu.x)
    with pytest.raises(NotImplementedError, match="item 12b"):
        tt.DefaultSolver(np.zeros((3, 3)), np.array([-1.0, 0.0, 0.0]), A, b, cones,
                         tt.DefaultSettings.for_float32(verbose=False,
                                                        direct_solve_method="schur_lr"),
                         dtype="float32", device="cpu")


def test_schur_diag_on_an_soc_layout_runs_lu():
    """schur_diag represents no SOC block: on an SOC layout it runs pivoted
    LU, bit for bit the "lu" solve, and reports the method asked for, as the
    JAX package does (clarabel_tpu/loop.py:715-723)."""
    got = tp.port("portfolio_socp", "schur_diag")
    lu = tp.port("portfolio_socp", "lu")
    assert got.info.linear_solver.name == "schur_diag"
    np.testing.assert_array_equal(got.solution.x, lu.solution.x)
    assert got.solution.iterations == lu.solution.iterations
    assert got.solution.status == tt.SolverStatus.Solved

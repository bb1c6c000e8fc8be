"""The sparse KKT assembly of clarabel_tpu_torch against the JAX package's,
f64 on the CPU, on data made from a numpy seed:

- ``cones.ops.hs_lower_vals`` and ``expansion_vals`` for every cone kind
  (nonnegative, second-order dense and expanded, exponential, power,
  generalized power dense and expanded, PSD in two buckets), from the JAX
  package's own scaling state, one problem and a batch of two: 1e-12
  relative (the same arithmetic; the SOC sums in another order);
- ``kkt.sparse.assemble``: K and its regularized copy equal to the JAX
  package's to 1e-14 relative (one scatter of the same values);
- ``make_matvec`` on its DIA and its segment path, and
  ``make_matvec_sources``: K·v against the dense K, 1e-13 relative;
- ``factor_fused`` against ``assemble`` + ``factor``: bitwise equal (the
  same values reach the same cells);
- ``equilibration.equilibrate_sparse`` against the JAX package's: 1e-14
  relative (the same operations; maxima are exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu import equilibration as jeq
from clarabel_tpu.algebra.coo import COOMat as JCOO
from clarabel_tpu.cones import ops as jops
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.kkt import sparse as jsparse
from clarabel_tpu_torch import equilibration as teq
from clarabel_tpu_torch.algebra.coo import COOMat as TCOO
from clarabel_tpu_torch.cones import ops as tops
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import sparse as tsparse

CONES = [ct.NonnegativeConeT(3), ct.SecondOrderConeT(3), ct.SecondOrderConeT(6),
         ct.ExponentialConeT(), ct.PowerConeT(0.3), ct.GenPowerConeT([0.2, 0.3, 0.5], 2),
         ct.PSDTriangleConeT(3), ct.PSDTriangleConeT(2), ct.PSDTriangleConeT(3)]
JL = JaxLayout(ct.cones.api.collapse_cones(CONES))
TL = TorchLayout(tp.port_cones(JL.cones))
SETTINGS = ct.DefaultSettings(verbose=False)
TSETTINGS = tp.port_settings(SETTINGS)


def _close(got, ref, rel=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref), initial=0.0)))
    assert np.max(np.abs(got - ref), initial=0.0) <= rel * scale


def _jax_state(seed):
    """The JAX package's scaling state at an interior point near the unit
    initialization (every cone kind, nonsymmetric ones included)."""
    rng = np.random.default_rng(seed)
    z0, s0 = jops.unit_initialization(JL, jnp.float64)
    s = np.asarray(s0) * (1.0 + 0.05 * rng.random(JL.m))
    z = np.asarray(z0) * (1.0 + 0.05 * rng.random(JL.m))
    mu = float(s @ z / (JL.degree + 1))
    state, ok = jops.update_scaling(JL, jops.set_identity_scaling(JL, jnp.float64),
                                    jnp.asarray(s), jnp.asarray(z), mu, 0)
    assert bool(ok)
    return state


def _torch_state(*states):
    """JAX states as the port's: one, or a batch stacked on a leading
    dimension."""
    keys = states[0].keys()
    if len(states) == 1:
        return {k: torch.as_tensor(np.array(states[0][k])) for k in keys}
    return {k: torch.as_tensor(np.stack([np.asarray(s[k]) for s in states])) for k in keys}


SOC_FORMS = [(False, False), (False, True), (True, True)]


@pytest.mark.parametrize("soc_expanded", SOC_FORMS, ids=lambda f: "".join("ED"[not e] for e in f))
@pytest.mark.parametrize("genpow_expanded", [False, True])
def test_hs_lower_and_expansion_values(soc_expanded, genpow_expanded):
    jstates = [_jax_state(1), _jax_state(2)]
    forms = (soc_expanded, genpow_expanded)
    for i, js in enumerate(jstates):
        ts = _torch_state(js)
        _close(tops.hs_lower_vals(TL, ts, torch.float64, "cpu", (), *forms),
               jops.hs_lower_vals(JL, js, jnp.float64, *forms))
        _close(tops.expansion_vals(TL, ts, torch.float64, "cpu", (), *forms),
               jops.expansion_vals(JL, js, jnp.float64, *forms))
    # the coordinates: the host copies give the same arrays
    for jc, tc in zip(jops.hs_lower_coords(JL, *forms), tops.hs_lower_coords(TL, *forms)):
        assert np.array_equal(jc, tc)
    for jc, tc in zip(jops.expansion_coords(JL, *forms), tops.expansion_coords(TL, *forms)):
        assert np.array_equal(jc, tc)
    # a batch of the two states: each row is its problem's values
    tb = _torch_state(*jstates)
    hs = tops.hs_lower_vals(TL, tb, torch.float64, "cpu", (2,), *forms)
    ex = tops.expansion_vals(TL, tb, torch.float64, "cpu", (2,), *forms)
    for i, js in enumerate(jstates):
        _close(hs[i], jops.hs_lower_vals(JL, js, jnp.float64, *forms))
        _close(ex[i], jops.expansion_vals(JL, js, jnp.float64, *forms))


def _problem(seed=3, n=80):
    """P (full symmetric, CSC) and the cone-permuted A on CONES' rows, with
    more than 96 diagonal offsets in K (the segment-sum matvec)."""
    rng = np.random.default_rng(seed)
    P = sp.random(n, n, density=0.05, random_state=seed)
    P = P + P.T
    # diagonally dominant, so K is quasidefinite
    P = (P + sp.diags(abs(P).sum(axis=1).A1 + rng.uniform(1.0, 2.0, n))).tocsc()
    A = sp.random(JL.m, n, density=0.1, random_state=seed + 1).tocsr()[JL.perm].tocoo()
    return P.tocoo(), A


def _both(layout_pair, P, A, **kw):
    """Each package's SparseKKT, device data and COOMat of P and A."""
    (jl, tl) = layout_pair
    args = (P.shape[0], P.row.astype(np.int64), P.col.astype(np.int64),
            A.row.astype(np.int64), A.col.astype(np.int64))
    jctx, tctx = jsparse.build(jl, *args, **kw), tsparse.build(tl, *args, **kw)
    jdata = jctx.device_data(jnp.float64)
    tdata = tctx.device_data(torch.float64, "cpu")
    jP, jA = JCOO.from_scipy(P, np.float64, dia=True), JCOO.from_scipy(A, np.float64, dia=True)
    tP = TCOO.from_scipy(P, torch.float64, "cpu", dia=True)
    tA = TCOO.from_scipy(A, torch.float64, "cpu", dia=True)
    return (jctx, jdata, jP, jA), (tctx, tdata, tP, tA)


def _dense_K(ctx, Kvals):
    rows, cols = ctx.np_arrays["kkt:K_rows"], ctx.np_arrays["kkt:K_cols"]
    K = np.zeros((ctx.N, ctx.N))
    K[rows, cols] = np.asarray(Kvals)
    return K + np.tril(K, -1).T


@pytest.mark.parametrize("static_reg", [True, False])
def test_assemble_and_matvec(static_reg):
    P, A = _problem()
    (jctx, jdata, jP, jA), (tctx, tdata, tP, tA) = _both((JL, TL), P, A)
    assert tctx.soc_expanded == (False, True) and tctx.genpow_expanded
    assert not tctx.dia_offsets  # a scattered pattern: the segment matvec
    js = _jax_state(4)
    ts = _torch_state(js)
    forms = (tctx.soc_expanded, tctx.genpow_expanded)
    jhs, jex = jops.hs_lower_vals(JL, js, jnp.float64, *forms), \
        jops.expansion_vals(JL, js, jnp.float64, *forms)
    ths = tops.hs_lower_vals(TL, ts, torch.float64, "cpu", (), *forms)
    tex = tops.expansion_vals(TL, ts, torch.float64, "cpu", (), *forms)
    settings = ct.DefaultSettings(static_regularization_enable=static_reg)
    jK, jKreg = jsparse.assemble(jctx, jdata, jP, jA, jhs, jex, settings)
    tK, tKreg = tsparse.assemble(tctx, tdata, tP, tA, ths, tex, tp.port_settings(settings))
    _close(tK, jK, rel=1e-14)
    _close(tKreg, jKreg, rel=1e-14)
    K = _dense_K(tctx, tK.numpy())
    mv = tsparse.make_matvec(tctx, tdata, tK)
    rng = np.random.default_rng(5)
    for v in (rng.normal(size=tctx.N), rng.normal(size=(tctx.N, 2))):
        _close(mv(torch.as_tensor(v)), K @ v, rel=1e-13)
        _close(mv(torch.as_tensor(v)), jsparse.make_matvec(jctx, jdata, jK)(jnp.asarray(v)),
               rel=1e-13)
    # factor and solve through the assembled values
    (factors, ok) = tsparse.factor(tctx, tdata, tKreg, tp.port_settings(settings))
    assert bool(ok)
    rhs = rng.normal(size=tctx.N)
    Kreg = _dense_K(tctx, tKreg.numpy())
    _close(tsparse.solve(tctx, tdata, factors, torch.as_tensor(rhs)), np.linalg.solve(Kreg, rhs),
           rel=1e-10)


def _banded_nn(n=60, seed=6):
    """A zero/NN layout with DIA-compact P and A: the fused assembly and
    the recipe matvec."""
    rng = np.random.default_rng(seed)
    P = sp.diags([rng.uniform(1.0, 2.0, n), 0.1 * np.ones(n - 1), 0.1 * np.ones(n - 1),
                  0.05 * np.ones(n - 7), 0.05 * np.ones(n - 7)], [0, 1, -1, 7, -7]).tocoo()
    A = sp.vstack([sp.eye(n, format="csr")[:5] * 2.0, sp.eye(n), -sp.eye(n)]).tocoo()
    cones = [ct.ZeroConeT(5), ct.NonnegativeConeT(2 * n)]
    jl = JaxLayout(ct.cones.api.collapse_cones(cones))
    tl = TorchLayout(tp.port_cones(jl.cones))
    return P, A, jl, tl


def test_fused_factor_and_recipe_matvec():
    P, A, jl, tl = _banded_nn()
    (jctx, jdata, jP, jA), (tctx, tdata, tP, tA) = _both((jl, tl), P, A)
    assert tctx.dia_recipe and tctx.dia_recipe == jctx.dia_recipe
    tP, tA = tP.predia(), tA.predia()
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, tl.n_nn))
    state = {"nn_w": w, "nn_lam": w}
    hs = tops.hs_lower_vals(tl, state, torch.float64, "cpu")
    ex = tops.expansion_vals(tl, state, torch.float64, "cpu")
    K, Kreg = tsparse.assemble(tctx, tdata, tP, tA, hs, ex, TSETTINGS)
    f1, ok1 = tsparse.factor(tctx, tdata, Kreg, TSETTINGS)
    f2, ok2 = tsparse.factor_fused(tctx, tdata, tP, tA, hs, ex, TSETTINGS)
    assert bool(ok1) and bool(ok2)
    assert torch.equal(f1["dvec"], f2["dvec"])
    for l1, l2 in zip(f1["levels"], f2["levels"]):
        for (a1, d1, _), (a2, d2, _) in zip(l1, l2):
            assert torch.equal(a1, a2) and torch.equal(d1, d2)
    # the recipe matvec (DIA lanes from P.kd, A.kd, Hs) and the DIA one
    # (lanes scattered from K) against the dense K
    dense = _dense_K(tctx, K.numpy())
    for mv in (tsparse.make_matvec_sources(tctx, tP, tA, hs), tsparse.make_matvec(tctx, tdata, K)):
        for v in (rng.normal(size=tctx.N), rng.normal(size=(tctx.N, 2))):
            _close(mv(torch.as_tensor(v)), dense @ v, rel=1e-13)
    # the JAX package's fused factor on the same values
    jw = jnp.asarray(w.numpy())
    jf, _ = jsparse.factor_fused(jctx, jdata, jP.predia(), jA.predia(),
                                 jops.hs_lower_vals(jl, {"nn_w": jw, "nn_lam": jw}, jnp.float64),
                                 jnp.zeros(0), SETTINGS)
    _close(f2["dvec"], jf["dvec"])


@pytest.mark.parametrize("name", ["banded_nn", "mixed"])
def test_equilibrate_sparse(name):
    if name == "banded_nn":
        P, A, jl, tl = _banded_nn()
    else:
        (P, A), jl, tl = _problem(), JL, TL
    rng = np.random.default_rng(8)
    q, b = rng.normal(size=P.shape[0]), rng.normal(size=A.shape[0])
    jout = jeq.equilibrate_sparse(jl, SETTINGS, JCOO.from_scipy(P, np.float64),
                                  jnp.asarray(q), JCOO.from_scipy(A, np.float64), jnp.asarray(b))
    tout = teq.equilibrate_sparse(tl, TSETTINGS, TCOO.from_scipy(P, torch.float64, "cpu"),
                                  torch.as_tensor(q), TCOO.from_scipy(A, torch.float64, "cpu"),
                                  torch.as_tensor(b))
    for j, t in zip(jout, tout):
        if isinstance(t, TCOO):
            j, t = j.data, t.data
        _close(t, j, rel=1e-14)


def test_coo_products():
    """COOMat products, plain and transposed, on the DIA and the segment
    path, against scipy: 1e-14 relative."""
    rng = np.random.default_rng(9)
    banded = sp.diags([rng.normal(size=50), rng.normal(size=49), rng.normal(size=45)],
                      [0, 1, -5], shape=(50, 40))
    scattered = sp.random(60, 40, density=0.2, random_state=10)
    # one dense row: its sum runs in chunks
    scattered = sp.vstack([scattered, sp.csr_matrix(rng.normal(size=(1, 40)))])
    for M, dia in ((banded, True), (scattered, False)):
        C = TCOO.from_scipy(M, torch.float64, "cpu", dia=True).predia()
        assert (C.kd is not None) == dia
        x, y = rng.normal(size=M.shape[1]), rng.normal(size=M.shape[0])
        _close(C @ torch.as_tensor(x), M @ x, rel=1e-14)
        _close(C.T @ torch.as_tensor(y), M.T @ y, rel=1e-14)


def _lanes(data, B=3, seed=12):
    """B value sets on one pattern: ``data`` scaled entry by entry."""
    rng = np.random.default_rng(seed)
    return np.stack([data * rng.uniform(0.5, 1.5, data.size) for _ in range(B)])


@pytest.mark.parametrize("dia", [True, False], ids=["dia", "segment"])
def test_coo_products_per_lane(dia):
    """A batch of COO matrices of one pattern (values [B, nnz]): each lane's
    product, plain and transposed, equal to that lane's own matrix's, bit
    for bit (the same sums in the same order)."""
    rng = np.random.default_rng(13)
    if dia:
        M = sp.diags([rng.normal(size=50), rng.normal(size=49), rng.normal(size=45)],
                     [0, 1, -5], shape=(50, 40)).tocoo()
    else:
        M = sp.vstack([sp.random(60, 40, density=0.2, random_state=14),
                       sp.csr_matrix(rng.normal(size=(1, 40)))]).tocoo()
    vals = _lanes(M.data)
    C = TCOO.from_coo(vals, M.row, M.col, M.shape, torch.float64, "cpu", dia=True).predia()
    assert (C.kd is not None) == dia and C.nnz == M.nnz
    x = torch.as_tensor(rng.normal(size=(3, M.shape[1])))
    y = torch.as_tensor(rng.normal(size=(3, M.shape[0])))
    Cx, Cty = C @ x, C.T @ y
    for i in range(3):
        Ci = TCOO.from_coo(vals[i], M.row, M.col, M.shape, torch.float64, "cpu", dia=True).predia()
        assert torch.equal(Cx[i], Ci @ x[i]) and torch.equal(Cty[i], Ci.T @ y[i])
    with pytest.raises(ValueError, match="batch shape"):
        C @ x[0]


@pytest.mark.parametrize("name", ["banded_nn", "mixed"])
def test_equilibrate_sparse_per_lane(name):
    """equilibrate_sparse of a batch equals each lane's own, bit for bit:
    the norms, the mean column norm of P and the cost scale are per lane
    (lane 1's q scaled by 1e4 moves its cost scale, and only its)."""
    if name == "banded_nn":
        P, A, _, tl = _banded_nn()
    else:
        (P, A), tl = _problem(), TL
    rng = np.random.default_rng(15)
    Pv, Av = _lanes(P.data), _lanes(A.data, seed=16)
    q, b = rng.normal(size=(3, P.shape[0])), rng.normal(size=(3, A.shape[0]))
    q[1] *= 1e4
    coo = lambda M, v: TCOO.from_coo(v, M.row, M.col, M.shape, torch.float64, "cpu")
    out = teq.equilibrate_sparse(tl, TSETTINGS, coo(P, Pv), torch.as_tensor(q), coo(A, Av),
                                 torch.as_tensor(b))
    assert out[-1].shape == (3,) and len(set(out[-1].tolist())) == 3
    for i in range(3):
        one = teq.equilibrate_sparse(tl, TSETTINGS, coo(P, Pv[i]), torch.as_tensor(q[i]),
                                     coo(A, Av[i]), torch.as_tensor(b[i]))
        for got, want in zip(out, one):
            if isinstance(got, TCOO):
                got, want = got.data, want.data
            assert torch.equal(got[i], want)


def test_assembly_per_lane():
    """assemble (the Kvals route, SOC/exp/pow/genpow/PSD values) with its
    matvec, and factor_fused with the recipe matvec (the zero/NN route): a
    batch's values and products equal each lane's own, bit for bit, with
    the static regularization's ε per lane (lane 2's P scaled by 1e3)."""
    rng = np.random.default_rng(17)
    for P, A, jl, tl in ((*_problem(), JL, TL), _banded_nn()):
        (_, _, _, _), (tctx, tdata, _, _) = _both((jl, tl), P, A)
        Pv, Av = _lanes(P.data), _lanes(A.data, seed=18)
        Pv[2] *= 1e3
        coo = lambda M, v: TCOO.from_coo(v, M.row, M.col, M.shape, torch.float64, "cpu",
                                         dia=True).predia()
        tPb, tAb = coo(P, Pv), coo(A, Av)
        forms = (tctx.soc_expanded, tctx.genpow_expanded)
        if tl is TL:
            states = [_torch_state(_jax_state(s)) for s in (4, 5, 6)]
            state = {k: torch.stack([st[k] for st in states]) for k in states[0]}
        else:
            w = torch.as_tensor(rng.uniform(0.5, 2.0, (3, tl.n_nn)))
            states = [{"nn_w": w[i], "nn_lam": w[i]} for i in range(3)]
            state = {"nn_w": w, "nn_lam": w}
        hs = tops.hs_lower_vals(tl, state, torch.float64, "cpu", (3,), *forms)
        ex = tops.expansion_vals(tl, state, torch.float64, "cpu", (3,), *forms)
        v = torch.as_tensor(rng.normal(size=(3, tctx.N, 2)))
        K, Kreg = tsparse.assemble(tctx, tdata, tPb, tAb, hs, ex, TSETTINGS)
        Kv = tsparse.make_matvec(tctx, tdata, K)(v)
        if tctx.dia_recipe:
            fused, ok = tsparse.factor_fused(tctx, tdata, tPb, tAb, hs, ex, TSETTINGS)
            assert ok.shape == (3,)
            Rv = tsparse.make_matvec_sources(tctx, tPb, tAb, hs)(v)
        for i in range(3):
            Pi, Ai = coo(P, Pv[i]), coo(A, Av[i])
            hi = tops.hs_lower_vals(tl, states[i], torch.float64, "cpu", (), *forms)
            ei = tops.expansion_vals(tl, states[i], torch.float64, "cpu", (), *forms)
            Ki, Kregi = tsparse.assemble(tctx, tdata, Pi, Ai, hi, ei, TSETTINGS)
            assert torch.equal(K[i], Ki) and torch.equal(Kreg[i], Kregi)
            assert torch.equal(Kv[i], tsparse.make_matvec(tctx, tdata, Ki)(v[i]))
            if tctx.dia_recipe:
                fi, _ = tsparse.factor_fused(tctx, tdata, Pi, Ai, hi, ei, TSETTINGS)
                assert torch.equal(fused["dvec"][i], fi["dvec"])
                assert torch.equal(Rv[i], tsparse.make_matvec_sources(tctx, Pi, Ai, hi)(v[i]))
        # the regularization's ε follows each lane's own diagonal
        eps = (Kreg - K)[:, tdata["kkt:map_diag"]].abs().amax(dim=1)
        assert eps[2] > eps[0] and eps[2] > eps[1]

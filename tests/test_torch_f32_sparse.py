"""The compensated f32 products of clarabel_tpu_torch's sparse path against
the JAX package's, on the CPU, on inputs made from a numpy seed:

- ``kkt.compensated.seg_sum_df``: each segment's hi + lo within
  2⁻³³·max|p| of the exact sum of p + e (``math.fsum``), and within
  2⁻⁴⁰·(segment length)·max|p| of the JAX package's (the two limb streams of
  11 bits sum exactly in either package; the third limb and the low parts
  sum in another order), on sorted segments of length 1, 2, 5, 200 and
  4133 (≥ 2¹², so the fixed-order sums run in chunks), an empty one and one
  of zeros;
- ``kkt.sparse.sym_matvec_df`` and the two ``.df`` closures of
  ``make_matvec`` (the DIA one, also under ``make_matvec_sources``, and the
  segment one) on ``[N]``, ``[N, 2]`` and a batch's ``[B, N, 2]``, with and
  without ``v_lo``: each row's hi + lo within the same two bounds of the
  exact product and of the JAX package's, with the row's entries as its
  segment;
- ``kkt.dense.solve_refined`` on the multifrontal factors: at f32 with a
  ``.df`` matvec it refines against the compensated residual and returns
  the lo stream (the JAX package's ``compensate_sparse`` branch: tightened
  tolerances, TwoSummed corrections), down to a residual the plain f32
  refinement does not reach;
- the f32 routes alone (constructions, no solve): "auto" on the JAX bench's
  banded QP at n = 1000 (KKT N = 3000, the size gate's edge) and
  "multifrontal" on the JAX package's f32 expansion test problem at
  d = 300 (its SOC on the rank-2 expansion at f32, above
  ``SOC_NO_EXPANSION_MAX_SIZE_F32``): the linear solver's name, dimension,
  nnz(L), the cost model and the SOC expansions equal the JAX package's.

Whole f32 solves on the sparse path are in ``test_torch_f32_sparse_solve.py``
and ``test_torch_f32_sparse_routes.py``; that file's dual max-cut route
("auto" decomposes it, the cost model's veto sends it back to the dense
path, f32 "lu" takes the Jacobi LU above ``DF_LU_MAX_DIM``) is held here,
through ``_torch_parity.check_f32_route``: the JAX package's f32 compile of
it takes over a minute, more than a file of one or two tests may take
beside tests/test_df_lu.py under pytest-xdist's loadfile scheduling.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
import chip_smoke
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.kkt import compensated as jdfc
from clarabel_tpu.kkt import sparse as jsparse
from clarabel_tpu_torch.algebra.coo import COOMat as TCOO
from clarabel_tpu_torch.algebra.coo import levels_to, segment_levels
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import compensated as tdfc
from clarabel_tpu_torch.kkt import dense as tdense
from clarabel_tpu_torch.kkt import sparse as tsparse

#: against the exact sum, per segment, of its largest |p|
EXACT = 2.0**-33
#: against the JAX package's, per segment entry, of the largest |p|
JAX = 2.0**-40


def _products(a, b):
    """The exact products a·b of f32 arrays as TwoProd's (p, e) pairs."""
    p, e = tdfc._two_prod(torch.as_tensor(a.astype(np.float32)),
                          torch.as_tensor(b.astype(np.float32)))
    return p.numpy(), e.numpy()


def _check_segments(hi, lo, jhi, jlo, terms):
    """Each segment's hi + lo against the exact sum of its terms and the
    JAX package's hi + lo.  ``terms``: per segment, (p, e) arrays."""
    got = hi.double().numpy() + lo.double().numpy()
    ref = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    for i, (p, e) in enumerate(terms):
        scale = float(np.max(np.abs(p), initial=0.0))
        exact = math.fsum(np.concatenate([p, e]).astype(np.float64))
        assert abs(got[i] - exact) <= EXACT * scale, (i, got[i], exact)
        assert abs(got[i] - ref[i]) <= JAX * max(len(p), 1) * scale, (i, got[i], ref[i])


def test_seg_sum_df():
    rng = np.random.default_rng(0)
    lengths = [1, 2, 5, 0, 3, 200, 4133, 1]
    ids = np.repeat(np.arange(len(lengths)), lengths)
    # long cancelling sums over eight decades, and a segment of zeros
    a = rng.normal(size=ids.size) * 10.0 ** rng.uniform(-4, 4, ids.size)
    a[ids == 4] = 0.0
    p, e = _products(a, rng.normal(size=ids.size))
    levels = levels_to(segment_levels(ids, len(lengths)), "cpu")
    assert len(levels) > 1  # the 4133 entries sum in chunks first
    hi, lo = tdfc.seg_sum_df(torch.as_tensor(p), torch.as_tensor(e), torch.as_tensor(ids), levels)
    jhi, jlo = jdfc.seg_sum_df(jnp.asarray(p), jnp.asarray(e), jnp.asarray(ids), len(lengths))
    assert hi.dtype == lo.dtype == torch.float32
    _check_segments(hi, lo, jhi, jlo, [(p[ids == s], e[ids == s]) for s in range(len(lengths))])
    assert float(hi[3]) == float(lo[3]) == float(hi[4]) == float(lo[4]) == 0.0
    # along another dimension, two columns at once: each is its own sum
    P2 = torch.as_tensor(np.stack([p, -2.0 * p], axis=1))
    E2 = torch.as_tensor(np.stack([e, -2.0 * e], axis=1))
    h2, l2 = tdfc.seg_sum_df(P2, E2, torch.as_tensor(ids), levels, dim=0)
    assert torch.equal(h2[:, 0], hi) and torch.equal(l2[:, 0], lo)
    assert torch.equal(h2[:, 1], -2.0 * hi) and torch.equal(l2[:, 1], -2.0 * lo)


def _kkt_pattern(dia, seed=1):
    """A quasidefinite K's pattern through both packages' ``build``: a
    banded QP with box rows (DIA offsets, a fused recipe) or a scattered P
    with an expanded SOC (the segment path)."""
    rng = np.random.default_rng(seed)
    n = 40 if dia else 120
    if dia:
        P = sp.diags([rng.uniform(1, 2, n), 0.1 * np.ones(n - 1), 0.1 * np.ones(n - 1)],
                     [0, 1, -1]).tocoo()
        A = sp.vstack([sp.eye(n), -sp.eye(n)]).tocoo()
        cones = [ct.NonnegativeConeT(2 * n)]
    else:
        P = sp.random(n, n, density=0.05, random_state=seed)
        P = (P + P.T + sp.eye(n) * 4.0).tocoo()
        A = sp.vstack([sp.random(3, n, density=0.5, random_state=seed + 1),
                       -sp.eye(n)]).tocoo()
        cones = [ct.ZeroConeT(3), ct.SecondOrderConeT(n)]
    jl = JaxLayout(ct.cones.api.collapse_cones(cones))
    tl = TorchLayout(tp.port_cones(jl.cones))
    args = (n, P.row.astype(np.int64), P.col.astype(np.int64), A.row.astype(np.int64),
            A.col.astype(np.int64))
    jctx, tctx = jsparse.build(jl, *args), tsparse.build(tl, *args)
    assert bool(tctx.dia_offsets) == dia and tctx.dia_offsets == jctx.dia_offsets
    assert dia or tctx.soc_expanded == (True,)
    return (jctx, jctx.device_data(jnp.float32)), (tctx, tctx.device_data(torch.float32, "cpu"))


def _row_terms(ctx, Kvals, v, v_lo):
    """Per row of the full symmetric K, the exact products' (p, e) in f64:
    p = K_ij·v_j rounded to f32, e its exact remainder plus K_ij·v_lo_j."""
    rows, cols = ctx.np_arrays["kkt:K_rows"], ctx.np_arrays["kkt:K_cols"]
    strict = rows != cols
    r = np.concatenate([rows, cols[strict]])
    c = np.concatenate([cols, rows[strict]])
    k = np.concatenate([Kvals, Kvals[strict]]).astype(np.float64)
    exact = k * v[c].astype(np.float64)
    p = exact.astype(np.float32).astype(np.float64)
    e = exact - p
    if v_lo is not None:
        e = e + k * v_lo[c].astype(np.float64)
    return [(p[r == i], e[r == i]) for i in range(ctx.N)]


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_lo", [False, True], ids=["v", "v+v_lo"])
@pytest.mark.parametrize("shape", ["N", "N2", "BN2"])
@pytest.mark.parametrize("path", ["dia", "segment"])
def test_compensated_sparse_products(path, shape, with_lo):
    (jctx, jdata), (tctx, tdata) = _kkt_pattern(dia=path == "dia")
    rng = np.random.default_rng(2)
    B = 3 if shape == "BN2" else 1
    # K's values over six decades: rows whose products cancel
    K = _f32(rng, B, tctx.nnz) * (10.0 ** rng.uniform(-3, 3, (B, tctx.nnz))).astype(np.float32)
    vshape = {"N": (B, tctx.N), "N2": (B, tctx.N, 2), "BN2": (B, tctx.N, 2)}[shape]
    v = _f32(rng, *vshape)
    v_lo = (_f32(rng, *vshape) * 2.0**-24).astype(np.float32) if with_lo else None
    T = lambda a: None if a is None else torch.as_tensor(a)
    if shape == "BN2":
        Kt, vt, vlt = T(K), T(v), T(v_lo)
    else:
        Kt, vt, vlt = T(K[0]), T(v[0]), T(None if v_lo is None else v_lo[0])
    hi, lo = tsparse.make_matvec(tctx, tdata, Kt).df(vt, vlt)
    if path == "segment":  # the closure is sym_matvec_df
        for a, b in zip((hi, lo), tsparse.sym_matvec_df(tctx, tdata, Kt, vt, vlt)):
            assert torch.equal(a, b)
    assert hi.shape == lo.shape == vt.shape and hi.dtype == torch.float32
    hi, lo = hi.reshape(vshape), lo.reshape(vshape)
    for b in range(B):
        jmv = jsparse.make_matvec(jctx, jdata, jnp.asarray(K[b]))
        for col in range(v.shape[-1] if v.ndim == 3 else 1):
            pick = (lambda a: a[b, :, col]) if v.ndim == 3 else (lambda a: a[b])
            vl = None if v_lo is None else pick(v_lo)
            jhi, jlo = jmv.df(jnp.asarray(pick(v)), None if vl is None else jnp.asarray(vl))
            _check_segments(pick(hi), pick(lo), jhi, jlo, _row_terms(tctx, K[b], pick(v), vl))


def test_recipe_matvec_df():
    """``make_matvec_sources``' lanes from P.kd, A.kd and the Hs diagonal
    inherit the DIA ``.df``: equal to the scattered DIA matvec's, bit for
    bit, on the same K."""
    (_, _), (tctx, tdata) = _kkt_pattern(dia=True)
    assert tctx.dia_recipe
    rng = np.random.default_rng(3)
    n = tctx.n
    P = sp.diags([rng.uniform(1, 2, n), 0.1 * np.ones(n - 1), 0.1 * np.ones(n - 1)],
                 [0, 1, -1]).tocoo()
    A = sp.vstack([sp.eye(n), -sp.eye(n)]).tocoo()
    tP = TCOO.from_scipy(P, torch.float32, "cpu", dia=True).predia()
    tA = TCOO.from_scipy(A, torch.float32, "cpu", dia=True).predia()
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 2 * n).astype(np.float32))
    hs = w * w
    K, _ = tsparse.assemble(tctx, tdata, tP, tA, hs, torch.zeros(0),
                            tp.port_settings(ct.DefaultSettings(verbose=False)))
    v = torch.as_tensor(_f32(rng, tctx.N, 2))
    v_lo = torch.as_tensor(_f32(rng, tctx.N, 2) * 2.0**-24)
    for a, b in zip(tsparse.make_matvec_sources(tctx, tP, tA, hs).df(v, v_lo),
                    tsparse.make_matvec(tctx, tdata, K).df(v, v_lo)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch"])
def test_solve_refined_compensated_sparse(batch):
    """At f32, a multifrontal solve refined against a matvec with ``.df``
    returns (x, x_lo) whose residual, evaluated in f64 on x + x_lo, is far
    below what the plain f32 refinement (the same matvec without ``.df``)
    reaches."""
    (_, _), (tctx, tdata) = _kkt_pattern(dia=False)
    rng = np.random.default_rng(4)
    B = 2 if batch else None
    bshape = (B,) if batch else ()
    settings = tp.port_settings(ct.DefaultSettings.for_float32(verbose=False))
    # a quasidefinite K: each pivot of its expected sign
    rows, cols = tctx.np_arrays["kkt:K_rows"], tctx.np_arrays["kkt:K_cols"]
    K = rng.normal(size=bshape + (tctx.nnz,))
    diag = rows == cols
    absrow = np.zeros(bshape + (tctx.N,))
    np.add.at(absrow, (..., rows), np.abs(K))
    np.add.at(absrow, (..., cols), np.abs(K))
    K[..., diag] = tctx.np_arrays["kkt:dsigns"][rows[diag]] * absrow[..., rows[diag]]
    K = torch.as_tensor(K.astype(np.float32))
    factors, ok = tsparse.factor(tctx, tdata, K, settings)
    assert bool(ok.all())
    mv = tsparse.make_matvec(tctx, tdata, K)
    rhs = torch.as_tensor(_f32(rng, *(bshape + (tctx.N, 2 if batch else 1))))
    if not batch:
        rhs = rhs[:, 0]
    F = ("mf", (tctx, tdata, factors))
    (x, x_lo), ok = tdense.solve_refined(F, mv, rhs, settings, want_lo=True)
    assert bool(ok.all()) and x_lo is not None and x_lo.shape == x.shape
    (xp, xp_lo), _ = tdense.solve_refined(F, lambda v: mv(v), rhs, settings, want_lo=True)
    assert xp_lo is None

    def resid(xx):
        Kd = np.zeros(bshape + (tctx.N, tctx.N))
        Kd[..., rows, cols] = K.double().numpy()
        Kd = Kd + np.swapaxes(np.tril(Kd, -1), -1, -2)
        r = rhs.double().numpy()
        vec = r.ndim == Kd.ndim - 1
        got = Kd @ (xx[..., None] if vec else xx)
        return np.abs((got[..., 0] if vec else got) - r).max()

    compensated = resid(x.double().numpy() + x_lo.double().numpy())
    plain = resid(xp.double().numpy())
    assert compensated <= 1e-3 * plain, (compensated, plain)


#: problems whose f32 route (a construction) is held to the JAX package's:
#: name -> (the problem, method)
ROUTE_FIELDS = {
    "banded_qp_n1000": (lambda: chip_smoke.banded_qp(1000, 2)[:4]
                        + ([ct.NonnegativeConeT(2000)],), "auto"),
    "expanded_soc_d300": (lambda: chip_smoke.expanded_soc(300)[:4]
                          + ([ct.ZeroConeT(1), ct.SecondOrderConeT(300)],), "multifrontal"),
}


@pytest.mark.parametrize("name", ROUTE_FIELDS)
def test_f32_sparse_route_fields_match_reference(name):
    make, method = ROUTE_FIELDS[name]
    P, q, A, b, cones = make()
    ref = ct.DefaultSolver(P, q, A, b, cones, ct.DefaultSettings.for_float32(
        verbose=False, direct_solve_method=method), dtype="float32",
        device=jax.devices("cpu")[0])
    got = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tt.DefaultSettings.for_float32(
        verbose=False, direct_solve_method=method), dtype="float32", device="cpu")
    assert got._sparse and ref._sparse
    for field in ("name", "dim", "nnzL", "nnzA"):
        assert getattr(got.info.linear_solver, field) == getattr(ref.info.linear_solver, field)
    rcm, gcm = ref.info.linear_solver.cost_model, got.info.linear_solver.cost_model
    assert {k: v for k, v in rcm.items() if k != "provenance"} == \
        {k: v for k, v in gcm.items() if k != "provenance"}
    assert got._skkt.soc_expanded == ref._skkt.soc_expanded
    assert got._skkt.soc_expanded == ((True,) if name == "expanded_soc_d300" else ())


@pytest.mark.parametrize("name", ["veto_dense"])
def test_f32_auto_route_matches_reference(name):
    tp.check_f32_route(name)

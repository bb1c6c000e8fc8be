"""The generators' shapes, cones and seeds."""

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import harness
from benchmark.generators import maxcut, osqp_portfolio
from benchmark.reference.cones import PSDTriangleConeT

PORTFOLIO = dict(factors=2, assets_per_factor=6, factor_density=0.5, gamma=1.0, data_seed=3)


def test_portfolio_batch_shapes_and_cones():
    inst = osqp_portfolio.make(PORTFOLIO, 5, np.random.default_rng(0))
    assert inst["P"].shape == (5, 12, 12) and inst["A"].shape == (5, 13, 12)
    assert inst["q"].shape == (5, 12) and inst["b"].shape == (5, 13)
    assert inst["cones"] == [["ZeroConeT", [1]], ["NonnegativeConeT", [12]]]
    # one covariance for the batch, positive semidefinite; each lane its own returns
    assert np.array_equal(inst["P"][0], inst["P"][4])
    assert np.linalg.eigvalsh(inst["P"][0]).min() > -1e-12
    assert not np.array_equal(inst["q"][0], inst["q"][1])
    assert np.array_equal(inst["A"][0][0], np.ones(12)) and np.array_equal(inst["b"][0][:1], [1.0])
    with pytest.raises(ValueError):
        osqp_portfolio.make(PORTFOLIO, None, np.random.default_rng(0))


def test_portfolio_draws_are_the_osqp_class():
    n, k = 600, 4
    cfg = dict(PORTFOLIO, factors=k, assets_per_factor=150)
    F, D, mu = osqp_portfolio.draws(cfg, 50, np.random.default_rng(8))
    assert F.shape == (n, k) and D.shape == (n,) and mu.shape == (50, n)
    # half of F nonzero, N(0, 1); D on [0, √k); μ N(0, 1)
    assert np.count_nonzero(F) == n * k // 2
    assert abs(F[F != 0].std() - 1) < 0.1 and abs(mu.std() - 1) < 0.02
    assert D.min() >= 0 and D.max() < np.sqrt(k) and abs(D.mean() - np.sqrt(k) / 2) < 0.1


def test_portfolio_instances_relabel_one_set_of_draws():
    a = osqp_portfolio.make(PORTFOLIO, 5, np.random.default_rng(0))
    b = osqp_portfolio.make(PORTFOLIO, 5, np.random.default_rng(1))
    assert not np.array_equal(a["q"], b["q"])
    # the same covariance and the same returns, relabelled
    assert np.allclose(np.sort(np.linalg.eigvalsh(a["P"][0])), np.sort(np.linalg.eigvalsh(b["P"][0])))
    assert np.array_equal(np.sort(a["q"].ravel()), np.sort(b["q"].ravel()))
    F, D, _ = osqp_portfolio.draws(PORTFOLIO, 5, np.random.default_rng(PORTFOLIO["data_seed"]))
    assert np.isclose(np.trace(a["P"][0]), 2 * (D.sum() + np.sum(F**2)))


def test_maxcut_shapes_and_cones():
    cfg = dict(vertices=7, edges=9, graph_seed=4)
    inst = maxcut.make(cfg, None, np.random.default_rng(1))
    tri = 7 * 8 // 2
    assert sp.issparse(inst["A"]) and inst["A"].shape == (tri + 7, tri)
    assert inst["P"].shape == (tri, tri) and inst["P"].nnz == 0
    assert inst["q"].shape == (tri,) and inst["b"].shape == (tri + 7,)
    assert inst["cones"] == [["PSDTriangleConeT", [7]], ["ZeroConeT", [7]]]
    # q is svec(-L/4) of a graph of 9 unit edges: -1/4 per degree on the diagonal
    X = PSDTriangleConeT.smat(inst["q"][None], 7)[0]
    assert np.isclose(-4 * np.trace(X), 2 * 9)
    assert np.allclose(X.sum(axis=1), 0.0)
    # the zero rows pick the diagonal of X
    A_eq = inst["A"].toarray()[tri:]
    assert np.array_equal(A_eq @ maxcut.svec(np.eye(7)), np.ones(7))
    # another instance relabels the same graph: the same degrees, other data
    other = maxcut.make(cfg, None, np.random.default_rng(2))
    Y = PSDTriangleConeT.smat(other["q"][None], 7)[0]
    assert np.array_equal(np.sort(np.diag(X)), np.sort(np.diag(Y)))
    assert np.allclose(np.sort(np.linalg.eigvalsh(X)), np.sort(np.linalg.eigvalsh(Y)))
    assert not np.array_equal(inst["q"], other["q"])
    with pytest.raises(ValueError):
        maxcut.make(cfg, 3, np.random.default_rng(1))


def test_svec_and_smat_are_inverse():
    X = np.random.default_rng(2).normal(size=(3, 5, 5))
    X = X + np.swapaxes(X, 1, 2)
    v = maxcut.svec(X)
    assert np.allclose(PSDTriangleConeT.smat(v, 5), X)
    # svec is an isometry: ‖svec X‖₂ = ‖X‖_F
    assert np.allclose(np.linalg.norm(v, axis=1), np.linalg.norm(X, axis=(1, 2)))


def test_pool_follows_the_seed():
    cell = harness.load_cell("portfolio_b4096_pallas",
                             overrides={"config": {"assets_per_factor": 6, "factors": 2},
                                        "traffic": {"lanes": 3}})
    big = 2**31 + 977
    a, b = harness.make_pool(cell, big), harness.make_pool(cell, big)
    assert len(a) == cell.traffic["pool"]
    assert all(np.array_equal(x["q"], y["q"]) and np.array_equal(x["P"], y["P"])
               for x, y in zip(a, b))
    # the instances of a pool differ, and so do the pools of two seeds
    assert not np.array_equal(a[0]["q"], a[1]["q"])
    assert not np.array_equal(a[0]["q"], harness.make_pool(cell, big + 1)[0]["q"])

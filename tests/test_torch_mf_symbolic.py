"""The multifrontal symbolic analysis of clarabel_tpu_torch against the JAX
package's, host-only (NumPy and SciPy, nothing on a device): the port's
``kkt.mf_symbolic.analyze`` and ``kkt.sparse.build`` must give the JAX
package's plans field for field -- levels, buckets, padded sizes, node ids,
offsets, nnzL, flops, every index array -- on random, banded (chain and
nested-dissection orderings), 2-D-grid, SOC-expanded, generalized-power
and PSD patterns.  Exact equality: both run the same integer algorithm.

The JAX package runs its symbolic factorization and amalgamation through
its native C++ engine when that library is built, and its Python versions
otherwise; every pattern here keeps its supernodes under the split width,
where the two give the same plan.  The port runs its own native engine
when it is built (tests/test_torch_native.py holds it to the port's Python
versions and to the JAX package, also where supernodes split).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu.cones.layout import ConeLayout as JaxLayout
from clarabel_tpu.kkt import mf_symbolic as jsym
from clarabel_tpu.kkt import sparse as jsparse
from clarabel_tpu_torch.cones.layout import ConeLayout as TorchLayout
from clarabel_tpu_torch.kkt import mf_symbolic as tsym
from clarabel_tpu_torch.kkt import sparse as tsparse


def assert_plans_equal(ref, got):
    for field in ("N", "nnzL", "flops", "n_supernodes", "W", "total_cells"):
        assert getattr(got, field) == getattr(ref, field), field
    assert sorted(got.arrays) == sorted(ref.arrays)
    for key, v in ref.arrays.items():
        assert np.array_equal(got.arrays[key], v), key
    assert len(got.levels) == len(ref.levels)
    for lref, lgot in zip(ref.levels, got.levels):
        assert len(lgot) == len(lref)
        for bref, bgot in zip(lref, lgot):
            for field in ("c_pad", "u_pad", "k", "node_ids", "key", "w_off", "f_off", "asm"):
                assert getattr(bgot, field) == getattr(bref, field), field


def _random(N=300, density=0.01, seed=1):
    M = sp.random(N, N, density=density, random_state=seed) + sp.eye(N)
    return M + M.T


def _banded(N, offsets=(1, 2, 7)):
    return sp.diags([np.ones(N)] + [np.ones(N - o) for o in offsets], (0,) + offsets)


def _grid(k=30):
    """The 5-point Laplacian of a k x k grid."""
    T = sp.diags([2 * np.ones(k), -np.ones(k - 1), -np.ones(k - 1)], [0, 1, -1])
    return sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))


PATTERNS = {
    "random": _random,
    # minimum degree leaves a chain; "auto" retries with nested dissection
    "banded_chain": lambda: _banded(2000),
    # past the size where "auto" starts with nested dissection
    "banded_nested_dissection": lambda: _banded(5000),
    "grid": _grid,
}


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("ordering", ["auto", "natural"])
def test_analyze_matches_reference(name, ordering):
    M = PATTERNS[name]()
    K_low = sp.tril(M).tocsc()
    rng = np.random.default_rng(3)
    dsigns = np.where(rng.random(M.shape[0]) < 0.5, 1.0, -1.0)
    ref = jsym.analyze(K_low, dsigns, ordering=ordering)
    got = tsym.analyze(K_low, dsigns, ordering=ordering)
    assert_plans_equal(ref, got)


def _qp_banded(n=400):
    P = _banded(n, (1, 7)).tocsc()
    A = sp.vstack([sp.eye(n), -sp.eye(n)]).tocsc()
    return P, A, [ct.NonnegativeConeT(2 * n)]


def _socp_expanded():
    rng = np.random.default_rng(5)
    n = 30
    A = sp.vstack([sp.eye(n), sp.random(12, n, density=0.3, random_state=6),
                   sp.random(3, n, density=0.5, random_state=7),
                   sp.random(8, n, density=0.3, random_state=8)]).tocsc()
    P = sp.diags(rng.uniform(1.0, 2.0, n)).tocsc()
    # SOC(12) and SOC(8) expand (above 4 rows), SOC(3) stays dense
    return P, A, [ct.NonnegativeConeT(n), ct.SecondOrderConeT(12), ct.SecondOrderConeT(3),
                  ct.SecondOrderConeT(8)]


def _nonsym():
    n = 12
    A = sp.vstack([sp.eye(n), sp.random(6, n, density=0.5, random_state=9),
                   sp.random(9, n, density=0.4, random_state=10)]).tocsc()
    return sp.csc_matrix((n, n)), A, [ct.NonnegativeConeT(n), ct.ExponentialConeT(),
                                      ct.PowerConeT(0.3), ct.GenPowerConeT([0.2, 0.3, 0.5], 2),
                                      ct.GenPowerConeT([0.6, 0.4], 2)]


def _psd():
    P, q, A, b, cones = tp.PROBLEMS["sdp_mixed_with_soc"]()
    return sp.csc_matrix(P), sp.csc_matrix(A), cones


LAYOUTS = {"qp_banded": _qp_banded, "socp_expanded": _socp_expanded, "nonsym": _nonsym,
           "psd": _psd}


@pytest.mark.parametrize("name", LAYOUTS)
def test_sparse_build_matches_reference(name):
    P, A, cones = LAYOUTS[name]()
    jl = JaxLayout(ct.cones.api.collapse_cones(cones))
    tl = TorchLayout(tp.port_cones(jl.cones))
    P_full = (sp.triu(P) + sp.triu(P, 1).T).tocoo()
    A_perm = A.tocsr()[jl.perm].tocoo()
    args = (P_full.shape[0], P_full.row.astype(np.int64), P_full.col.astype(np.int64),
            A_perm.row.astype(np.int64), A_perm.col.astype(np.int64))
    ref = jsparse.build(jl, *args, dtype="float64")
    got = tsparse.build(tl, *args, dtype="float64")
    assert_plans_equal(ref.plan, got.plan)
    for field in ("n", "m", "N", "nnz", "soc_expanded", "genpow_expanded", "nonsym",
                  "dia_offsets", "dia_recipe"):
        assert getattr(got, field) == getattr(ref, field), field
    ref_arrays = dict(ref.np_arrays)
    got_arrays = dict(got.np_arrays)
    if "fuse:cells" in ref_arrays:
        # the JAX package scatters sources and regularization in one
        # scatter-add; the port assigns the sources' cells, then adds to
        # the diagonal's
        got_arrays["fuse:cells"] = np.concatenate(
            [got_arrays["fuse:cells"], got_arrays.pop("fuse:diag_cells")])
    assert sorted(got_arrays) == sorted(ref_arrays)
    for key, v in ref_arrays.items():
        assert np.array_equal(got_arrays[key], v), key
    if name == "socp_expanded":
        assert got.soc_expanded == (True, False, True)

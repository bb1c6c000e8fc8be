"""The port's native C++ symbolic engine (``clarabel_tpu_torch/native.py``
over its own ``native/symbolic.cpp``, built with g++) against the port's
Python versions and the JAX package's plans: the mirrors of
tests/test_native.py, multifrontal plans equal field for field whichever
engine built them, and a chordal decomposition equal through either.

The Python versions run with ``native._load`` patched to report no library,
as where no compiler exists.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu import chordal as jchordal
from clarabel_tpu.kkt import mf_symbolic as jsym
from clarabel_tpu_torch import chordal as tchordal, convert, native
from clarabel_tpu_torch.chordal import symbolic as pysym
from clarabel_tpu_torch.cones import api as tapi
from clarabel_tpu_torch.kkt import mf_symbolic as tsym

import test_psd_auto_route
from test_torch_mf_symbolic import PATTERNS, assert_plans_equal


@pytest.fixture(scope="module", autouse=True)
def built():
    """Build the engine once for the module; this machine has g++."""
    assert native.available(), "the native symbolic engine did not build"


def python_only(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)


def random_pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    adj = [set() for _ in range(n)]
    lower = [set() for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < density:
                adj[i].add(j)
                adj[j].add(i)
                lower[i].add(j)
    return adj, lower


# ---------------------------------------------------------------------------
# mirrors of tests/test_native.py


def test_native_minimum_degree_is_valid_permutation(monkeypatch):
    n = 30
    adj, _ = random_pattern(n, 0.2, 0)
    perm = native.minimum_degree(n, adj)
    assert sorted(perm.tolist()) == list(range(n))
    python_only(monkeypatch)
    assert np.array_equal(pysym.minimum_degree_ordering(n, adj), perm)


def test_native_symbolic_matches_python(monkeypatch):
    outs = []
    for seed in range(5):
        n = 25
        _, lower = random_pattern(n, 0.15, seed)
        native_out = native.symbolic_cholesky(n, lower)
        assert native_out is not None
        outs.append((n, lower, native_out))
    python_only(monkeypatch)
    for n, lower, (L_native, parent_native) in outs:
        L_py, parent_py = pysym.symbolic_cholesky(n, lower)
        assert [list(c) for c in L_native] == L_py
        assert np.array_equal(parent_native, parent_py)


def test_symbolic_pattern_is_chordal_superset():
    # the factor pattern must contain the original pattern
    n = 20
    _, lower = random_pattern(n, 0.2, 3)
    L_cols, _ = pysym.symbolic_cholesky(n, lower)
    for j in range(n):
        assert set(lower[j]) <= set(L_cols[j])


@pytest.mark.parametrize("max_cols", [1024, 16], ids=["unsplit", "split"])
def test_native_amalgamate_matches_python(max_cols, monkeypatch):
    """The native amalgamation makes the Python loop's merge decisions:
    the same surviving nodes with the same columns, rows, parents,
    children and levels, also where supernodes wider than ``max_cols``
    split."""
    dense_tail = sp.random(200, 200, density=0.03, random_state=1) + sp.eye(200)
    dense_tail = sp.bmat([[dense_tail, None], [None, sp.csc_matrix(np.ones((40, 40)))]])
    for pattern in (
        sp.diags([np.ones(300), np.ones(299), np.ones(299)], [0, 1, -1]),
        dense_tail,
    ):
        K = sp.csc_matrix(sp.tril(pattern))
        n = K.shape[0]
        strict = sp.tril(K, -1).tocsc()
        args = (n, strict.indptr.astype(np.int64), strict.indices.astype(np.int64))
        parent, L_ptr, L_idx = tsym.symbolic_factor_csc(*args)
        nodes_a, live_a, level_a = tsym._build_schedule(n, parent, L_ptr, L_idx, max_cols, 0.35)
        with monkeypatch.context() as m:
            m.setattr(native, "_load", lambda: None)
            py = tsym.symbolic_factor_csc(*args)
            nodes_b, live_b, level_b = tsym._build_schedule(n, *py, max_cols, 0.35)
        for x, y in zip(py, (parent, L_ptr, L_idx)):
            assert np.array_equal(x, y)
        assert live_a == live_b and level_a == level_b
        for i in live_a:
            a, b = nodes_a[i], nodes_b[i]
            np.testing.assert_array_equal(a.cols, b.cols)
            np.testing.assert_array_equal(a.rows, b.rows)
            assert a.parent == b.parent
            assert sorted(a.children) == sorted(b.children)


def test_flat_schedule_matches_python_pipeline(monkeypatch):
    """analyze() through the native engine must produce the exact plan of
    the Python pipeline (same buckets, index maps, workspace layouts)."""
    rng = np.random.default_rng(3)
    n = 400
    K = sp.tril(
        sp.diags([np.full(n, 4.0), np.ones(n - 1), np.ones(n - 1),
                  0.5 * np.ones(n - 17)], [0, -1, 1, -17])
    ).tocsc()
    dsigns = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)

    plan_native = tsym.analyze(K, dsigns)
    python_only(monkeypatch)
    assert_plans_equal(plan_native, tsym.analyze(K, dsigns))


# ---------------------------------------------------------------------------
# plans and decompositions through either engine


@pytest.mark.parametrize("max_cols", [1024, 24], ids=["unsplit", "split"])
@pytest.mark.parametrize("name", PATTERNS)
def test_plans_equal_through_either_engine(name, max_cols, monkeypatch):
    """On test_torch_mf_symbolic.py's patterns, the port's plan through its
    native engine equals its plan through the Python versions and the JAX
    package's plan (through the JAX package's native engine, whose split
    numbering the port follows), field for field."""
    M = PATTERNS[name]()
    K_low = sp.tril(M).tocsc()
    rng = np.random.default_rng(3)
    dsigns = np.where(rng.random(M.shape[0]) < 0.5, 1.0, -1.0)
    ref = jsym.analyze(K_low, dsigns, max_supernode_cols=max_cols)
    got = tsym.analyze(K_low, dsigns, max_supernode_cols=max_cols)
    assert_plans_equal(ref, got)
    python_only(monkeypatch)
    assert_plans_equal(ref, tsym.analyze(K_low, dsigns, max_supernode_cols=max_cols))


def test_chordal_decomposition_equal_through_either_engine(monkeypatch):
    """The chordal analysis of a banded SDP (n = 12) and its augmented
    problem are bitwise equal through the native ordering and symbolic
    factorization and through the Python versions, and equal the JAX
    package's."""
    P, q, A, b, cones = test_psd_auto_route.banded_sdp(12)
    settings = ct.DefaultSettings(verbose=False)
    jcones = ct.cones.api.collapse_cones(tuple(cones))
    tcones = tapi.collapse_cones(tp.port_cones(cones))
    ts = tp.port_settings(settings)
    A = sp.csr_matrix(A)
    ref = jchordal.try_chordal_info(A, b, jcones, settings)
    jout = ref.decomp_augment(sp.csc_matrix(P), q, A, b, settings)

    outs = []
    for engine in ("native", "python"):
        if engine == "python":
            python_only(monkeypatch)
        info = tchordal.try_chordal_info(A, b, tcones, ts)
        assert [p.sntree.n_cliques for p in info.spatterns] == \
            [p.sntree.n_cliques for p in ref.spatterns]
        for a, r in zip(info.spatterns, ref.spatterns):
            np.testing.assert_array_equal(a.ordering, r.ordering)
        outs.append(info.decomp_augment(sp.csc_matrix(P), q, A, b, ts))
    for tout in outs:
        for got, want in zip(tout[:4], jout[:4]):
            if sp.issparse(want):
                got, want = got.toarray(), want.toarray()
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert convert.cone_specs(tout[4]) == convert.cone_specs(jout[4])

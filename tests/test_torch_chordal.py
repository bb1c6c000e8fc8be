"""The chordal decomposition of clarabel_tpu_torch (``chordal/``, the port's
copy of ``clarabel_tpu/chordal``) against the JAX package's, which is host
NumPy code: the analysis, the augmented problem (``decomp_augment``, from
dense and from scipy-sparse data), the solution reversal with and without
PSD completion (``decomp_reverse``) and the warm-start map
(``decomp_warm_start``) must be bitwise equal, in every combination of
{compact} x {complete_dual} x {merge_method}, on the reference's chordal
problem (tests/test_sdp_chordal.py: PSD(6) beside two power cones) and on a
banded SDP (n = 12; tests/test_psd_auto_route.py's generator).

Each package orders the sparsity graph with its own native C++ engine
where it is built, and with the Python versions of the same algorithm
otherwise (tests/test_torch_native.py holds the port's two to each other).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as tp
import clarabel_tpu as ct
from clarabel_tpu import chordal as jchordal
from clarabel_tpu_torch import chordal as tchordal, convert
from clarabel_tpu_torch.cones import api as tapi

import test_psd_auto_route
import test_sdp_chordal


def _banded():
    P, q, A, b, cones = test_psd_auto_route.banded_sdp(12)
    return P.toarray(), q, A.toarray(), b, cones


PROBLEMS = {"oracle": test_sdp_chordal.sdp_chordal_data, "banded": _banded}


def _both(name, compact, complete_dual, merge_method):
    """(JAX, port) of: settings, collapsed cones, and the problem data."""
    P, q, A, b, cones = PROBLEMS[name]()
    settings = ct.DefaultSettings(
        verbose=False, chordal_decomposition_compact=compact,
        chordal_decomposition_complete_dual=complete_dual,
        chordal_decomposition_merge_method=merge_method)
    jcones = ct.cones.api.collapse_cones(tuple(cones))
    tcones = tapi.collapse_cones(tp.port_cones(cones))
    return (settings, jcones), (tp.port_settings(settings), tcones), (P, q, A, b)


def _equal(got, ref):
    if sp.issparse(ref):
        assert sp.issparse(got)
        got, ref = got.toarray(), ref.toarray()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("merge_method", ["none", "parent_child", "clique_graph"])
@pytest.mark.parametrize("complete_dual", [False, True], ids=["plain_dual", "complete_dual"])
@pytest.mark.parametrize("compact", [False, True], ids=["standard", "compact"])
@pytest.mark.parametrize("name", PROBLEMS)
def test_transforms_match_reference(name, compact, complete_dual, merge_method):
    (js, jcones), (ts, tcones), (P, q, A, b) = _both(name, compact, complete_dual, merge_method)
    for sparse in (False, True):
        Pin, Ain = (sp.csc_matrix(P), sp.csr_matrix(A)) if sparse else (P, A)
        jinfo = jchordal.try_chordal_info(Ain, b, jcones, js)
        tinfo = tchordal.try_chordal_info(Ain, b, tcones, ts)
        # parent-child merging takes the oracle problem's cliques back into
        # one: nothing is decomposed, in either package
        undecomposed = (name, merge_method) == ("oracle", "parent_child")
        assert (tinfo is None) == (jinfo is None) == undecomposed
        if jinfo is None:
            return
        assert [p.sntree.n_cliques for p in tinfo.spatterns] == \
            [p.sntree.n_cliques for p in jinfo.spatterns]
        for a, r in zip(tinfo.spatterns, jinfo.spatterns):
            np.testing.assert_array_equal(a.ordering, r.ordering)
        jout = jinfo.decomp_augment(Pin, q, Ain, b, js)
        tout = tinfo.decomp_augment(Pin, q, Ain, b, ts)
        for got, ref in zip(tout[:4], jout[:4]):
            _equal(got, ref)
        assert convert.cone_specs(tout[4]) == convert.cone_specs(jout[4])

    # the reversal of one point of the decomposed frame, and the warm-start
    # map of one point of the user frame
    rng = np.random.default_rng(7)
    n_new, m_new = jout[2].shape[1], jout[2].shape[0]
    x, z, s = rng.normal(size=n_new), rng.normal(size=m_new), rng.normal(size=m_new)
    for got, ref in zip(tinfo.decomp_reverse(x, z.copy(), s.copy(), ts),
                        jinfo.decomp_reverse(x, z.copy(), s.copy(), js)):
        _equal(got, ref)
    x0, s0, z0 = rng.normal(size=P.shape[0]), rng.normal(size=len(b)), rng.normal(size=len(b))
    for got, ref in zip(tinfo.decomp_warm_start(x0, s0, z0), jinfo.decomp_warm_start(x0, s0, z0)):
        _equal(got, ref)


def test_psd_completion_of_a_decomposed_dual():
    """The completion fills the entries outside the cliques so that the
    dual matrix is PSD, as the JAX package's does: the completed z of a
    clique-wise PSD point, bitwise the JAX package's, has no eigenvalue
    below -1e-12 of its norm."""
    (js, jcones), (ts, tcones), (P, q, A, b) = _both("banded", True, True, "clique_graph")
    jinfo = jchordal.try_chordal_info(A, b, jcones, js)
    tinfo = tchordal.try_chordal_info(A, b, tcones, ts)
    _, _, A_new, _, cones_new = tinfo.decomp_augment(P, q, A, b, ts)
    jinfo.decomp_augment(P, q, A, b, js)
    rng = np.random.default_rng(3)
    z = np.zeros(A_new.shape[0])
    row = 0
    for c in cones_new:  # a positive definite block on each clique
        if c.kind == tapi.PSD:
            M = rng.normal(size=(c.dim, c.dim))
            M = M @ M.T + c.dim * np.eye(c.dim)
            z[row:row + c.nvars] = [M[i, j] * (1.0 if i == j else np.sqrt(2.0))
                                    for j in range(c.dim) for i in range(j + 1)]
        row += c.nvars
    x = np.zeros(A_new.shape[1])
    _, zt, _ = tinfo.decomp_reverse(x, z.copy(), z.copy(), ts)
    _, zj, _ = jinfo.decomp_reverse(x, z.copy(), z.copy(), js)
    np.testing.assert_array_equal(zt, zj)
    n = 12
    Z = np.zeros((n, n))
    k = 0
    for j in range(n):
        for i in range(j + 1):
            Z[i, j] = Z[j, i] = zt[k] if i == j else zt[k] / np.sqrt(2.0)
            k += 1
    e = np.linalg.eigvalsh(Z)
    assert e.min() >= -1e-12 * np.abs(e).max()


def test_no_decomposition_of_a_dense_or_small_cone():
    """None where the JAX package decomposes nothing: decomposition off, no
    PSD cone above 3 x 3, or a dense pattern."""
    s = tp.port_settings(ct.DefaultSettings(verbose=False))
    P, q, A, b, cones = test_sdp_chordal.sdp_chordal_data()
    tcones = tapi.collapse_cones(tp.port_cones(cones))
    off = tp.port_settings(ct.DefaultSettings(verbose=False, chordal_decomposition_enable=False))
    assert tchordal.try_chordal_info(A, b, tcones, off) is None
    small = (tapi.PSDTriangleConeT(3),)
    assert tchordal.try_chordal_info(np.ones((6, 2)), np.ones(6), small, s) is None
    dense = (tapi.PSDTriangleConeT(6),)
    assert tchordal.try_chordal_info(np.ones((21, 2)), np.ones(21), dense, s) is None
    assert jchordal.try_chordal_info(np.ones((21, 2)), np.ones(21),
                                     (ct.PSDTriangleConeT(6),), ct.DefaultSettings()) is None

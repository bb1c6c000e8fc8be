"""The port's multi-device slice against the JAX package: one spawned run of
four gloo CPU ranks (``_torch_distributed_worker.py`` "slice", started once
for the module, while this process computes the JAX references) drives
``ShardedRowSolver`` (dense and ELL, padding, the f64 fallback, the tall
sparse problem, a time limit, its collectives), ``BatchSolver`` on a 1-D
and a 2-D mesh, ``SparseBatchSolver`` on a 1-D mesh, and the ELL products
and row-sharded prepares; each test holds what the ranks wrote against the
JAX package's solve of the same numpy data, on the conftest's 8 CPU
devices.  Tolerances are the JAX tests' own (``tests/test_sharded.py``: x
and the objective within 1e-4 on the f32 row-sharded path;
``tests/test_batch.py``: 1e-7 at f64), 1e-12 relative for the f64 ELL
operations, 1e-7 for the f64 fallback, 1e-4 for the f32 2-D mesh.
"""

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (pins torch's threads)
import _torch_distributed_worker as worker
import clarabel_tpu as ct
import test_batch
import test_sharded
import test_sparse_batch
import test_torch_ell

import jax
from jax.sharding import Mesh

WORLD = 4


class _Ranks:
    """The spawned ranks; :meth:`results` waits for them once."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.procs = worker.spawn("slice", WORLD, out_dir)
        self._results = None

    def results(self):
        if self._results is None:
            self._results = worker.collect(self.procs, self.out_dir, timeout=300)
        return self._results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("world4"))
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def jax_mesh(shape=(8,), names=("rows",)):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(shape), names)


def jax_default(problem, dtype="float64"):
    P, q, A, b, cones = problem
    return ct.DefaultSolver(P, q, A, b, cones, test_sharded.settings(),
                            dtype=dtype, device=jax.devices("cpu")[0]).solve()


def same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])


def test_builders_match_the_jax_tests():
    """The worker's problems are the JAX tests' problems, array for array."""
    for mine, theirs in ((worker.tall_problem(), test_sharded.tall_problem()),
                         (worker.tall_problem(m=102), test_sharded.tall_problem(m=102)),
                         (worker.qp_batch(16, seed=1), test_batch.qp_batch(16, seed=1)),
                         (worker.qp_batch(8, seed=2), test_batch.qp_batch(8, seed=2))):
        for a, b in zip(mine[:4], theirs[:4]):
            np.testing.assert_array_equal(a, b)
    P, q, A, b, _ = worker.tall_sparse_problem(m=1000)
    P2, q2, A2, b2, _ = test_sharded.tall_sparse_problem(m=1000)
    assert (P != P2).nnz == 0 and (A != A2).nnz == 0
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(b, b2)
    Ps, q, A, b, _ = worker.banded_qp_batch(8, seed=7)
    Ps2, q2, A2, b2, _ = test_sparse_batch.banded_qp_batch(8, seed=7)
    assert all((x != y).nnz == 0 for x, y in zip(Ps, Ps2)) and (A != A2).nnz == 0
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(b, b2)


@pytest.fixture(scope="module")
def refs(ranks):
    """The JAX package's results for every test of the module, computed
    while the ranks run."""
    out = {"ell": test_torch_ell.jax_ops(jax_mesh())}
    out["dense"] = ct.ShardedRowSolver(*test_sharded.tall_problem(), test_sharded.settings(),
                                       mesh=jax_mesh()).solve()
    out["pad"] = jax_default(test_sharded.tall_problem(m=102))
    P, q, A, b, cones = test_sharded.tall_problem(n=16, m=128)
    out["ell_solve"] = jax_default((P, q, np.where(np.abs(A) > 0.8, A, 0.0), b, cones))
    out["f64"] = jax_default(test_sharded.tall_problem())
    P, q, A, b, cones = test_batch.qp_batch(16, seed=1)
    out["batch"] = ct.BatchSolver(P, q, A, b, cones, ct.DefaultSettings(verbose=False),
                                  mesh=jax_mesh(names=("batch",))).solve()
    # the sparse batch's lanes through the JAX package's dense BatchSolver
    # at f64, whose compile takes a tenth of its multifrontal batch's (the
    # port's sparse batch is held to the JAX SparseBatchSolver in
    # test_torch_sparse_batch.py)
    Ps, q, A, b, cones = test_sparse_batch.banded_qp_batch(8, seed=7)
    out["sparse_batch"] = ct.BatchSolver(
        np.stack([M.toarray() for M in Ps]), q, np.tile(A.toarray(), (8, 1, 1)), b, cones,
        ct.DefaultSettings(verbose=False), device=jax.devices("cpu")[0]).solve()
    P, q, A, b, cones = test_batch.qp_batch(8, seed=2)
    out["mesh2"] = ct.BatchSolver(P, q, A, b, cones,
                                  ct.DefaultSettings.for_float32(verbose=False),
                                  dtype="float32",
                                  mesh=jax_mesh((2, 2), ("batch", "rows"))).solve()
    return out


@pytest.mark.parametrize("key", test_torch_ell.KEYS)
def test_ell_ops_world4_match_jax(ranks, refs, key):
    """The ELL products, norms and both prepares at world 4, every rank's
    replicated result, against the JAX package's on 8 devices."""
    for r in ranks.results():
        test_torch_ell.close(r[key], refs["ell"][key])


def test_ell_blocks_world4(ranks):
    """Each rank holds its own contiguous block of A's rows, padding masked."""
    A, _, _ = worker.ell_data()
    dense = A.toarray()
    for rank, r in enumerate(ranks.results()):
        m_loc = A.shape[0] // WORLD
        assert int(r["ell_row0"]) == rank * m_loc
        np.testing.assert_array_equal(r["ell_block"], dense[rank * m_loc:(rank + 1) * m_loc])
        assert r["prep_ell_ok"] and r["prep_dense_ok"]


def test_sharded_dense_matches_jax(ranks, refs):
    """The f32 explicit path (tall_problem, n = 16, m = 128) against the
    JAX ShardedRowSolver on 8 devices; every rank returns the same bits,
    and a repeat is bitwise equal."""
    ref = refs["dense"]
    res = ranks.results()
    r = res[0]
    assert bool(r["dense_explicit"])
    assert int(r["dense_status"]) == int(ref.status) == int(ct.SolverStatus.Solved)
    assert np.allclose(r["dense_x"], ref.x, atol=1e-4)
    assert abs(float(r["dense_obj"]) - ref.obj_val) <= 1e-4
    for key in ("dense_x", "dense_z", "dense_s", "dense_repeat_x", "dense_iterations"):
        same_on_every_rank(res, key)
    np.testing.assert_array_equal(r["dense_repeat_x"], r["dense_x"])


def test_sharded_pads_indivisible_rows(ranks, refs):
    """m = 102 pads 2 inert rows at world 4; the solution comes back at the
    user's 102 rows, x within 1e-4 of the JAX package's f64 solve."""
    ref = refs["pad"]
    for r in ranks.results():
        assert int(r["pad_rows"]) == 2
        assert r["pad_z"].shape == (102,) and r["pad_s"].shape == (102,)
        assert int(r["pad_status"]) == int(ct.SolverStatus.Solved)
        assert np.allclose(r["pad_x"], ref.x, atol=1e-4)


def test_sharded_sparse_matches_dense_path(ranks, refs):
    """scipy-sparse A (ELL row blocks) against the dense-input sharded
    path, both explicit, and against the JAX package's f64 solve."""
    ref = refs["ell_solve"]
    res = ranks.results()
    r = res[0]
    assert r["ell_path"].tolist() == [True, True, False]
    assert int(r["ell_sparse_status"]) == int(r["ell_dense_status"]) \
        == int(ct.SolverStatus.Solved)
    assert np.allclose(r["ell_sparse_x"], r["ell_dense_x"], atol=1e-4)
    assert np.allclose(r["ell_sparse_x"], ref.x, atol=1e-4)
    assert abs(float(r["ell_sparse_obj"]) - ref.obj_val) <= 1e-4
    same_on_every_rank(res, "ell_sparse_x")


def test_sharded_f64_fallback_matches_jax(ranks, refs):
    """f64 takes the fallback (A whole on every rank, no collective): within
    1e-7 of the JAX DefaultSolver."""
    ref = refs["f64"]
    for r in ranks.results():
        assert not bool(r["f64_explicit"]) and int(r["f64_collective_calls"]) == 0
        assert int(r["f64_status"]) == int(ref.status) == int(ct.SolverStatus.Solved)
        np.testing.assert_allclose(r["f64_x"], ref.x, atol=1e-7)
        assert abs(float(r["f64_obj"]) - ref.obj_val) <= 1e-7


def test_sharded_communication_pattern(ranks):
    """The explicit path all-reduces (the Gram and Aᵀv) and never moves a
    2-D tensor with m rows: A is never gathered, on the dense path (m =
    128) nor the tall sparse one (m = 100000); m-vector gathers are fine."""
    for r in ranks.results():
        calls = dict(zip(("all_reduce", "all_gather"), r["dense_collectives"][:, 0]))
        assert calls["all_reduce"] > 0 and calls["all_gather"] > 0
        for key, m in (("dense_shapes", 128), ("tall_shapes", 100_000)):
            shapes = [tuple(int(d) for d in s.split(":")[1].split(",")) for s in r[key]]
            assert any(len(s) == 2 for s in shapes), r[key]
            assert not [s for s in shapes if len(s) >= 2 and m in s[:-1]], r[key]


def test_sharded_sparse_tall(ranks):
    """The tall sparse problem (m = 100000, n = 48) sets up with a peak
    traced host allocation under half the bytes of the dense f32 A, and
    solves to the JAX test's host residual bounds (5e-4) with status Solved
    or AlmostSolved (the JAX package's own status there is AlmostSolved)."""
    P, q, A, b, _ = test_sharded.tall_sparse_problem()
    m, n = A.shape
    res = ranks.results()
    for r in res:
        assert r["tall_path"].tolist() == [True, True]
        assert int(r["tall_setup_peak_bytes"]) < 0.5 * m * n * 4, int(r["tall_setup_peak_bytes"])
    r = res[0]
    assert int(r["tall_status"]) in (int(ct.SolverStatus.Solved),
                                     int(ct.SolverStatus.AlmostSolved))
    x, s, z = r["tall_x"], r["tall_s"], r["tall_z"]
    r_prim = np.linalg.norm(A @ x + s - b, np.inf)
    r_dual = np.linalg.norm(P @ x + q + A.T @ z, np.inf)
    assert r_prim <= 5e-4 * max(1.0, np.abs(b).max()), r_prim
    assert r_dual <= 5e-4 * max(1.0, np.abs(q).max()), r_dual
    assert (s >= -1e-5).all() and (z >= -1e-5).all()
    for key in ("tall_x", "tall_z", "tall_s"):
        same_on_every_rank(res, key)


def test_time_limit_ends_every_rank_together(ranks):
    """One rank's clock passes the time limit at its fourth read; the group
    decides together, so every rank stops at the same iteration with the
    same status and bits (and none waits alone for the others)."""
    res = ranks.results()
    r = res[0]
    assert int(r["timed_status"]) in (int(ct.SolverStatus.MaxTime),
                                      int(ct.SolverStatus.AlmostSolved))
    assert int(r["timed_iterations"]) < int(r["dense_iterations"])
    for key in ("timed_status", "timed_iterations", "timed_x"):
        same_on_every_rank(res, key)


def test_batch_over_mesh_matches_jax(ranks, refs):
    """BatchSolver on a 1-D mesh of 4 (qp_batch, B = 16): rank r solves lanes
    4r..4r+3, reports them in ``lanes``, and matches the JAX BatchSolver on
    8 devices within 1e-7; a warm start from the rank's own solution keeps
    its lanes."""
    ref = refs["batch"]
    assert ref.lanes is None
    for rank, r in enumerate(ranks.results()):
        lanes = np.arange(4 * rank, 4 * rank + 4)
        for prefix in ("batch", "batch_warm"):
            np.testing.assert_array_equal(r[f"{prefix}_lanes"], lanes)
            assert (r[f"{prefix}_status"] == int(ct.SolverStatus.Solved)).all()
        np.testing.assert_allclose(r["batch_x"], ref.x[lanes], atol=1e-7)
        np.testing.assert_allclose(r["batch_obj"], ref.obj_val[lanes], atol=1e-7)
        np.testing.assert_allclose(r["batch_warm_obj"], ref.obj_val[lanes], atol=1e-7)
        np.testing.assert_array_equal(r["batch_iterations"], ref.iterations[lanes])


def test_sparse_batch_over_mesh_matches_jax(ranks, refs):
    """SparseBatchSolver on a mesh of 4 (banded_qp_batch, B = 8): rank r
    solves lanes 2r, 2r+1, each within 1e-7 of the JAX package's solve of
    the same lanes (``refs``: its dense BatchSolver at f64)."""
    ref = refs["sparse_batch"]
    for rank, r in enumerate(ranks.results()):
        lanes = np.arange(2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(r["sparse_batch_lanes"], lanes)
        assert (r["sparse_batch_status"] == int(ct.SolverStatus.Solved)).all()
        np.testing.assert_allclose(r["sparse_batch_x"], ref.x[lanes], atol=1e-7)
        np.testing.assert_allclose(r["sparse_batch_obj"], ref.obj_val[lanes], atol=1e-7)


def test_batch_over_2d_mesh_matches_jax(ranks, refs):
    """BatchSolver on a 2 x 2 (batch x rows) mesh, f32 through "auto"
    ("schur_diag"): each row group solves its 4 lanes with A's rows split
    over its two ranks, within 1e-4 of the JAX package's 2-D mesh solve;
    both ranks of a row group hold the same bits, and a repeat too."""
    ref = refs["mesh2"]
    res = ranks.results()
    groups = {}
    for r in res:
        g = int(r["mesh2_coords"][0])
        groups.setdefault(g, []).append(r)
        lanes = np.arange(4 * g, 4 * g + 4)
        assert bool(r["mesh2_row_sharded"])
        np.testing.assert_array_equal(r["mesh2_lanes"], lanes)
        assert (r["mesh2_status"] == int(ct.SolverStatus.Solved)).all()
        assert (ref.status[lanes] == int(ct.SolverStatus.Solved)).all()
        assert np.allclose(r["mesh2_x"], ref.x[lanes], atol=1e-4)
        assert np.allclose(r["mesh2_obj"], ref.obj_val[lanes], atol=1e-4)
        np.testing.assert_array_equal(r["mesh2_repeat_x"], r["mesh2_x"])
    assert sorted(groups) == [0, 1]
    for members in groups.values():
        same_on_every_rank(members, "mesh2_x")

"""The port's row-sharded matrices and row-sharded Schur prepares
(``clarabel_tpu_torch/algebra/ell.py``, ``kkt/dense.py``) against the JAX
package's, in this process: a gloo group of one rank (on a ``HashStore``,
so no port is needed) against the JAX package's ``ELLRowMat`` and prepares
on the conftest's 8 CPU devices, on the same numpy data.  Tolerance: 1e-12
relative at f64 (the sums run in other orders: 8 shards' partial sums
against one rank's).  The same operations at world 4 run in
``test_torch_sharded.py``'s spawned ranks.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parity  # noqa: F401  (pins torch's threads)
import _torch_distributed_worker as worker
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu_torch.algebra.ell import DenseRowMat, ELLRowMat
from clarabel_tpu_torch.kkt import dense as kkt_dense
from clarabel_tpu_torch.parallel import comm

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from clarabel_tpu.algebra.ell import ELLRowMat as JaxELL
from clarabel_tpu.kkt import dense as jax_dense

RTOL = 1e-12


@pytest.fixture(scope="module")
def mesh():
    """A 1-D mesh of this process alone, torn down after the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tt.distributed.global_mesh(("rows",), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices("cpu")[:8]), ("rows",))


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    assert np.abs(a - b).max(initial=0.0) <= rtol * scale, np.abs(a - b).max()


def jax_ops(jax_mesh):
    """The JAX package's ELL products, norms, scaling and prepares on
    ``worker.ell_data()``, as numpy arrays keyed as the port's worker keys
    them (one jitted program: one compile)."""
    A, P, v = worker.ell_data()
    JA = JaxELL.from_scipy(A, jax_mesh, "rows", jnp.float64)
    rows2 = NamedSharding(jax_mesh, PartitionSpec("rows", None))
    Ad = jax.device_put(jnp.asarray(A.toarray()), rows2)
    eq = np.zeros(A.shape[0])
    eq[:3] = 1.0
    settings = ct.DefaultSettings()

    @jax.jit
    def run(JA, Ad, P, x, z, e, d, hs, rhs):
        ref = {
            "ell_Ax": JA @ x,
            "ell_ATz": JA.T @ z,
            "ell_row_abs_max": JA.row_abs_max(),
            "ell_col_abs_max": JA.col_abs_max(),
            "ell_scaled_Ax": JA.scale(e, d) @ x,
        }
        for name, prep in (
                ("ell", jax_dense.prepare_schur_diag_rowsharded_ell(P, JA, hs, settings, eq)),
                ("dense", jax_dense.prepare_schur_diag_rowsharded(P, Ad, hs, settings, eq,
                                                                  jax_mesh, "rows"))):
            factors, matvec, ok = prep
            ref[f"prep_{name}_LS"] = factors[1][1]
            ref[f"prep_{name}_solve"] = jax_dense._raw_solve(factors, rhs)
            ref[f"prep_{name}_matvec"] = matvec(rhs)
            ref[f"prep_{name}_ok"] = ok
        return ref

    out = run(JA, Ad, *(jnp.asarray(a) for a in (P, v["x"], v["z"], v["e"], v["d"], v["hs"],
                                                  v["rhs"])))
    return {k: np.asarray(x) for k, x in out.items()}


@pytest.fixture(scope="module")
def reference(jax_mesh):
    return jax_ops(jax_mesh)


@pytest.fixture(scope="module")
def port(mesh):
    out = {}
    worker.ell_ops(mesh, out)
    return out


KEYS = ["ell_Ax", "ell_ATz", "ell_row_abs_max", "ell_col_abs_max", "ell_scaled_Ax",
        "prep_ell_LS", "prep_ell_solve", "prep_ell_matvec",
        "prep_dense_LS", "prep_dense_solve", "prep_dense_matvec"]


@pytest.mark.parametrize("key", KEYS)
def test_world1_matches_jax(port, reference, key):
    close(port[key], reference[key])


def test_world1_prepares_ok_and_block(port, reference):
    """Both prepares report a usable factor, as the JAX package's do, and
    the ELL block is A's rows with the padding (at column 0) left out --
    row 7 stores column 0 beside padding slots."""
    A, _, _ = worker.ell_data()
    assert port["prep_ell_ok"] and port["prep_dense_ok"]
    assert reference["prep_ell_ok"] and reference["prep_dense_ok"]
    np.testing.assert_array_equal(port["ell_block"], A.toarray())
    assert A[7, 0] == 2.5 and A[7].nnz < A.getnnz(axis=1).max()


def test_ell_products_are_fixed_order(mesh):
    """Aᵀz sums each column's entries in a fixed order (no atomics): a
    repeat gives the same bits, and the result equals the dense product to
    rounding."""
    A, _, v = worker.ell_data()
    E = ELLRowMat.from_scipy(A, mesh, "rows", torch.float64)
    z = torch.as_tensor(v["z"])
    first = E.T @ z
    assert torch.equal(first, E.T @ z)
    close(first.numpy(), A.T @ v["z"], 1e-14)


def test_dense_row_mat_batch_products(mesh):
    """DenseRowMat over a leading batch dimension: each problem's products,
    norms and scaling are those of its own dense matrix."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 12, 5))
    x, z = rng.normal(size=(3, 5)), rng.normal(size=(3, 12))
    e, d = rng.uniform(0.5, 2, (3, 12)), rng.uniform(0.5, 2, (3, 5))
    t = torch.as_tensor
    D = DenseRowMat.from_mesh(t(A), 12, mesh, "rows")
    close((D @ t(x)).numpy(), np.einsum("bij,bj->bi", A, x), 1e-14)
    close((D.mT @ t(z)).numpy(), np.einsum("bij,bi->bj", A, z), 1e-14)
    np.testing.assert_array_equal(D.row_abs_max().numpy(), np.abs(A).max(axis=2))
    np.testing.assert_array_equal(D.col_abs_max().numpy(), np.abs(A).max(axis=1))
    scaled = D.scale(t(e), t(d)).densify_sharded().numpy()
    np.testing.assert_array_equal(scaled, A * e[:, :, None] * d[:, None, :])


def test_world1_sharded_solve_is_default_solver(mesh):
    """A world of one computes what DefaultSolver computes through
    "schur_diag" at f32, bit for bit, and counts its collectives: all-reduces
    of [n] and [n, n], all-gathers of [m], nothing of A's shape."""
    P, q, A, b, cones = worker.tall_problem()
    comm.reset()
    solver = tt.ShardedRowSolver(P, q, A, b, cones, worker.settings(), mesh=mesh)
    sol = solver.solve()
    ref = tt.DefaultSolver(P, q, A, b, cones, worker.settings(), dtype="float32",
                           device="cpu").solve()
    assert solver._explicit_collectives and not solver._sparse_A
    assert sol.status == ref.status == tt.SolverStatus.Solved
    np.testing.assert_array_equal(sol.x, ref.x)
    np.testing.assert_array_equal(sol.z, ref.z)
    assert sol.iterations == ref.iterations
    calls = solver.collectives
    assert calls["all_reduce"]["calls"] > 0 and calls["all_gather"]["calls"] > 0
    assert comm.shapes == {("all_reduce", (16,)), ("all_reduce", (16, 16)),
                           ("all_gather", (128,))}

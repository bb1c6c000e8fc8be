"""Worker process of the port's multi-device tests: joins a gloo process
group of CPU ranks and drives clarabel_tpu_torch's multi-device paths,
writing what it computed to ``<out>/rank<rank>.npz``.  It imports no JAX;
the tests hold its results against the JAX package.

Run as:  python _torch_distributed_worker.py <mode> <port> <rank> <world> <out>

``mode`` "slice" (world 4, ``test_torch_sharded.py``) runs the whole slice:
the ELL products and both row-sharded Schur prepares, ``ShardedRowSolver``
(dense and ELL, padding, the f64 fallback, the tall sparse problem with
its setup's traced host memory, a time limit reached on one rank's clock,
the collectives it made), ``BatchSolver`` on a 1-D mesh and on a 2-D
(batch x rows) mesh, and ``SparseBatchSolver`` on a 1-D mesh.  ``mode``
"batch" (world 2, ``test_torch_distributed.py``) solves the two-process
batch of ``tests/_distributed_worker.py`` and checks it against this
process's own single-process solve.

The problem builders here repeat the JAX tests' (``tests/test_sharded.py``,
``tests/test_batch.py``, ``tests/test_sparse_batch.py``) draw for draw;
the tests check that they build the same arrays.
"""

import os
import sys
import time
import tracemalloc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

# the ranks share the CPU's cores with the rest of the suite
torch.set_num_threads(1)

import clarabel_tpu_torch as tt  # noqa: E402
from clarabel_tpu_torch import loop  # noqa: E402
from clarabel_tpu_torch.algebra.ell import DenseRowMat, ELLRowMat  # noqa: E402
from clarabel_tpu_torch.kkt import dense as kkt_dense  # noqa: E402
from clarabel_tpu_torch.parallel import comm, distributed as dist  # noqa: E402


def tall_problem(n=16, m=128, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n)) / np.sqrt(n)
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    b = np.abs(A @ rng.normal(size=n)) + 1.0
    return P, q, A, b, [tt.NonnegativeConeT(m)]


def tall_sparse_problem(n=48, m=100_000, seed=1):
    rng = np.random.default_rng(seed)
    P = sp.diags(1.0 + rng.uniform(0, 1, n), format="csc")
    q = rng.normal(size=n)
    knz = 3
    rows = np.repeat(np.arange(m), knz)
    cols = rng.integers(0, n, m * knz)
    vals = rng.normal(size=m * knz)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    A.sum_duplicates()
    b = np.abs(A @ rng.normal(size=n)) + 1.0
    return P, q, A, b, [tt.NonnegativeConeT(m)]


def qp_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    n = 4
    M = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n))
    A = np.tile(np.vstack([np.eye(n), -np.eye(n)]), (B, 1, 1))
    b = np.ones((B, 2 * n))
    return P, q, A, b, [tt.NonnegativeConeT(2 * n)]


def banded_qp_batch(B, n=60, seed=0):
    rng = np.random.default_rng(seed)
    Ps, qs, bs = [], [], []
    for _ in range(B):
        main = 2.0 + rng.uniform(0.5, 1.5, n)
        off = rng.uniform(-0.4, 0.4, n - 1)
        Ps.append(sp.diags([main, off, off], [0, 1, -1], format="csc"))
        qs.append(rng.standard_normal(n))
        bs.append(np.concatenate([0.2 * np.ones(n), 0.2 * np.ones(n) + rng.uniform(0, 0.3, n)]))
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    return Ps, np.stack(qs), A, np.stack(bs), [tt.NonnegativeConeT(2 * n)]


def ell_data(m=64, n=10, seed=3):
    """A sparse [m, n] matrix (rows of 0-4 entries, two empty rows, an entry
    in column 0 beside padding) and the vectors the ELL tests apply."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, m)
    counts[[5, 40]] = 0
    rows = np.repeat(np.arange(m), counts)
    cols = np.concatenate([rng.choice(n, c, replace=False) for c in counts])
    A = sp.lil_matrix(sp.csr_matrix((rng.normal(size=rows.size), (rows, cols)), shape=(m, n)))
    A[7, 0] = 2.5
    A = A.tocsr()
    vec = dict(x=rng.normal(size=n), z=rng.normal(size=m), e=rng.uniform(0.5, 2, m),
               d=rng.uniform(0.5, 2, n), hs=rng.uniform(0.1, 3, m),
               rhs=rng.normal(size=n + m))
    M = rng.normal(size=(n, n)) / np.sqrt(n)
    return A, M @ M.T + np.eye(n), vec


def settings():
    return tt.DefaultSettings(verbose=False, tol_gap_abs=1e-5, tol_gap_rel=1e-5, tol_feas=1e-5,
                              tol_infeas_abs=1e-5, tol_infeas_rel=1e-5)


def sol_arrays(prefix, sol):
    return {f"{prefix}_x": sol.x, f"{prefix}_z": sol.z, f"{prefix}_s": sol.s,
            f"{prefix}_status": int(sol.status), f"{prefix}_obj": sol.obj_val,
            f"{prefix}_iterations": sol.iterations}


def batch_arrays(prefix, sol):
    return {f"{prefix}_x": sol.x, f"{prefix}_z": sol.z, f"{prefix}_obj": sol.obj_val,
            f"{prefix}_status": sol.status, f"{prefix}_iterations": sol.iterations,
            f"{prefix}_lanes": np.array([]) if sol.lanes is None else sol.lanes}


def shape_list():
    """The (kind, shape) of every collective since ``comm.reset()``, as
    "kind:d0,d1,..." strings."""
    return np.array([f"{k}:{','.join(map(str, s))}" for k, s in sorted(comm.shapes)])


def ell_ops(mesh, out):
    """The ELL products, norms, scaling and block, and both row-sharded
    prepares (their factor and one refined-free solve and product), f64."""
    A, P, v = ell_data()
    m, n = A.shape
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    E = ELLRowMat.from_scipy(A, mesh, "rows", torch.float64)
    out["ell_Ax"] = (E @ t(v["x"])).numpy()
    out["ell_ATz"] = (E.T @ t(v["z"])).numpy()
    out["ell_row_abs_max"] = E.row_abs_max().numpy()
    out["ell_col_abs_max"] = E.col_abs_max().numpy()
    out["ell_scaled_Ax"] = (E.scale(t(v["e"]), t(v["d"])) @ t(v["x"])).numpy()
    out["ell_block"] = E.densify_sharded().numpy()
    out["ell_row0"] = E.row0
    settings_ = tt.DefaultSettings()
    eq = torch.zeros(m, dtype=torch.float64)
    eq[:3] = 1.0
    Dl = t(A.toarray()[E.row0:E.row0 + E.m_loc])
    for name, (factors, matvec, ok) in (
            ("ell", kkt_dense.prepare_schur_diag_rowsharded_ell(t(P), E, t(v["hs"]), settings_, eq)),
            ("dense", kkt_dense.prepare_schur_diag_rowsharded(t(P), Dl, t(v["hs"]), settings_, eq,
                                                              mesh, "rows"))):
        out[f"prep_{name}_LS"] = factors[1][1].numpy()
        out[f"prep_{name}_solve"] = kkt_dense._raw_solve(factors, t(v["rhs"])).numpy()
        out[f"prep_{name}_matvec"] = matvec(t(v["rhs"])).numpy()
        out[f"prep_{name}_ok"] = bool(ok)


def run_slice(rank, world, out):
    mesh = dist.global_mesh(("rows",), device_type="cpu")
    ell_ops(mesh, out)

    # the dense f32 explicit path, its collectives, a repeat
    P, q, A, b, cones = tall_problem()
    comm.reset()
    solver = tt.ShardedRowSolver(P, q, A, b, cones, settings(), mesh=mesh)
    out["dense_explicit"] = solver._explicit_collectives
    out.update(sol_arrays("dense", solver.solve()))
    out["dense_collectives"] = np.array([[solver.collectives[k][f] for f in ("calls", "bytes")]
                                         for k in ("all_reduce", "all_gather")])
    out["dense_shapes"] = shape_list()
    out["dense_repeat_x"] = solver.solve().x

    # padding: m = 102 pads 2 at world 4
    P, q, A, b, cones = tall_problem(m=102)
    solver = tt.ShardedRowSolver(P, q, A, b, cones, settings(), mesh=mesh)
    out["pad_rows"] = solver._row_pad
    out.update(sol_arrays("pad", solver.solve()))

    # ELL against dense
    P, q, A, b, cones = tall_problem(n=16, m=128)
    A_sp = sp.csr_matrix(np.where(np.abs(A) > 0.8, A, 0.0))
    sparse = tt.ShardedRowSolver(P, q, A_sp, b, cones, settings(), mesh=mesh)
    dense = tt.ShardedRowSolver(P, q, A_sp.toarray(), b, cones, settings(), mesh=mesh)
    out["ell_path"] = [sparse._sparse_A, sparse._explicit_collectives, dense._sparse_A]
    out.update(sol_arrays("ell_sparse", sparse.solve()))
    out.update(sol_arrays("ell_dense", dense.solve()))

    # the f64 fallback: A whole on every rank, no collective
    P, q, A, b, cones = tall_problem()
    comm.reset()
    solver = tt.ShardedRowSolver(P, q, A, b, cones, settings(), mesh=mesh, dtype="float64")
    out["f64_explicit"] = solver._explicit_collectives
    out.update(sol_arrays("f64", solver.solve()))
    out["f64_collective_calls"] = sum(c["calls"] for c in comm.counts.values())

    # a time limit that one rank's clock reaches first: the group decides
    # together, so every rank stops at the same iteration
    if rank == 0:
        reads = iter(range(1 << 30))

        class _Clock:
            @staticmethod
            def monotonic():
                return 0.0 if next(reads) < 4 else 1e9

        loop.time = _Clock
    P, q, A, b, cones = tall_problem()
    solver = tt.ShardedRowSolver(P, q, A, b, cones,
                                 tt.DefaultSettings(verbose=False, time_limit=100.0), mesh=mesh)
    out.update(sol_arrays("timed", solver.solve()))
    loop.time = time

    # the tall sparse problem: the setup's traced host memory, the solve
    P, q, A, b, cones = tall_sparse_problem()
    tracemalloc.start()
    solver = tt.ShardedRowSolver(P, q, A, b, cones,
                                 tt.DefaultSettings.for_float32(verbose=False), mesh=mesh)
    out["tall_setup_peak_bytes"] = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    out["tall_path"] = [solver._sparse_A, solver._explicit_collectives]
    comm.reset()
    t0 = time.perf_counter()
    out.update(sol_arrays("tall", solver.solve()))
    out["tall_seconds"] = time.perf_counter() - t0
    out["tall_shapes"] = shape_list()

    # BatchSolver over a 1-D mesh of every rank
    bmesh = dist.global_mesh(("batch",), device_type="cpu")
    P, q, A, b, cones = qp_batch(16, seed=1)
    batch = tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False), mesh=bmesh)
    sol = batch.solve()
    out.update(batch_arrays("batch", sol))
    # a warm start from this rank's own solution
    out.update(batch_arrays("batch_warm", batch.solve(warm_start=sol)))

    # SparseBatchSolver over the same mesh
    Ps, q, A, b, cones = banded_qp_batch(8, seed=7)
    sb = tt.SparseBatchSolver(Ps, q, A, b, cones,
                              tt.DefaultSettings(verbose=False, direct_solve_method="multifrontal"),
                              mesh=bmesh)
    out.update(batch_arrays("sparse_batch", sb.solve()))

    # BatchSolver over a 2 x 2 (batch x rows) mesh: f32 through "auto",
    # which resolves to "schur_diag", so each row group splits A's rows
    mesh2 = dist.global_mesh(("batch", "rows"), shape=(2, 2), device_type="cpu")
    P, q, A, b, cones = qp_batch(8, seed=2)
    comm.reset()
    two = tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings.for_float32(verbose=False),
                         dtype="float32", mesh=mesh2)
    out["mesh2_row_sharded"] = isinstance(two._A, DenseRowMat)
    out.update(batch_arrays("mesh2", two.solve()))
    out["mesh2_repeat_x"] = two.solve().x
    out["mesh2_coords"] = [mesh2.get_local_rank(0), mesh2.get_local_rank(1)]


def run_batch(rank, world, out):
    """The two-process batch of tests/_distributed_worker.py."""
    mesh = dist.global_mesh(("batch",), device_type="cpu")
    assert mesh.size() == world
    B, n = 8, 6
    rng = np.random.default_rng(0)  # identical data in every process
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + np.eye(n)
    q = rng.normal(size=(B, n))
    A = np.tile(np.vstack([np.eye(n), -np.eye(n)]), (B, 1, 1))
    b = np.ones((B, 2 * n))
    cones = [tt.NonnegativeConeT(2 * n)]
    sol = tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False), dtype="float64",
                         mesh=mesh).solve()
    ref = tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False), dtype="float64",
                         device="cpu").solve()
    out.update(batch_arrays("batch", sol))
    out["ref_x"], out["ref_obj"] = ref.x, ref.obj_val


def spawn(mode, world, out_dir):
    """Start ``world`` ranks of this worker in ``mode``, writing to
    ``out_dir``; returns their processes (see :func:`collect`)."""
    import socket
    import subprocess

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(port),
                              str(rank), str(world), str(out_dir)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]


def collect(procs, out_dir, timeout):
    """Wait for the ranks of :func:`spawn` (killing them past ``timeout``
    seconds) and return each rank's results, in rank order; raises with a
    rank's output when it failed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK{rank} OK" not in text:
            raise RuntimeError(f"rank {rank} failed ({p.returncode}):\n{text}")
    return [dict(np.load(os.path.join(out_dir, f"rank{rank}.npz"))) for rank in range(len(procs))]


def main():
    mode, port, rank, world, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    # "batch" joins as a user of the CPU would, through initialize()'s own
    # choice of backend (gloo without a CUDA device)
    dist.initialize(f"127.0.0.1:{port}", world, rank,
                    **({"backend": "gloo"} if mode == "slice" else {}))
    out = {}
    {"slice": run_slice, "batch": run_batch}[mode](rank, world, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)


if __name__ == "__main__":
    main()

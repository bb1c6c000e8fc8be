"""The host surface of clarabel_tpu_torch against the JAX package's: JSON
problem IO in both directions, on the dense and the sparse path, for every
cone kind; the print targets; the accessors, ``print_timers``, ``profile``
and ``buildinfo`` (reference: tests/json_io.rs, print_streams.rs).

The JSON files are compared parsed, field for field: both packages write
Python floats through ``repr``, which round-trips exactly, so a file
either package writes holds the same numbers.  A solve of a loaded file
is held to the JAX package's solve of the same file with
``_torch_parity.assert_lane_matches``.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu import json_io as jax_json_io
from clarabel_tpu_torch import json_io

#: one problem of each cone kind (of _torch_parity.PROBLEMS)
KINDS = tp.FILE_KINDS


def tiny_qp():
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.vstack([np.ones((1, 2)), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    return P, np.array([1.0, 1.0]), A, b, [tt.ZeroConeT(1), tt.NonnegativeConeT(4)]


def presolved_qp():
    """A QP whose presolve drops two rows (b = 1e30 on nonnegative rows)."""
    P, q, A, b, _ = tiny_qp()
    A = np.vstack([A, np.eye(2)])
    b = np.concatenate([b, [1e30, 1e30]])
    return P, q, A, b, [ct.ZeroConeT(1), ct.NonnegativeConeT(6)]


def chordal_sdp(n=6):
    """A banded PSD(n) problem that the chordal decomposition splits into
    its cliques (the guard test's problem)."""
    pairs = [(i, j) for j in range(n) for i in range(j + 1) if j - i <= 1]
    A = np.zeros((n * (n + 1) // 2, len(pairs)))
    for k, (i, j) in enumerate(pairs):
        A[j * (j + 1) // 2 + i, k] = -1.0
    return (np.eye(len(pairs)), -np.ones(len(pairs)), A, np.zeros(A.shape[0]),
            [ct.PSDTriangleConeT(n)])


def sparse_inputs(P, A):
    """P and A as scipy matrices, as a sparse-path caller gives them."""
    return sp.csc_matrix(np.asarray(P, np.float64)), sp.csc_matrix(np.asarray(A, np.float64))


def both(problem, method, sparse, **settings):
    """The JAX package's and the port's solvers of ``problem`` (JAX cones,
    numpy data), unsolved."""
    P, q, A, b, cones = problem
    if sparse:
        P, A = sparse_inputs(P, A)
    s = ct.DefaultSettings(verbose=False, direct_solve_method=method, **settings)
    ref = ct.DefaultSolver(P, q, A, b, cones, s)
    got = tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(s),
                           device="cpu")
    return ref, got


def read(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# mirrors of tests/test_api_misc.py


def test_json_roundtrip(tmp_path):
    # reference: tests/json_io.rs
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A1 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    A = np.vstack([-A1, A1])
    b = np.array([-1.0, 0.0, 0.0, 1.0, 0.7, 0.7])
    cones = [tt.NonnegativeConeT(3), tt.NonnegativeConeT(3)]
    settings = tt.DefaultSettings(verbose=False, presolve_enable=False)

    solver = tt.DefaultSolver(P, q, A, b, cones, settings, device="cpu")
    s1 = solver.solve()

    path = tmp_path / "problem.json"
    solver.save_to_file(path)

    solver2 = tt.DefaultSolver.load_from_file(path, device="cpu")
    s2 = solver2.solve()
    assert s1.status == s2.status
    assert np.allclose(s1.x, s2.x, atol=1e-9)

    # settings override on load
    solver3 = tt.DefaultSolver.load_from_file(
        path, tt.DefaultSettings(verbose=False, max_iter=1), device="cpu"
    )
    s3 = solver3.solve()
    assert s3.status == tt.SolverStatus.MaxIterations


def test_print_streams(capsys):
    # reference: tests/print_streams.rs
    P, q, A, b, cones = tiny_qp()
    solver = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=True),
                              device="cpu")

    solver.print_to_buffer()
    solver.solve()
    out = solver.get_print_buffer()
    assert "clarabel_tpu_torch" in out and "Solved" in out and "kkt = lu" in out

    # sink: no output
    solver.print_to_sink()
    solver.solve()
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError):
        solver.get_print_buffer()

    # stdout
    solver.print_to_stdout()
    solver.solve()
    captured = capsys.readouterr()
    assert "Solved" in captured.out


def test_print_to_stream():
    # reference: io/mod.rs Stream variant — any user-supplied writable
    P, q, A, b, cones = tiny_qp()
    solver = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=True),
                              device="cpu")

    class Tee(io.StringIO):
        pass

    stream = Tee()
    solver.print_to_stream(stream)
    solver.solve()
    assert "Solved" in stream.getvalue()

    with pytest.raises(TypeError):
        solver.print_to_stream(42)


def test_print_to_file(tmp_path):
    P, q, A, b, cones = tiny_qp()
    solver = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=True),
                              device="cpu")
    path = tmp_path / "log.txt"
    solver.print_to_file(str(path))
    solver.solve()
    solver._print_stream.flush()
    assert "Solved" in path.read_text()


# ---------------------------------------------------------------------------
# across packages


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_the_files_the_jax_package_writes(kind, sparse, tmp_path):
    """For one problem of each cone kind, on the dense path ("auto") and
    the sparse one ("multifrontal", P and A given as scipy matrices): the
    port's file equals the JAX package's field for field, loads in the JAX
    package with P, q, A, b, cones and settings equal bit for bit, and the
    port's solve of it equals its solve of the original problem bit for
    bit (the same data give the same plan)."""
    problem = tp.PROBLEMS[KINDS[kind]]()
    method = "multifrontal" if sparse else "auto"
    ref, got = both(problem, method, sparse)
    assert got._sparse == sparse == ref._sparse
    ref.save_to_file(tmp_path / "jax.json")
    got.save_to_file(tmp_path / "port.json")
    assert read(tmp_path / "port.json") == read(tmp_path / "jax.json")

    P, q, A, b, cones, settings = jax_json_io.load_problem(tmp_path / "port.json")
    P_r, q_r, A_r, b_r, cones_r, settings_r = jax_json_io.load_problem(tmp_path / "jax.json")
    for x, y in ((P, P_r), (A, A_r)):
        assert x.shape == y.shape and np.array_equal(x.indptr, y.indptr)
        assert np.array_equal(x.indices, y.indices) and np.array_equal(x.data, y.data)
    assert np.array_equal(q, q_r) and np.array_equal(b, b_r)
    assert cones == cones_r and settings == settings_r
    assert tp.port_cones(cones) == tuple(got._cones_int)

    again = tt.DefaultSolver.load_from_file(tmp_path / "port.json", device="cpu")
    assert again._sparse == sparse
    first, second = got.solve(), again.solve()
    assert second.status == first.status and second.iterations == first.iterations
    for v in ("x", "z", "s"):
        assert np.array_equal(getattr(second, v), getattr(first, v)), v


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("case", ["presolve", "chordal", "time_limit"])
def test_round_trip_edge_cases(case, sparse, tmp_path):
    """A presolve that removes rows writes only the surviving rows; a PSD
    cone split by the chordal decomposition is written as the user's
    PSDTriangleConeT; an infinite time limit is written as the largest
    f64 and read back as infinity, a finite one as itself.  Each file equals
    the JAX package's field for field and solves as the original does."""
    if case == "presolve":
        problem = presolved_qp()
    elif case == "chordal":
        problem = chordal_sdp()
    else:
        problem = tiny_qp()[:4] + ([ct.ZeroConeT(1), ct.NonnegativeConeT(4)],)
    method = "multifrontal" if sparse else "auto"
    ref, got = both(problem, method, sparse)
    ref.save_to_file(tmp_path / "jax.json")
    got.save_to_file(tmp_path / "port.json")
    data = read(tmp_path / "port.json")
    assert data == read(tmp_path / "jax.json")

    if case == "presolve":
        assert got._presolver is not None
        assert data["A"]["m"] == len(data["b"]) == 5
        assert data["cones"] == [{"ZeroConeT": 1}, {"NonnegativeConeT": 4}]
    elif case == "chordal":
        assert got._chordal is not None
        assert data["cones"] == [{"PSDTriangleConeT": 6}]
    else:
        assert data["settings"]["time_limit"] == np.finfo(np.float64).max
        assert math.isinf(tt.DefaultSolver.load_from_file(
            tmp_path / "port.json", device="cpu").settings.time_limit)
        finite = tt.DefaultSettings(verbose=False, time_limit=12.5,
                                    direct_solve_method=method)
        P, q, A, b, cones = tiny_qp()
        tt.DefaultSolver(P, q, A, b, cones, finite, device="cpu").save_to_file(
            tmp_path / "finite.json")
        assert tt.DefaultSolver.load_from_file(
            tmp_path / "finite.json", device="cpu").settings.time_limit == 12.5

    loaded = tt.DefaultSolver.load_from_file(tmp_path / "port.json", device="cpu")
    first, second = got.solve(), loaded.solve()
    assert first.status == second.status == tt.SolverStatus.Solved
    assert abs(first.obj_val - second.obj_val) <= 1e-12 * max(1.0, abs(first.obj_val))


def test_sparse_save_stays_sparse(tmp_path):
    """The sparse path writes its CSC matrices as they are: P's upper
    triangle and A carry exactly the stored entries, nothing densified."""
    n = 3000
    rng = np.random.default_rng(0)
    P = sp.diags([2.0 + rng.random(n), -0.5 * np.ones(n - 1)], [0, 1], format="csc")
    P = (P + P.T).tocsc()
    A = sp.vstack([sp.eye(n), -sp.eye(n)], format="csc")
    solver = tt.DefaultSolver(P, rng.normal(size=n), A, np.ones(2 * n),
                              [tt.NonnegativeConeT(2 * n)], tt.DefaultSettings(verbose=False),
                              device="cpu")
    assert solver._sparse
    solver.save_to_file(tmp_path / "big.json")
    data = read(tmp_path / "big.json")
    assert len(data["P"]["nzval"]) == sp.triu(P).nnz == 2 * n - 1
    assert len(data["A"]["nzval"]) == A.nnz == 2 * n


def test_load_passes_device_and_dtype_through(tmp_path, monkeypatch):
    """``load_from_file`` runs on cuda unless told otherwise: without a
    card it raises, as the constructor does; ``device="cpu"`` and
    ``dtype`` pass through."""
    P, q, A, b, cones = tiny_qp()
    tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings.for_float32(verbose=False),
                     device="cpu").save_to_file(tmp_path / "p.json")
    s = tt.DefaultSolver.load_from_file(tmp_path / "p.json", dtype="float32", device="cpu")
    assert s._dtype == "float32" and s.solve().status == tt.SolverStatus.Solved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.DefaultSolver.load_from_file(tmp_path / "p.json")


# ---------------------------------------------------------------------------
# accessors, timers, profile, buildinfo


def test_accessors_and_timers(capsys):
    P, q, A, b, cones = tiny_qp()
    solver = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False),
                              device="cpu")
    assert solver.get_solution() is None
    assert solver.get_settings() is solver.settings
    sol = solver.solve()
    assert solver.get_solution() is sol and solver.get_info() is solver.info
    assert solver.get_info().status == tt.SolverStatus.Solved
    solver.print_timers()
    out = capsys.readouterr().out
    assert "setup" in out and "solve" in out


def test_profile_leaves_a_trace(tmp_path):
    P, q, A, b, cones = tiny_qp()
    solver = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False),
                              device="cpu")
    with solver.profile(tmp_path / "trace"):
        solver.solve()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert read(traces[0])["traceEvents"]


def test_buildinfo_reports_torch_and_never_jax():
    info = tt.buildinfo()
    for key in ("version", "python", "system", "torch", "cuda", "ldl_library_built",
                "native_symbolic"):
        assert key in info, key
    assert info["version"] == tt.__version__ == "0.10.0"
    assert not any("jax" in key for key in info)
    assert isinstance(info["native_symbolic"], bool)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tt.print_buildinfo()
    assert "native_symbolic" in out.getvalue()

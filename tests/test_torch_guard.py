"""Boundaries of clarabel_tpu_torch: it never imports JAX or the JAX
package, it runs on CUDA unless told otherwise, and what it does not port
yet raises instead of taking another path."""

import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity  # noqa: F401  (pins torch's threads)
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
from clarabel_tpu_torch import convert
from clarabel_tpu_torch.cones import api
from clarabel_tpu_torch.kkt import pallas_ldl

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "clarabel_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_solve.py",
    ROOT / "scripts" / "ab_unblocked_kernel.py", ROOT / "scripts" / "f32_df_parity.py",
    ROOT / "scripts" / "df_lu_phases.py", ROOT / "tests" / "_torch_distributed_worker.py"]


def _tiny_qp():
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.vstack([np.ones((1, 2)), np.eye(2), -np.eye(2)])
    b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])
    return P, np.array([1.0, 1.0]), A, b, [tt.ZeroConeT(1), tt.NonnegativeConeT(4)]


def test_solve_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import clarabel_tpu_torch as tt\n"
        "P = np.array([[4.0, 1.0], [1.0, 2.0]])\n"
        "A = np.vstack([np.ones((1, 2)), np.eye(2), -np.eye(2)])\n"
        "b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])\n"
        "for method in ('auto', 'pallas'):\n"
        "    s = tt.DefaultSolver(P, np.ones(2), A, b, [tt.ZeroConeT(1), tt.NonnegativeConeT(4)],\n"
        "        tt.DefaultSettings(verbose=False, direct_solve_method=method), device='cpu')\n"
        "    assert s.solve().status == tt.SolverStatus.Solved\n"
        "    assert s.solve(warm_start=s.solution).status == tt.SolverStatus.Solved\n"
        "# an exponential and a power cone (cones/nonsymmetric.py)\n"
        "A = np.vstack([-np.eye(3), [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], -np.eye(3)[::-1]])\n"
        "b = np.array([0.0, 0.0, 0.0, 1.0, np.exp(5.0), 0.0, 0.0, 0.0])\n"
        "cones = [tt.ExponentialConeT(), tt.ZeroConeT(2), tt.PowerConeT(0.5)]\n"
        "s = tt.DefaultSolver(np.zeros((3, 3)), np.array([-1.0, 0.0, 0.0]), A, b, cones,\n"
        "    tt.DefaultSettings(verbose=False), device='cpu')\n"
        "assert s.solve().status == tt.SolverStatus.Solved\n"
        "# a PSD cone decomposed into its cliques (cones/psd.py, chordal/)\n"
        "n = 6\n"
        "pairs = [(i, j) for j in range(n) for i in range(j + 1) if j - i <= 1]\n"
        "A = np.zeros((21, len(pairs)))\n"
        "for k, (i, j) in enumerate(pairs):\n"
        "    A[j * (j + 1) // 2 + i, k] = -1.0\n"
        "s = tt.DefaultSolver(np.eye(len(pairs)), -np.ones(len(pairs)), A, np.zeros(21),\n"
        "    [tt.PSDTriangleConeT(n)], tt.DefaultSettings(verbose=False), device='cpu')\n"
        "assert s._chordal is not None and s.solve().status == tt.SolverStatus.Solved\n"
        "# the sparse multifrontal path (algebra/, kkt/sparse.py, kkt/multifrontal.py)\n"
        "P = np.array([[4.0, 1.0], [1.0, 2.0]])\n"
        "A = np.vstack([np.ones((1, 2)), np.eye(2), -np.eye(2)])\n"
        "b = np.array([1.0, 0.7, 0.7, 0.0, 0.0])\n"
        "s = tt.DefaultSolver(P, np.ones(2), A, b, [tt.ZeroConeT(1), tt.NonnegativeConeT(4)],\n"
        "    tt.DefaultSettings(verbose=False, direct_solve_method='multifrontal'), device='cpu')\n"
        "assert s._sparse and s.solve().status == tt.SolverStatus.Solved\n"
        "# the sparse batch (parallel/sparse_batch.py)\n"
        "import scipy.sparse as sp\n"
        "sb = tt.SparseBatchSolver(sp.csc_matrix(P), np.ones((2, 2)), sp.csc_matrix(A),\n"
        "    np.stack([b, b]), [tt.ZeroConeT(1), tt.NonnegativeConeT(4)],\n"
        "    tt.DefaultSettings(verbose=False), device='cpu')\n"
        "assert sb.solve().statuses() == [tt.SolverStatus.Solved] * 2\n"
        "# the host surface: buildinfo, JSON IO on both paths (json_io.py, native.py)\n"
        "import os, tempfile\n"
        "assert 'jax' not in tt.buildinfo()\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    s.save_to_file(os.path.join(d, 'p.json'))\n"
        "    t = tt.DefaultSolver.load_from_file(os.path.join(d, 'p.json'), device='cpu')\n"
        "    assert t._sparse and t.solve().status == tt.SolverStatus.Solved\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'clarabel_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "clarabel_tpu"), f"{path}: import {name}"


def test_c_sources_import_only_the_port():
    """The port's C shim imports only modules of clarabel_tpu_torch, and no
    file of the port loads a library of the JAX package's ``native/``."""
    sources = sorted(p for p in (ROOT / "clarabel_tpu_torch").rglob("*")
                     if p.suffix in (".c", ".cpp", ".cu"))
    assert ROOT / "clarabel_tpu_torch" / "capi" / "capi.cpp" in sources
    imports = []
    for path in sources:
        for name in re.findall(r'PyImport_ImportModule\("([^"]*)"\)', path.read_text()):
            assert name.startswith("clarabel_tpu_torch."), f"{path}: imports {name}"
            imports.append(name)
    assert imports == ["clarabel_tpu_torch.capi_support"]
    for path in PORT_FILES + sources:
        text = path.read_text()
        assert "libclarabel_native" not in text and "libclarabel_tpu_c" not in text, path


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, q, A, b, cones = _tiny_qp()
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False))


def _f32(method):
    return dict(dtype="float32", settings=tt.DefaultSettings.for_float32(
        verbose=False, direct_solve_method=method))


def _psd2():
    """min x₁ + x₂ subject to [[x₁, ½], [½, x₂]] ⪰ 0 (one PSDTriangleConeT(2):
    s = svec(X) = b - A x), optimum x = (½, ½), objective 1; x = (1, 1) is
    strictly feasible.  (A PSD(2) with A = 1, b = 1 has no interior.)"""
    A = -np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 1.0]])
    b = np.array([0.0, np.sqrt(2.0) / 2.0, 0.0])
    return np.zeros((2, 2)), np.ones(2), A, b, [tt.PSDTriangleConeT(2)]


@pytest.fixture
def meshes():
    """A 1-D and a 2-D mesh of this process alone (a gloo group of one on a
    HashStore), torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield {"1-D": tt.distributed.global_mesh(("batch",), device_type="cpu"),
               "2-D": tt.distributed.global_mesh(("batch", "rows"), shape=(1, 1),
                                                 device_type="cpu")}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("entry, mesh, error, match", [
    # mesh= takes a torch DeviceMesh (it raised "item 16" until the
    # multi-device slice was ported); ShardedRowSolver a 1-D one only
    ("BatchSolver", "object", TypeError, "DeviceMesh"),
    ("ShardedRowSolver", "object", TypeError, "DeviceMesh"),
    ("ShardedRowSolver", "2-D", ValueError, "requires a 1-D mesh"),
    ("ShardedRowSolver", None, ValueError, "requires a 1-D mesh"),
])
def test_unported_options_raise(entry, mesh, error, match, meshes):
    P, q, A, b, cones = _tiny_qp()
    mesh = object() if mesh == "object" else meshes.get(mesh)
    settings = tt.DefaultSettings(verbose=False)
    with pytest.raises(error, match=match):
        if entry == "BatchSolver":
            P, q, A, b = (np.stack([v, v]) for v in (P, q, A, b))
            tt.BatchSolver(P, q, A, b, cones, settings, mesh=mesh)
        else:
            tt.ShardedRowSolver(P, q, A, b, cones, settings, mesh=mesh)


@pytest.mark.parametrize("kwargs", [
    # f32 with a PSD cone, through "auto" and through a dense LU (these
    # raised until the double-float PSD scaling was ported)
    _f32("auto"), dict(batch=True, **_f32("lu")),
])
def test_f32_psd_options_solve(kwargs):
    _solved_like_f64(kwargs, _psd2)


@pytest.mark.parametrize("psd", [False, True], ids=["qp", "psd"])
def test_f32_multifrontal_options_solve(psd):
    """f32 on the sparse multifrontal path, the tiny QP and the PSD(2)
    problem (these raised until the compensated sparse refinement was
    ported)."""
    _solved_like_f64(_f32("multifrontal"), _psd2 if psd else None)


def _solved_like_f64(kwargs, make=None):
    """Solve ``make()``'s problem (the tiny QP) with ``kwargs`` at f32 and
    at f64 through "auto"; both Solved (every lane of a batch), the
    objectives within 1e-3 relative (the f32 gate of chip_smoke.py phase
    3c)."""
    P, q, A, b, cones = (make or _tiny_qp)()
    kwargs = dict(kwargs)
    cones = kwargs.pop("cones", cones)
    batch = kwargs.pop("batch", False)
    f64 = dict(settings=tt.DefaultSettings(verbose=False))
    if batch:
        P, q, A, b = (np.stack([v, v]) for v in (P, q, A, b))
        solve = lambda kw: tt.BatchSolver(P, q, A, b, cones, device="cpu", **kw).solve()
        got, ref = solve(kwargs), solve(f64)
        assert got.statuses() == ref.statuses() == [tt.SolverStatus.Solved] * 2
    else:
        solve = lambda kw: tt.DefaultSolver(P, q, A, b, cones, device="cpu", **kw).solve()
        got, ref = solve(kwargs), solve(f64)
        assert got.status == ref.status == tt.SolverStatus.Solved
    assert np.all(np.abs(got.obj_val - ref.obj_val) <= 1e-3 * np.maximum(1.0, np.abs(ref.obj_val)))


@pytest.mark.parametrize("kwargs", [
    # f32 through every dense KKT method (these raised until the compensated
    # f32 stack was ported)
    _f32("lu"), _f32("pallas"), _f32("schur"),
    # BatchSolver: a batch of two copies of the same problem; it runs
    # "multifrontal" as dense LU, as the JAX package's does
    dict(batch=True, **_f32("lu")), dict(batch=True, **_f32("multifrontal")),
    # f32 on a nonsymmetric layout: "auto" resolves to "lu" there
    dict(batch=True, cones=[tt.ZeroConeT(1), tt.NonnegativeConeT(1),
                            tt.GenPowerConeT([0.5, 0.5], 1)], **_f32("auto")),
])
def test_f32_dense_options_solve(kwargs):
    _solved_like_f64(kwargs)


@pytest.mark.parametrize("entry", ["SparseBatchSolver mesh", "BatchSolver mesh"])
def test_unported_entry_points_raise(entry, meshes):
    """The batch solvers over a mesh (they raised until the multi-device
    slice was ported): on a 1-D mesh of one rank each solves the whole
    batch, bit for bit as without a mesh, and reports no ``lanes``; a mesh
    that is not a DeviceMesh raises."""
    P, q, A, b, cones = _tiny_qp()
    settings = tt.DefaultSettings(verbose=False)
    if entry.startswith("SparseBatchSolver"):
        args = (sp.csc_matrix(P), np.stack([q, q]), sp.csc_matrix(A), np.stack([b, b]), cones,
                settings)
        make = tt.SparseBatchSolver
    else:
        args = (*(np.stack([v, v]) for v in (P, q, A, b)), cones, settings)
        make = tt.BatchSolver
    with pytest.raises(TypeError, match="DeviceMesh"):
        make(*args, mesh=object())
    got = make(*args, mesh=meshes["1-D"]).solve()
    ref = make(*args, device="cpu").solve()
    assert got.lanes is None and got.statuses() == [tt.SolverStatus.Solved] * 2
    np.testing.assert_array_equal(got.x, ref.x)
    np.testing.assert_array_equal(got.z, ref.z)


def test_f32_sparse_batch_solves():
    """SparseBatchSolver(dtype="float32") (it raised until the compensated
    sparse refinement was ported): two copies of the tiny QP, each lane
    Solved within 1e-3 relative of the f64 batch's."""
    P, q, A, b, cones = _tiny_qp()
    args = (sp.csc_matrix(P), np.stack([q, q]), sp.csc_matrix(A), np.stack([b, b]), cones)
    got = tt.SparseBatchSolver(*args, tt.DefaultSettings.for_float32(verbose=False),
                               dtype="float32", device="cpu").solve()
    ref = tt.SparseBatchSolver(*args, tt.DefaultSettings(verbose=False), device="cpu").solve()
    assert got.statuses() == ref.statuses() == [tt.SolverStatus.Solved] * 2
    assert got.x.dtype == np.float32
    assert np.all(np.abs(got.obj_val - ref.obj_val) <= 1e-3 * np.maximum(1.0, np.abs(ref.obj_val)))


def test_load_from_file_float32_lu_solves(tmp_path):
    """A problem file loads at f32 and solves through "lu" (the double-float
    LU; this raised until the compensated f32 stack was ported), within 1e-3
    of the f64 solve of the same file."""
    _load_and_solve_f32(_tiny_qp(), tmp_path)


def test_load_from_file_float32_psd_solves(tmp_path):
    """The same for a PSD problem (this raised until the double-float PSD
    scaling was ported)."""
    _load_and_solve_f32(_psd2(), tmp_path)


def _load_and_solve_f32(problem, tmp_path):
    P, q, A, b, cones = problem
    s = tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(
        verbose=False, direct_solve_method="lu"), device="cpu")
    ref = s.solve()
    s.save_to_file(tmp_path / "problem.json")
    got = tt.DefaultSolver.load_from_file(tmp_path / "problem.json", dtype="float32",
                                          device="cpu").solve()
    assert got.status == ref.status == tt.SolverStatus.Solved
    assert abs(got.obj_val - ref.obj_val) <= 1e-3 * max(1.0, abs(ref.obj_val))


def test_batch_solver_defaults_to_cuda_and_has_no_time_limit(monkeypatch):
    P, q, A, b, cones = (np.stack([v, v]) if isinstance(v, np.ndarray) else v
                         for v in _tiny_qp())
    with pytest.raises(ValueError, match="time limit"):
        tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(time_limit=10.0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False))


def test_sparse_batch_solver_defaults_to_cuda_and_has_no_time_limit(monkeypatch):
    P, q, A, b, cones = _tiny_qp()
    args = (sp.csc_matrix(P), np.stack([q, q]), sp.csc_matrix(A), np.stack([b, b]), cones)
    with pytest.raises(ValueError, match="time limit"):
        tt.SparseBatchSolver(*args, tt.DefaultSettings(time_limit=10.0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.SparseBatchSolver(*args, tt.DefaultSettings(verbose=False))


@pytest.mark.parametrize("method", ["auto", "lu", "pallas"])
def test_f32_psd_cones_solve(method):
    """The PSD cone at f32 through each dense route: "auto" and "lu" the
    double-float LU with K_lo, "pallas" the LDLᵀ's f32 twin with the
    (K, K_lo) refinement (these raised until the double-float PSD scaling
    was ported)."""
    _solved_like_f64(_f32(method), _psd2)


@pytest.mark.parametrize("cone, kwargs", [
    # the exponential and power cones at f32 (they raised until the
    # compensated f32 stack was ported): "auto" resolves to the
    # double-float LU, "pallas" runs the LDLᵀ's f32 twin
    (api.ExponentialConeT(), _f32("auto")),
    (api.PowerConeT(0.3), _f32("pallas")),
])
def test_f32_nonsymmetric_cones_solve(cone, kwargs):
    """min ½|x|² - x₁ - x₂ with the cone active at the optimum and a
    strictly feasible point (x = 0): s = (x₁, 1, 3 - x₂) in the
    exponential cone (e^x₁ ≤ 3 - x₂), s = (1 - x₁, 1 - x₂, x₁ + x₂) in the
    power cone.  (The raising case's A = 1, b = 1 keeps s on the cone's
    boundary, a problem without an interior.)"""
    if cone.kind == api.EXP:
        A, b = np.array([[-1.0, 0.0], [0.0, 0.0], [0.0, 1.0]]), np.array([0.0, 1.0, 3.0])
    else:
        A, b = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]]), np.array([1.0, 1.0, 0.0])
    _solved_like_f64(dict(cones=[cone], **kwargs),
                     lambda: (np.eye(2), -np.ones(2), A, b, [cone]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sparse_auto_route_solves(dtype):
    """A problem past the sparse route's size gate: "auto" sends it to the
    multifrontal engine, which solves it, at f64 and (since the compensated
    sparse refinement was ported; it raised before) at f32."""
    n = 3000
    eye = sp.eye(n, format="csc")
    cones = [tt.NonnegativeConeT(n)]
    make = tt.DefaultSettings.for_float32 if dtype == "float32" else tt.DefaultSettings
    s = tt.DefaultSolver(eye, np.ones(n), eye, np.ones(n), cones, make(verbose=False),
                         dtype=dtype, device="cpu")
    assert s.info.linear_solver.name == "multifrontal" and s.info.linear_solver.dim == 2 * n
    assert s.solve().status == tt.SolverStatus.Solved
    # min ½|x|² + Σx, x <= 1
    assert np.allclose(s.solution.x, -1.0, atol=1e-7 if dtype == "float64" else 1e-4)


def test_convert_round_trips_settings_and_cones():
    s = ct.DefaultSettings(max_iter=17, direct_solve_method="pallas",
                           dynamic_regularization_enable=False)
    ported = convert.settings_from_dict(dataclasses.asdict(s))
    assert dataclasses.asdict(ported) == dataclasses.asdict(s)
    with pytest.raises(ValueError):
        convert.settings_from_dict({"no_such_setting": 1})
    cones = [ct.ZeroConeT(1), ct.SecondOrderConeT(3), ct.PowerConeT(0.25),
             ct.GenPowerConeT([0.5, 0.5], 2), ct.PSDTriangleConeT(4)]
    got = convert.cones_from_specs(convert.cone_specs(cones))
    assert [(c.kind, c.dim, c.alpha, c.dim2) for c in got] == \
        [(c.kind, c.dim, c.alpha, c.dim2) for c in cones]


def test_ldl_factor_counts_only_kernel_launches():
    before = dict(pallas_ldl.ldl_factor.launches)
    K = torch.eye(4, dtype=torch.float64)
    (kind, (packed, N)), ok = pallas_ldl.ldl_factor(K, 2, 2, tt.DefaultSettings())
    assert kind == "pldl" and N == 4 and bool(ok)
    assert pallas_ldl.ldl_factor.launches == before  # the CPU takes the plain version
    with pytest.raises(ValueError):
        pallas_ldl.ldl_factor(K, 2, 2, tt.DefaultSettings(), variant="no_such_variant")
    with pytest.raises(RuntimeError, match="no LDL kernel"):
        pallas_ldl.ldl_factor(K.to("meta"), 2, 2, tt.DefaultSettings())

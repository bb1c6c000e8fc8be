"""Boundaries of clarabel_tpu_torch: it never imports JAX or the JAX
package, it runs on CUDA unless told otherwise, and what it does not port
yet raises instead of taking another path."""

import ast
import dataclasses
import os
import pathlib
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
    ROOT / "scripts" / "ab_unblocked_kernel.py"]


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


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, q, A, b, cones = _tiny_qp()
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.DefaultSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False))


def _f32(method):
    return dict(dtype="float32", settings=tt.DefaultSettings.for_float32(
        verbose=False, direct_solve_method=method))


@pytest.mark.parametrize("kwargs, item", [
    # f32 runs only through the structured Schur paths
    (_f32("lu"), "item 12b"),
    (_f32("pallas"), "item 12b"),
    (_f32("schur"), "item 12b"),
    (dict(settings=tt.DefaultSettings(direct_solve_method="multifrontal")), "item 14"),
    # BatchSolver: a batch of two copies of the same problem
    (dict(batch=True, **_f32("lu")), "item 12b"),
    (dict(batch=True, mesh=object()), "item 16"),
    # f32 on a nonsymmetric layout: "auto" resolves to "lu" there
    (dict(batch=True, cones=[tt.ZeroConeT(1), tt.NonnegativeConeT(1),
                             tt.GenPowerConeT([0.5, 0.5], 1)], **_f32("auto")), "item 12b"),
])
def test_unported_options_raise(kwargs, item):
    P, q, A, b, cones = _tiny_qp()
    kwargs = dict(kwargs)
    kwargs.setdefault("settings", tt.DefaultSettings(verbose=False))
    cones = kwargs.pop("cones", cones)
    with pytest.raises(NotImplementedError, match=item):
        if kwargs.pop("batch", False):
            P, q, A, b = (np.stack([v, v]) for v in (P, q, A, b))
            tt.BatchSolver(P, q, A, b, cones, device="cpu", **kwargs).solve()
        else:
            tt.DefaultSolver(P, q, A, b, cones, device="cpu", **kwargs)


def test_batch_solver_defaults_to_cuda_and_has_no_time_limit(monkeypatch):
    P, q, A, b, cones = (np.stack([v, v]) if isinstance(v, np.ndarray) else v
                         for v in _tiny_qp())
    with pytest.raises(ValueError, match="time limit"):
        tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(time_limit=10.0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings(verbose=False))


@pytest.mark.parametrize("cone, kwargs, item", [
    # the PSD, exponential and power cones run at f64 only
    (api.PSDTriangleConeT(2), _f32("auto"), "item 12b"),
    (api.ExponentialConeT(), _f32("auto"), "item 12b"),
    (api.PowerConeT(0.3), _f32("pallas"), "item 12b"),
])
def test_unported_cones_raise(cone, kwargs, item):
    m = cone.nvars
    kwargs = dict(kwargs)
    settings = kwargs.pop("settings", tt.DefaultSettings(verbose=False))
    with pytest.raises(NotImplementedError, match=item):
        tt.DefaultSolver(np.eye(2), np.ones(2), np.ones((m, 2)), np.ones(m), [cone],
                         settings, device="cpu", **kwargs)


def test_sparse_auto_route_raises():
    n = 3000
    eye = sp.eye(n, format="csc")
    with pytest.raises(NotImplementedError, match="item 14"):
        tt.DefaultSolver(eye, np.ones(n), eye, np.ones(n), [tt.NonnegativeConeT(n)],
                         tt.DefaultSettings(verbose=False), device="cpu")


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

"""The port's C ABI (``include/clarabel_tpu.h`` over
``clarabel_tpu_torch/capi/capi.cpp``) against the JAX package's
(``native/capi.cpp``): the mirrors of tests/test_capi.py, each problem
solved through both shims in this process (each detects the live
interpreter and skips embedding), the port's on the CPU through the
settings JSON's ``"device": "cpu"``, and held to the JAX shim's result;
and the standalone embedding through the port's C driver.

Both shims are built once for the module into ``build/``: the port's by
``capi_support.build_library``, the JAX package's from ``native/capi.cpp``
with the same flags (its Makefile's).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from clarabel_tpu_torch import capi_support
from clarabel_tpu_torch.kkt import build

_JAX_SOURCE = capi_support.ROOT / "native" / "capi.cpp"

PORT_SETTINGS = '{"verbose": false, "device": "cpu"'
JAX_SETTINGS = '{"verbose": false'


class _Cone(ctypes.Structure):
    _fields_ = [
        ("tag", ctypes.c_uint8),
        ("dim", ctypes.c_int64),
        ("power", ctypes.c_double),
        ("alpha", ctypes.POINTER(ctypes.c_double)),
        ("nalpha", ctypes.c_int64),
    ]


class _Info(ctypes.Structure):
    _fields_ = [
        ("status", ctypes.c_int32),
        ("iterations", ctypes.c_int32),
        ("obj_val", ctypes.c_double),
        ("obj_val_dual", ctypes.c_double),
        ("solve_time", ctypes.c_double),
        ("r_prim", ctypes.c_double),
        ("r_dual", ctypes.c_double),
    ]


# int32_t (*)(const clarabel_info *info, void *user_data)
_CB = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.POINTER(_Info), ctypes.c_void_p)


def _declare(L):
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    L.clarabel_new.restype = ctypes.c_void_p
    L.clarabel_new.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, f64p,
        i64p, i64p, f64p, f64p, ctypes.POINTER(_Cone), ctypes.c_int64,
        ctypes.c_char_p,
    ]
    L.clarabel_solve.restype = ctypes.c_int32
    L.clarabel_solve.argtypes = [ctypes.c_void_p, f64p, f64p, f64p, ctypes.POINTER(_Info)]
    L.clarabel_update.restype = ctypes.c_int32
    L.clarabel_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f64p, ctypes.c_int64]
    L.clarabel_free.argtypes = [ctypes.c_void_p]
    L.clarabel_last_error.restype = ctypes.c_char_p
    L.clarabel_set_termination_callback.restype = ctypes.c_int32
    L.clarabel_set_termination_callback.argtypes = [ctypes.c_void_p, _CB, ctypes.c_void_p]
    L.clarabel_iteration_history_len.restype = ctypes.c_int64
    L.clarabel_iteration_history_len.argtypes = [ctypes.c_void_p]
    L.clarabel_iteration_history.restype = ctypes.c_int64
    L.clarabel_iteration_history.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64]
    return L


@pytest.fixture(scope="module")
def libs():
    """{"port": the port's shim, "jax": the JAX package's}, each with its
    settings prefix.  The JAX package's shim is built from its source with
    the port's flags (those of its Makefile) into build/, by an atomic
    rename, so no test worker loads it half written."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C toolchain for the C ABI")
    path, _, _ = capi_support.build_library()
    flags, link = capi_support.embed_flags()
    jax_path, _, _ = build.compile_shared(gxx, _JAX_SOURCE, flags, link,
                                          deps=(capi_support.HEADER,))
    return {"port": (_declare(ctypes.CDLL(str(path))), PORT_SETTINGS),
            "jax": (_declare(ctypes.CDLL(str(jax_path))), JAX_SETTINGS)}


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _csc(M):
    C = sp.csc_matrix(M)
    C.sort_indices()
    return (np.asarray(C.indptr, np.int64), np.asarray(C.indices, np.int64),
            np.asarray(C.data, np.float64))


def _settings(prefix, extra=""):
    return (prefix + extra + "}").encode()


def _new(lib, prefix, P, q, A, b, cones, extra=""):
    Pp, Pi, Px = _csc(np.triu(P))
    Ap, Ai, Ax = _csc(A)
    return lib.clarabel_new(P.shape[0], A.shape[0], _i64p(Pp), _i64p(Pi), _f64p(Px),
                            _f64p(q), _i64p(Ap), _i64p(Ai), _f64p(Ax), _f64p(b),
                            cones, len(cones), _settings(prefix, extra))


def basic_qp():
    # reference tests/basic_qp.rs feasible problem (tests/test_basic_qp.py:qp_data)
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A1 = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    A = np.vstack([-A1, A1])
    b = np.array([-1.0, 0.0, 0.0, 1.0, 0.7, 0.7])
    cones = (_Cone * 2)(_Cone(1, 3, 0.0, None, 0), _Cone(1, 3, 0.0, None, 0))
    return P, q, A, b, cones


def _solve(lib, h, n, m):
    x, z, s = np.zeros(n), np.zeros(m), np.zeros(m)
    info = _Info()
    status = lib.clarabel_solve(h, _f64p(x), _f64p(z), _f64p(s), ctypes.byref(info))
    assert status >= 0, lib.clarabel_last_error().decode()
    return dict(status=status, iterations=info.iterations, obj=info.obj_val,
                obj_dual=info.obj_val_dual, x=x, z=z, s=s)


def assert_same(got, ref):
    """The port's result of a C-ABI solve against the JAX shim's: the same
    status and iteration count, x, z and s within 1e-7 of the reference's
    inf-norm (at least 1) and the objectives within 1e-9 relative (the
    parity contract of tests/_torch_parity.py for a Solved problem)."""
    assert got["status"] == ref["status"]
    assert got["iterations"] == ref["iterations"]
    for v in ("x", "z", "s"):
        scale = max(1.0, float(np.max(np.abs(ref[v]), initial=0.0)))
        assert np.max(np.abs(got[v] - ref[v]), initial=0.0) <= 1e-7 * scale, v
    for v in ("obj", "obj_dual"):
        assert abs(got[v] - ref[v]) <= 1e-9 * max(1.0, abs(ref[v])), v


def _both(libs, run):
    return {name: run(lib, prefix) for name, (lib, prefix) in libs.items()}


# ---------------------------------------------------------------------------
# mirrors of tests/test_capi.py


def test_capi_basic_qp(libs):
    def run(lib, prefix):
        h = _new(lib, prefix, *basic_qp())
        assert h, lib.clarabel_last_error().decode()
        out = _solve(lib, h, 2, 6)
        lib.clarabel_free(h)
        return out

    out = _both(libs, run)
    got = out["port"]
    assert got["status"] == 1  # Solved
    # reference oracle: obj = 1.88, x = (0.3, 0.7)  (basic_qp.rs:110-116)
    assert abs(got["obj"] - 1.88) < 1e-6
    np.testing.assert_allclose(got["x"], [0.3, 0.7], atol=1e-6)
    assert got["iterations"] > 0
    assert_same(got, out["jax"])


def test_capi_update_and_resolve(libs):
    def run(lib, prefix):
        h = _new(lib, prefix, *basic_qp())
        first = _solve(lib, h, 2, 6)
        # update b (data_updating.rs form): loosen the box
        b2 = np.array([-1.0, 0.0, 0.0, 1.0, 0.9, 0.9])
        assert lib.clarabel_update(h, b"b", _f64p(b2), 6) == 0
        # and q
        q2 = np.array([1.0, 0.5])
        assert lib.clarabel_update(h, b"q", _f64p(q2), 2) == 0
        second = _solve(lib, h, 2, 6)
        lib.clarabel_free(h)
        return first, second

    out = _both(libs, run)
    (first, second), (ref_first, ref_second) = out["port"], out["jax"]
    assert first["status"] == second["status"] == 1
    assert second["obj"] < first["obj"] + 1e-9
    assert_same(first, ref_first)
    assert_same(second, ref_second)


def test_capi_settings_json(libs):
    def run(lib, prefix):
        h = _new(lib, prefix, *basic_qp(), extra=', "max_iter": 1')
        out = _solve(lib, h, 2, 6)
        lib.clarabel_free(h)
        return out

    out = _both(libs, run)
    assert out["port"]["status"] == out["jax"]["status"] == 7  # MaxIterations
    assert out["port"]["iterations"] == out["jax"]["iterations"] == 1


def test_capi_error_reporting(libs):
    # mismatched cone dims must fail cleanly with a message, not crash
    def run(lib, prefix):
        cones = (_Cone * 1)(_Cone(1, 7, 0.0, None, 0))  # wrong total dim
        h = _new(lib, prefix, np.eye(2), np.zeros(2), np.eye(2), np.zeros(2), cones)
        assert not h
        return lib.clarabel_last_error().decode()

    out = _both(libs, run)
    assert out["port"] and out["port"] == out["jax"]


def test_capi_device_defaults_to_cuda(libs, monkeypatch):
    """Without a "device" key the port's shim asks for the card: with none
    it fails cleanly, naming CUDA."""
    lib, _ = libs["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = _new(lib, '{"verbose": false', *basic_qp())
    assert not h
    assert "CUDA" in lib.clarabel_last_error().decode()


def test_capi_standalone_embedding(libs):
    """Compile and run the port's C driver against its shim -- no Python
    process anywhere in the caller -- on the CPU, and hold what it prints
    to the JAX shim's solve of the same problem."""
    lib, _ = libs["port"]
    exe = capi_support.build_driver(capi_support.build_library()[0])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # standalone: only the compiled-in root
    out = subprocess.run([str(exe), "cpu"], capture_output=True, timeout=600, env=env,
                         cwd=os.path.dirname(str(exe)))
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    text = out.stdout.decode()
    assert "status=1 obj=1.88" in text and "callback status=11" in text
    iters = int(re.search(r"iters=(\d+)", text).group(1))
    jax_lib, prefix = libs["jax"]
    h = _new(jax_lib, prefix, *basic_qp())
    assert iters == _solve(jax_lib, h, 2, 6)["iterations"]
    jax_lib.clarabel_free(h)


def test_capi_termination_callback(libs):
    """Cancel a solve mid-run through the C fn-ptr callback and observe
    CALLBACK_TERMINATED (reference: callbacks.rs:7-97 — the C callback
    with user data, checked each iteration)."""

    def run(lib, prefix):
        h = _new(lib, prefix, *basic_qp())
        seen = []

        @_CB
        def stop_after_two(info_p, user_data):
            info = info_p.contents
            seen.append((info.iterations, info.status, info.solve_time, info.obj_val))
            return 1 if info.iterations >= 2 else 0

        assert lib.clarabel_set_termination_callback(h, stop_after_two, None) == 0
        stopped = _solve(lib, h, 2, 6)
        # clearing the callback restores the normal path
        assert lib.clarabel_set_termination_callback(h, ctypes.cast(None, _CB), None) == 0
        full = _solve(lib, h, 2, 6)
        nrows = lib.clarabel_iteration_history_len(h)
        buf = np.zeros((max(nrows, 1), 9))
        got = lib.clarabel_iteration_history(h, _f64p(buf), nrows)
        lib.clarabel_free(h)
        return seen, stopped, full, nrows, got, buf[:got]

    out = _both(libs, run)
    seen, stopped, full, nrows, got, hist = out["port"]
    r_seen, r_stopped, r_full, r_nrows, _, r_hist = out["jax"]
    assert stopped["status"] == 11  # CallbackTerminated
    # the callback saw in-progress snapshots: UNSOLVED status, iteration
    # counter advancing, elapsed time monotone; the JAX shim's saw the same
    # iterations and objectives
    assert seen and seen[-1][0] >= 2
    assert all(st == 0 for _, st, _, _ in seen)
    assert all(b[2] >= a[2] for a, b in zip(seen, seen[1:]))
    assert [s[0] for s in seen] == [s[0] for s in r_seen]
    np.testing.assert_allclose([s[3] for s in seen], [s[3] for s in r_seen], rtol=1e-9)
    assert full["status"] == 1
    assert_same(full, r_full)
    # iteration history surface: full solve recorded > 2 rows, each row
    # 9 doubles, within the parity contract's history bound of the JAX
    # shim's (1e-6·|ref| + 1e-10)
    assert nrows == got == r_nrows > 2
    assert np.all(np.isfinite(hist))
    assert np.all(np.abs(hist - r_hist) <= 1e-6 * np.abs(r_hist) + 1e-10)


def test_capi_genpow_alpha_marshalling(libs):
    """GenPow cones cross the C ABI with an alpha vector (the tagged-union
    vec field, reference src/julia/types.rs ConeDataJLRS) — the same
    program as the sparse-path genpow case, solved through C."""
    alpha = np.array([0.5, 0.5])

    def run(lib, prefix):
        P = np.zeros((4, 4))
        q = np.array([0.0, 0.0, -1.0, 0.0])
        A = np.vstack([-np.eye(4), [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0]]])
        b = np.array([0, 0, 0, 0, 1.0, 1.0, 0.5])
        cones = (_Cone * 2)(
            _Cone(5, 2, 0.0, _f64p(alpha), 2),   # GenPow(alpha=[.5,.5], dim2=2)
            _Cone(0, 3, 0.0, None, 0),           # Zero(3)
        )
        h = _new(lib, prefix, P, q, A, b, cones)
        assert h, lib.clarabel_last_error().decode()
        out = _solve(lib, h, 4, 7)
        lib.clarabel_free(h)
        return out

    out = _both(libs, run)
    got = out["port"]
    assert got["status"] == 1
    # max x3 s.t. (1,1,(x3,0.5)) in GenPow(.5,.5): x3 = sqrt(1-0.25)
    assert abs(got["obj"] + np.sqrt(0.75)) < 1e-6
    assert_same(got, out["jax"])

"""Python-side glue for the C ABI (``capi/capi.cpp``).

The port's copy of ``clarabel_tpu/capi_support.py``.  The C library
embeds CPython and calls ONLY the functions in this module, with plain
types (memoryviews over caller buffers, ints, floats, str) — all object
construction and numpy/scipy handling stays here, keeping the C++ shim
minimal.  This mirrors the reference's C-callable layer (reference:
src/julia/interface.rs:55-130 solver_new/solve/get_info and
src/solver/implementations/default/ffi — a thin FFI over the native core;
here the "native core" is the PyTorch solver and the shim is C over
Python).  The shim implements ``include/clarabel_tpu.h`` unchanged, so a C
program switches between the JAX package and the port by linking the
other library.

Cone tags match ``include/clarabel_tpu.h`` (and the reference's
ConeEnumJLRS order, src/julia/types.rs): 0 Zero, 1 Nonnegative, 2 SOC,
3 Exp, 4 Pow, 5 GenPow, 6 PSDTriangle.

The solve runs on ``cuda`` unless the settings JSON carries
``"device": "cpu"`` (the C caller's counterpart of ``device="cpu"``).

:func:`build_library` compiles the shim with ``g++`` and the interpreter's
embedding flags at first use into ``build/clarabel_tpu_torch/``;
``python3 -m clarabel_tpu_torch.capi_support`` builds it and prints its
path.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np

from .cones import api as _ct
from .json_io import _settings_from_json
from .solver import DefaultSolver
from .statuses import SolverStatus

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "capi" / "capi.cpp"
DRIVER = Path(__file__).resolve().parent / "capi" / "example_capi.c"
HEADER = ROOT / "include" / "clarabel_tpu.h"


def _compiler(name: str) -> str:
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: the C ABI needs a C/C++ toolchain")
    return found


def embed_flags() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(compiler flags, link flags) of a shared library that embeds this
    interpreter: its headers and its ``libpython`` from sysconfig, as
    ``python3-config --embed`` gives them, and the package root compiled in
    (``CLARABEL_TPU_PYROOT`` overrides it at run time)."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("the C ABI embeds CPython and needs a shared libpython")
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = sysconfig.get_config_var("VERSION") + (sys.abiflags or "")
    flags = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared",
             f"-I{sysconfig.get_paths()['include']}", f"-I{ROOT / 'include'}",
             f'-DCLARABEL_TPU_ROOT="{ROOT}"')
    libs = (f"-L{libdir}", f"-lpython{pyver}", f"-Wl,-rpath,{libdir}",
            *(sysconfig.get_config_var("LIBS") or "").split(),
            *(sysconfig.get_config_var("SYSLIBS") or "").split())
    return flags, libs


def build_library() -> tuple[Path, float, str]:
    """Compile ``capi/capi.cpp`` with :func:`embed_flags` unless it is
    already built; (library path, build seconds, compiler output) as
    ``kkt.build.compile_shared``."""
    from .kkt import build

    flags, libs = embed_flags()
    return build.compile_shared(_compiler("g++"), SOURCE, flags, libs, deps=(HEADER,))


def build_driver(library: Path) -> Path:
    """Compile the standalone C driver ``capi/example_capi.c`` against the
    shim ``library`` (``gcc``), next to it; returns the executable."""
    digest = hashlib.sha256(DRIVER.read_bytes() + library.name.encode()).hexdigest()[:16]
    exe = library.with_name(f"example_capi_{digest}")
    if not exe.exists():
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        subprocess.run([_compiler("gcc"), "-O2", f"-I{ROOT / 'include'}", str(DRIVER),
                        "-o", str(tmp), str(library)],
                       check=True, capture_output=True, text=True)
        tmp.replace(exe)
    return exe


def _cones_from_tags(cones):
    out = []
    for tag, dim, power, alpha in cones:
        if tag == 0:
            out.append(_ct.ZeroConeT(dim))
        elif tag == 1:
            out.append(_ct.NonnegativeConeT(dim))
        elif tag == 2:
            out.append(_ct.SecondOrderConeT(dim))
        elif tag == 3:
            out.append(_ct.ExponentialConeT())
        elif tag == 4:
            out.append(_ct.PowerConeT(power))
        elif tag == 5:
            out.append(_ct.GenPowerConeT(list(alpha), dim))
        elif tag == 6:
            out.append(_ct.PSDTriangleConeT(dim))
        else:
            raise ValueError(f"unknown cone tag {tag}")
    return out


class Handle:
    """What the C side holds: the solver plus the user-frame dims (the
    solver's own ``m`` is the internal post-presolve/augmented count)."""

    __slots__ = ("solver", "n", "m", "solve_t0")

    def __init__(self, solver, n, m):
        self.solver = solver
        self.n = n
        self.m = m
        self.solve_t0 = None


def new_solver(n, m, Pp, Pi, Px, q, Ap, Ai, Ax, b, cones, settings_json):
    """Build a DefaultSolver from CSC buffers.

    ``Pp/Pi/Ap/Ai`` are int64 memoryviews (colptr/rowval), ``Px/Ax/q/b``
    f64 memoryviews.  ``cones`` is a list of (tag, dim, power, alpha-tuple).
    ``settings_json`` holds DefaultSettings overrides and two keys of the
    C ABI's own: ``"dtype"`` ("float64" by default) and ``"device"``
    ("cuda" by default; "cpu" runs the solve on the host).
    Returns a :class:`Handle` (the C side holds it as an opaque pointer).
    """
    import scipy.sparse as sp

    def csc(indptr, indices, data, rows, cols):
        return sp.csc_matrix(
            (
                np.frombuffer(data, np.float64).copy(),
                np.frombuffer(indices, np.int64).copy(),
                np.frombuffer(indptr, np.int64).copy(),
            ),
            shape=(rows, cols),
        )

    P = csc(Pp, Pi, Px, n, n)
    # the C ABI takes upper-triangle P like the reference; symmetrize
    P = (P + P.T) - sp.diags(P.diagonal())
    A = csc(Ap, Ai, Ax, m, n)
    qv = np.frombuffer(q, np.float64).copy()
    bv = np.frombuffer(b, np.float64).copy()

    d = json.loads(settings_json) if settings_json else {}
    dtype = d.pop("dtype", "float64")
    device = d.pop("device", None)  # None: the constructor's default, the card
    settings = _settings_from_json(d)
    solver = DefaultSolver(
        P, qv, A, bv, _cones_from_tags(cones), settings, dtype=dtype, device=device
    )
    return Handle(solver, int(n), int(m))


def solve_into(handle, x_mv, z_mv, s_mv):
    """Solve and write the (unscaled) solution into caller buffers.

    Returns (status:int, obj_val, obj_val_dual, solve_time, iterations,
    r_prim, r_dual) — the InfoJLRS analog tuple."""
    import time

    handle.solve_t0 = time.perf_counter()
    sol = handle.solver.solve()
    np.frombuffer(x_mv, np.float64)[:] = np.asarray(sol.x, np.float64)
    np.frombuffer(z_mv, np.float64)[:] = np.asarray(sol.z, np.float64)
    np.frombuffer(s_mv, np.float64)[:] = np.asarray(sol.s, np.float64)
    return (
        int(sol.status),
        float(sol.obj_val),
        float(sol.obj_val_dual),
        float(sol.solve_time),
        int(sol.iterations),
        float(sol.r_prim),
        float(sol.r_dual),
    )


def update(handle, which, vals):
    """Data updating through the C ABI (reference: the update_P/A/q/b
    family, src/solver/implementations/default/data_updating.rs)."""
    v = np.frombuffer(vals, np.float64).copy()
    getattr(handle.solver, f"update_{which}")(v)


def set_termination_callback_c(handle, trampoline):
    """Install a C termination callback (reference: callbacks.rs:7-97,
    the SolverTerminationCallbackFFI variant).  ``trampoline`` is a
    PyCFunction wrapping the caller's fn-ptr + user_data; it takes the
    in-progress info scalars and returns True to stop the solve."""
    import time

    def cb(info):
        elapsed = (
            time.perf_counter() - handle.solve_t0
            if handle.solve_t0 is not None
            else 0.0
        )
        return bool(
            trampoline(
                int(info.iterations),
                float(info.cost_primal),
                float(info.cost_dual),
                float(info.res_primal),
                float(info.res_dual),
                float(elapsed),
            )
        )

    handle.solver.set_termination_callback(cb)


def unset_termination_callback(handle):
    handle.solver.unset_termination_callback()


def _history_rows(handle):
    hist = getattr(handle.solver, "iteration_history", None)
    if hist is None:
        return np.zeros((0, 9))
    hist = np.asarray(hist, np.float64)
    if hist.ndim != 2 or hist.size == 0:
        return np.zeros((0, 9))
    valid = ~np.all(np.isnan(hist), axis=1)
    nrows = int(np.max(np.nonzero(valid)[0]) + 1) if valid.any() else 0
    return hist[:nrows]


def iteration_history_len(handle):
    return _history_rows(handle).shape[0]


def iteration_history_into(handle, out_mv, max_rows):
    rows = _history_rows(handle)[: int(max_rows)]
    flat = np.frombuffer(out_mv, np.float64)
    flat[: rows.size] = rows.ravel()
    return rows.shape[0]


def status_name(code):
    return SolverStatus(code).name


def print_timers(handle):
    handle.solver.print_timers()


if __name__ == "__main__":
    print(build_library()[0])

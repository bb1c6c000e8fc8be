"""Build and bind the hand-written CUDA kernels of ``kkt/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``: a build of seconds, with no
PyTorch headers.  The library goes into ``build/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import: the
first call of :func:`library` builds.  The port's host libraries (the
native symbolic engine, ``native.py``, and the C ABI's shim,
``capi_support.py``) compile with ``g++`` through the same
:func:`compile_shared`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "clarabel_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ldl.cu": {
    # K, sign, sign stride (0 or N), B, N, j0, shared-memory bytes, eps, delta, stream
    "ldl_unblocked_f64": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_double, ctypes.c_double, _P),
    "ldl_unblocked_f32": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P),
    "ldl_smem_capacity": (),
    "ldl_smem_max_cols": (),
    "ldl_blocked_f64": (_P, _P, _P, _P, _I, _I, ctypes.c_double, ctypes.c_double, _P),
    "ldl_blocked_f32": (_P, _P, _P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P),
    "ldl_panel_width": (),
}, "df_lu.cu": {
    # K_hi, K_lo (or null), s, Ah, Al, perm, ok, B, N, delta, threads,
    # shared-memory bytes, stream
    "df_lu_factor": (_P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P),
    # Ah, Al, perm, s, rhs, out, B, N, R, rc, shared-memory bytes, stream
    "df_lu_solve": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "df_lu_smem_capacity": (),
    # the kernels the factor entry points have launched so far
    "df_lu_factor_kernels": (),
    # the grid forms (N > 512): as above, with the scratch and its floats
    # per matrix after ok (factor) and out (solve), and no launch shape
    "df_lu_factor_grid": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    "df_lu_solve_grid": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}}
#: the entry points only a build with -DDF_LU_PROFILE has, never the one
#: :func:`library` loads (the factor's cycle counters: scripts/df_lu_phases.py)
PROFILE_SIGNATURES = {"df_lu.cu": {"df_lu_profile_read": (_P,)}}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(src: Path, flags, deps=()) -> tuple[Path, Path]:
    """(library, compiler log) paths of ``src`` built with ``flags``, named by
    a hash of the source, the files it includes (``deps``) and the flags."""
    data = src.read_bytes() + b"".join(Path(d).read_bytes() for d in deps)
    digest = hashlib.sha256(data + " ".join(flags).encode())
    stem = f"{src.stem}_{digest.hexdigest()[:16]}"
    return BUILD_DIR / f"lib{stem}.so", BUILD_DIR / f"{stem}.log"


def compile_shared(compiler: str, src: Path, flags, libs=(), deps=()) -> tuple[Path, float, str]:
    """Compile ``src`` into a shared library under ``build/`` unless it is
    already built: ``compiler *flags -o lib src *libs``.

    Returns (library path, build seconds, compiler output); seconds is 0.0
    and the output the stored log when the library was already there.
    """
    lib, log = _target(src, (*flags, *libs), deps)
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [compiler, *flags, "-o", str(tmp), str(src), *libs],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed on {src.name}:\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, seconds, output


def build(source: str = "ldl.cu") -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` with ``nvcc`` unless its library is already
    built (:func:`compile_shared`)."""
    return compile_shared(_nvcc(), CSRC / source, NVCC_FLAGS)


def built(source: str = "ldl.cu") -> bool:
    """Whether ``csrc/<source>``'s library is already in ``build/``."""
    return _target(CSRC / source, NVCC_FLAGS)[0].exists()


def build_all() -> dict:
    """Compile every source of ``csrc/`` that ``library`` binds, one ``nvcc``
    each, all started together; returns {source: (library, seconds, compiler
    output)}."""
    with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        return dict(zip(_SIGNATURES, pool.map(build, _SIGNATURES)))


@functools.cache
def library(source: str = "ldl.cu") -> ctypes.CDLL:
    """The kernel library of ``csrc/<source>`` (the LDLᵀ kernels, or
    ``df_lu.cu``'s double-float LU), built at first use, with every entry
    point's argument and return types declared."""
    path, _, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib

"""Build and bind the hand-written CUDA kernels of ``kkt/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``: a build of seconds, with no
PyTorch headers.  The library goes into ``build/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import: the
first call of :func:`library` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "clarabel_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # K, sign, sign stride (0 or N), B, N, j0, shared-memory bytes, eps, delta, stream
    "ldl_unblocked_f64": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_double, ctypes.c_double, _P),
    "ldl_unblocked_f32": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P),
    "ldl_smem_capacity": (),
    "ldl_smem_max_cols": (),
    "ldl_blocked_f64": (_P, _P, _P, _P, _I, _I, ctypes.c_double, ctypes.c_double, _P),
    "ldl_blocked_f32": (_P, _P, _P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P),
    "ldl_panel_width": (),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(source: str = "ldl.cu") -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless its library is already built.

    Returns (library path, build seconds, compiler output); seconds is 0.0
    and the output the stored log when the library was already there.
    """
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = f"{src.stem}_{digest.hexdigest()[:16]}"
    lib = BUILD_DIR / f"lib{stem}.so"
    log = BUILD_DIR / f"{stem}.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, seconds, output


@functools.cache
def library() -> ctypes.CDLL:
    """The LDLᵀ kernel library, built at first use, with every entry
    point's argument and return types declared."""
    path, _, _ = build("ldl.cu")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib

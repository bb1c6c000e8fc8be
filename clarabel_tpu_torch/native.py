"""ctypes bindings for the native C++ symbolic engine.

The port's copy of ``clarabel_tpu/native.py``.  The reference solver links
native code for its graph/ordering work (the ``amd`` crate + QDLDL's
symbolic phase); here the equivalent lives in ``native/symbolic.cpp`` (the
port's own copy of the JAX package's source), compiled with ``g++`` at first
use into ``build/clarabel_tpu_torch/`` (named by a hash of the source, as
``kkt/build.py`` names the CUDA kernels' library) and loaded with ctypes.
The Python versions (``chordal/symbolic.py``, ``kkt/mf_symbolic.py``)
compute the same orderings, patterns and plans; they run where no compiler
exists.
"""

from __future__ import annotations

import ctypes
import shutil
import warnings
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

SOURCE = Path(__file__).resolve().parent / "native" / "symbolic.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def _load() -> Optional[ctypes.CDLL]:
    """The engine, built at first use; None where no ``g++`` exists (a
    build that fails warns, and the Python versions run)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True

    from .kkt import build

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    try:
        path, _, _ = build.compile_shared(gxx, SOURCE, GXX_FLAGS)
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as exc:
        warnings.warn(f"native symbolic engine unavailable: {exc}")
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cl_minimum_degree.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.cl_symbolic_count.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p]
    lib.cl_symbolic_pattern.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i64p, i64p]
    lib.cl_postorder_forest.argtypes = [ctypes.c_int64, i64p, i64p]
    lib.cl_amalgamate.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_double,
        u8p, i64p, i64p, i64p, i64p, i64p,
    ]
    for fn in (lib.cl_minimum_degree, lib.cl_symbolic_count, lib.cl_symbolic_pattern,
               lib.cl_postorder_forest, lib.cl_amalgamate):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def minimum_degree(n: int, adj: Sequence[Set[int]]) -> Optional[np.ndarray]:
    """Native minimum-degree ordering; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ptr = np.zeros(n + 1, np.int64)
    for v in range(n):
        ptr[v + 1] = ptr[v] + len(adj[v])
    idx = np.zeros(int(ptr[-1]), np.int64)
    pos = 0
    for v in range(n):
        for u in sorted(adj[v]):
            idx[pos] = u
            pos += 1
    perm = np.zeros(n, np.int64)
    lib.cl_minimum_degree(n, _p(ptr), _p(idx), _p(perm))
    return perm


def postorder_forest(parent: np.ndarray) -> Optional[np.ndarray]:
    """Native postorder of a forest given by its parent array (-1 at the
    roots); None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    parent = np.ascontiguousarray(parent, np.int64)
    post = np.zeros(parent.shape[0], np.int64)
    lib.cl_postorder_forest(parent.shape[0], _p(parent), _p(post))
    return post


def amalgamate(cols_ptr, cols_idx, rows_ptr, rows_idx, parent, post,
               max_cols: int, relax_frac: float):
    """Native relaxed supernode amalgamation (mf_symbolic._amalgamate's
    hot loop); returns (alive, cols_ptr, cols_idx, rows_ptr, rows_idx,
    parent) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_nodes = parent.shape[0]
    cols_ptr = np.ascontiguousarray(cols_ptr, np.int64)
    cols_idx = np.ascontiguousarray(cols_idx, np.int64)
    rows_ptr = np.ascontiguousarray(rows_ptr, np.int64)
    rows_idx = np.ascontiguousarray(rows_idx, np.int64)
    parent = np.ascontiguousarray(parent, np.int64)
    post = np.ascontiguousarray(post, np.int64)
    alive = np.zeros(n_nodes, np.uint8)
    ocp = np.zeros(n_nodes + 1, np.int64)
    oci = np.zeros(cols_idx.shape[0], np.int64)
    orp = np.zeros(n_nodes + 1, np.int64)
    ori = np.zeros(rows_idx.shape[0], np.int64)
    pout = np.zeros(n_nodes, np.int64)
    lib.cl_amalgamate(
        n_nodes, _p(cols_ptr), _p(cols_idx), _p(rows_ptr), _p(rows_idx),
        _p(parent), _p(post), int(max_cols), ctypes.c_double(relax_frac),
        alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _p(ocp), _p(oci), _p(orp), _p(ori), _p(pout),
    )
    return alive.astype(bool), ocp, oci, orp, ori, pout


def symbolic_factor_csc(n: int, col_ptr: np.ndarray, row_idx: np.ndarray):
    """Native symbolic Cholesky of a strictly-lower CSC pattern: (parent,
    L_ptr, L_idx), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    col_ptr = np.ascontiguousarray(col_ptr, np.int64)
    row_idx = np.ascontiguousarray(row_idx, np.int64)
    parent = np.zeros(n, np.int64)
    lnz = np.zeros(n, np.int64)
    lib.cl_symbolic_count(n, _p(col_ptr), _p(row_idx), _p(parent), _p(lnz))
    L_ptr = np.zeros(n + 1, np.int64)
    L_idx = np.zeros(int(lnz.sum()), np.int64)
    lib.cl_symbolic_pattern(n, _p(col_ptr), _p(row_idx), _p(parent), _p(L_ptr), _p(L_idx))
    return parent, L_ptr, L_idx


def symbolic_cholesky(
    n: int, lower_cols: Sequence[Set[int]]
) -> Optional[Tuple[List[List[int]], np.ndarray]]:
    """Native symbolic factorization; None if unavailable."""
    if _load() is None:
        return None
    ptr = np.zeros(n + 1, np.int64)
    for v in range(n):
        ptr[v + 1] = ptr[v] + len(lower_cols[v])
    idx = np.zeros(int(ptr[-1]), np.int64)
    pos = 0
    for v in range(n):
        for r in sorted(lower_cols[v]):
            idx[pos] = r
            pos += 1
    parent, out_ptr, out_idx = symbolic_factor_csc(n, ptr, idx)
    L_cols = [
        out_idx[out_ptr[j] : out_ptr[j + 1]].tolist() for j in range(n)
    ]
    return L_cols, parent

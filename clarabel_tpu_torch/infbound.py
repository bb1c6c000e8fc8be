"""Module-level infinity threshold.

reference: src/utils/infbounds.rs:13-36 — a process-global bound above which
constraint RHS entries are treated as +infinity (default 1e20).
"""

from __future__ import annotations

import threading

_DEFAULT_INFINITY = 1e20
_lock = threading.Lock()
_infinity = _DEFAULT_INFINITY


def get_infinity() -> float:
    return _infinity


def set_infinity(v: float) -> None:
    global _infinity
    if not (v > 0):
        raise ValueError("infinity bound must be positive")
    with _lock:
        _infinity = float(v)


def default_infinity() -> None:
    set_infinity(_DEFAULT_INFINITY)

"""Hierarchical wall-clock timers.

reference: src/timers/timers.rs — nested named timers with a printable tree.
CUDA work is asynchronous, so these measure host-visible time; device
profiles come from ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class _Node:
    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.children: Dict[str, "_Node"] = {}

    def child(self, name: str) -> "_Node":
        if name not in self.children:
            self.children[name] = _Node(name)
        return self.children[name]


class Timers:
    def __init__(self):
        self._root = _Node("")
        self._stack: List[_Node] = [self._root]

    @contextlib.contextmanager
    def scope(self, name: str):
        node = self._stack[-1].child(name)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            node.total += time.perf_counter() - t0
            self._stack.pop()

    def total_time(self, name: Optional[str] = None) -> float:
        if name is None:
            return sum(c.total for c in self._root.children.values())
        node = self._root.children.get(name)
        return node.total if node else 0.0

    def reset(self):
        self._root = _Node("")
        self._stack = [self._root]

    def print_tree(self):  # pragma: no cover - cosmetic
        def rec(node: _Node, depth: int):
            for c in node.children.values():
                print(f"{'  ' * depth}{c.name}: {c.total * 1e3:.3f} ms")
                rec(c, depth + 1)

        rec(self._root, 0)


def host_read(t):
    """``t.tolist()``: the host waits for the device and reads ``t`` (a
    Python bool for a 0-d bool tensor).  Every read of the device inside a
    solve goes through here, and ``host_read.count`` counts them (a caller
    sets it to 0 to count from there)."""
    host_read.count += 1
    return t.tolist()


host_read.count = 0

"""The collectives of the multi-device paths, in one place, counted.

The JAX package writes its collectives out by hand inside ``shard_map``
(``lax.psum``/``lax.pmax`` in ``clarabel_tpu/algebra/ell.py`` and
``clarabel_tpu/kkt/dense.py:prepare_schur_diag_rowsharded``); XLA lowers
them to all-reduces and all-gathers.  Here every collective of a sharded
solve goes through :func:`all_reduce` or :func:`all_gather`, which call
``torch.distributed`` on the process group the caller names and count what
they move: ``counts[kind]`` holds the calls and the bytes of the tensor
each rank holds afterwards, ``shapes`` the distinct shapes of those
tensors (the check that A is never gathered reads it).  Set the counts to
0 with :func:`reset` and read them with :func:`snapshot`, as
``timers.host_read`` counts the device reads.

Every rank receives the same bits from either collective (an all-reduce
reduces each element once, on one rank, and hands the result round), so
the replicated state of a sharded solve stays bitwise identical across
ranks and every host decision taken from it agrees.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: calls and bytes per kind of collective since the last :func:`reset`
counts = {"all_reduce": {"calls": 0, "bytes": 0}, "all_gather": {"calls": 0, "bytes": 0}}

#: the distinct (kind, shape) of every result since the last :func:`reset`
shapes = set()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset():
    """Set every count to 0 and forget the shapes."""
    for c in counts.values():
        c["calls"] = c["bytes"] = 0
    shapes.clear()


def snapshot():
    """A copy of the counts: {kind: {"calls": ..., "bytes": ...}}."""
    return {k: dict(v) for k, v in counts.items()}


def _count(kind, t):
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += t.numel() * t.element_size()
    shapes.add((kind, tuple(t.shape)))


def all_reduce(t, group, op="sum"):
    """A new tensor holding ``t`` reduced (``op`` "sum" or "max") over the
    ranks of ``group``; ``t`` itself is left as it was."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    _count("all_reduce", out)
    return out


def all_gather(t, group):
    """The blocks ``t [..., k]`` of every rank of ``group``, joined in rank
    order along the last dimension: ``[..., world·k]``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=-1)
    _count("all_gather", out)
    return out

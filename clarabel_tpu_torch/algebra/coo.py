"""COO sparse matrix on torch tensors, with a DIA fast path for products.

PyTorch port of ``clarabel_tpu/algebra/coo.py``: the stand-in for the
reference's ``CscMatrix`` compute role (reference:
src/algebra/csc/matrix_math.rs gemv/symv).  The matrix is a flat triplet
set and every product is one gather and one segment sum.

When the pattern has a compact set of diagonal offsets (banded P,
stacked-identity A), :meth:`COOMat.predia` lays the values out by diagonal
once per solve, and every later product -- transposed ones included -- is
``y = Σ_o d_o ⊙ shift(x, o)`` with fixed shifts.  Patterns without a
compact offset set keep the segment path (``dia_offsets is None``).

The segment sums add in a fixed order, as the port's cone segment sums do
(``cones.ops._segment_sum``): each segment's entries are gathered into a
padded row and summed along it, in chunks of ``_SEG_WIDTH`` when a segment
is long, so a solve on the card repeats bit for bit (an ``index_add_`` on
CUDA adds in no fixed order).

Structure (``rows``/``cols``/``shape``/``dia_*``) is decided on the host at
setup and never changes inside a solve; only ``data`` (and the derived
``kd``) carry per-solve numeric content.  The values may carry one leading
batch dimension (``data [B, nnz]``, ``kd [B, O, m]``: B matrices of one
pattern, ``parallel.sparse_batch``); a product then takes ``x [B, n]`` and
each lane's sums run over that lane's entries alone, in the same order as
one matrix's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..cones.ops import _segment_sum

#: DIA applicability: at most this many distinct offsets, and the dense
#: [O, rows] layout may not blow up memory vs the triplet form
_DIA_MAX_OFFSETS = 96

#: entries a segment sum adds in one padded row before it sums in chunks
_SEG_WIDTH = 32


def dia_metadata(rows, cols, shape):
    """Host-side: (offsets tuple, positions into the flat [O·m] layout) if
    the pattern is DIA-compact, else (None, None)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    m = int(shape[0])
    if rows.size == 0:
        return None, None
    offs = cols - rows
    uoff = np.unique(offs)
    if uoff.size > _DIA_MAX_OFFSETS or uoff.size * m > max(8 * rows.size, 1 << 20):
        return None, None
    oidx = np.searchsorted(uoff, offs)
    pos = (oidx * m + rows).astype(np.int64)
    return tuple(int(o) for o in uoff), pos


def segment_levels(seg, num: int):
    """Host-side: the padded gathers that sum a vector's entries by segment
    ``seg`` (one id in [0, num) per entry) in a fixed order.

    Returns a list of ``(idx, mask)`` pairs for :func:`segment_apply`: each
    level gathers its input into padded rows and sums them; the last
    level's rows are the ``num`` segments.  A segment's entries keep their
    order.  Segments longer than ``_SEG_WIDTH`` (where one padded row per
    segment would take more than four times the entries) are first summed
    in chunks of ``_SEG_WIDTH`` entries, then their chunks."""
    ids = np.asarray(seg, np.int64)
    order = np.argsort(ids, kind="stable")
    ids, src = ids[order], order
    levels = []
    while True:
        counts = np.bincount(ids, minlength=num)
        width = int(counts.max()) if ids.size else 0
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        rank = np.arange(ids.size, dtype=np.int64) - starts[ids]
        if width <= _SEG_WIDTH or num * width <= 4 * ids.size:
            idx = np.zeros((num, width), np.int64)
            mask = np.zeros((num, width), bool)
            idx[ids, rank] = src
            mask[ids, rank] = True
            levels.append((idx, mask))
            return levels
        chunks = (counts + _SEG_WIDTH - 1) // _SEG_WIDTH
        first = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
        chunk_of = first[ids] + rank // _SEG_WIDTH
        total = int(chunks.sum())
        idx = np.zeros((total, _SEG_WIDTH), np.int64)
        mask = np.zeros((total, _SEG_WIDTH), bool)
        idx[chunk_of, rank % _SEG_WIDTH] = src
        mask[chunk_of, rank % _SEG_WIDTH] = True
        levels.append((idx, mask))
        ids = np.repeat(np.arange(num, dtype=np.int64), chunks)
        src = np.arange(total, dtype=np.int64)


def levels_to(levels, device):
    """:func:`segment_levels`' arrays as tensors on ``device``."""
    return [(torch.as_tensor(i, device=device), torch.as_tensor(m, device=device))
            for i, m in levels]


def segment_apply(levels, x, dim=0):
    """Sums of ``x``'s entries along ``dim`` by segment, through the
    device levels of :func:`segment_levels`: ``x [..., entries, ...]`` ->
    ``[..., num, ...]``.  A vector, or a sum along the last dimension,
    takes the cones' fixed-order sum (``cones.ops._segment_sum``); along
    another dimension the same scheme: one padded gather and a reduction on
    the card, the padded entries added left to right on the CPU (as a
    sequential scatter-add sums).  Leading dimensions are independent
    problems: each one's sums are those of it alone."""
    dim = dim % x.dim()
    for idx, mask in levels:
        if dim == x.dim() - 1:
            x = _segment_sum(x, idx, mask)
            continue
        g = x[idx] if dim == 0 else x.index_select(dim, idx.reshape(-1)).unflatten(dim, idx.shape)
        g = torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - dim - 1)), g, 0.0)
        if g.is_cuda:
            x = g.sum(dim=dim + 1)
        else:
            x = torch.zeros(g.shape[:dim + 1] + g.shape[dim + 2:], dtype=g.dtype,
                            device=g.device)
            for j in range(g.shape[dim + 1]):
                x = x + g.select(dim + 1, j)
    return x


def segment_max(levels, x, dim=0):
    """Largest entry of each segment of a nonnegative ``x`` along ``dim``,
    through the levels of :func:`segment_levels` (0 for an empty segment).
    A maximum does not depend on the order, so the card and the CPU reduce
    each padded row at once."""
    dim = dim % x.dim()
    for idx, mask in levels:
        g = x.index_select(dim, idx.reshape(-1)).unflatten(dim, idx.shape)
        g = torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - dim - 1)), g, 0.0)
        if g.shape[dim + 1] == 0:
            x = torch.zeros(g.shape[:dim + 1] + g.shape[dim + 2:], dtype=g.dtype,
                            device=g.device)
        else:
            x = g.amax(dim=dim + 1)
    return x


class COOMat:
    """Sparse matrix in coordinate form supporting ``M @ x`` and ``M.T``.

    ``dia_pos``/``kd`` (optional) carry the DIA fast path; ``trans`` marks
    a transposed view (``kd`` always describes the base orientation
    ``base_shape``).  ``segs`` holds the segment sums by row and by column
    of the current orientation."""

    def __init__(self, data, rows, cols, shape, segs, dia_pos=None, kd=None,
                 dia_offsets=None, trans=False):
        self.data = data
        self.rows = rows
        self.cols = cols
        self.shape = tuple(int(s) for s in shape)
        self.segs = segs
        self.dia_pos = dia_pos
        self.kd = kd
        self.dia_offsets = dia_offsets
        self.trans = bool(trans)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_scipy(cls, M, dtype, device, dia=False):
        """Build from a scipy sparse matrix on ``device``.  ``dia=True``
        attaches DIA metadata when the pattern is compact."""
        coo = M.tocoo()
        return cls.from_coo(coo.data, coo.row, coo.col, coo.shape, dtype, device, dia)

    @classmethod
    def from_coo(cls, data, rows, cols, shape, dtype, device, dia=False):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        dia_pos = offsets = None
        if dia:
            offsets, pos = dia_metadata(rows, cols, shape)
            if offsets is not None:
                dia_pos = torch.as_tensor(pos, device=device)
        segs = (levels_to(segment_levels(rows, shape[0]), device),
                levels_to(segment_levels(cols, shape[1]), device))
        return cls(
            torch.as_tensor(np.asarray(data, np.float64), dtype=dtype, device=device),
            torch.as_tensor(rows, device=device),
            torch.as_tensor(cols, device=device),
            shape, segs, dia_pos=dia_pos, dia_offsets=offsets,
        )

    # -- linear algebra ---------------------------------------------------
    @property
    def base_shape(self):
        return self.shape[::-1] if self.trans else self.shape

    @property
    def T(self) -> "COOMat":
        return COOMat(self.data, self.cols, self.rows, self.shape[::-1],
                      self.segs[::-1], self.dia_pos, self.kd, self.dia_offsets,
                      not self.trans)

    mT = T

    def predia(self) -> "COOMat":
        """Materialize the DIA layout from the current values (one
        scatter); no-op when the pattern is not DIA-compact.  Call once per
        solve, after the values are final (after equilibration)."""
        if self.dia_offsets is None or self.kd is not None:
            return self
        O = len(self.dia_offsets)
        m = self.base_shape[0]
        batch = self.data.shape[:-1]
        kd = torch.zeros(batch + (O * m,), dtype=self.data.dtype, device=self.data.device)
        kd[..., self.dia_pos] = self.data
        return COOMat(self.data, self.rows, self.cols, self.shape, self.segs,
                      self.dia_pos, kd.reshape(batch + (O, m)), self.dia_offsets, self.trans)

    def _dia_mv(self, x):
        offs = self.dia_offsets
        m, n = self.base_shape
        batch = x.shape[:-1]
        if not self.trans:
            # y[i] = Σ_o d_o[i]·x[i+o]
            lo = max(0, -min(offs))
            hi = max(0, m - 1 + max(offs) - (n - 1))
            xp = F.pad(x, (lo, hi))
            y = torch.zeros(batch + (m,), dtype=x.dtype, device=x.device)
            for oi, o in enumerate(offs):
                y = y + self.kd[..., oi, :] * xp[..., lo + o: lo + o + m]
            return y
        # transposed product: y[j] = Σ_o (d_o ⊙ z)[j - o]
        pl = max(0, max(offs))
        pr = max(0, (n - 1) - min(offs) - (m - 1))
        y = torch.zeros(batch + (n,), dtype=x.dtype, device=x.device)
        for oi, o in enumerate(offs):
            wp = F.pad(self.kd[..., oi, :] * x, (pl, pr))
            y = y + wp[..., pl - o: pl - o + n]
        return y

    def __matmul__(self, x):
        """``M x`` for one matrix and ``x [n]``, or for a batch of matrices
        (``data [B, nnz]``) and ``x [B, n]``, lane by lane."""
        if x.dim() != self.data.dim():
            raise ValueError(f"COOMat products take x with the values' batch shape: data "
                             f"{tuple(self.data.shape)}, x {tuple(x.shape)}")
        if self.kd is not None:
            return self._dia_mv(x)
        return segment_apply(self.segs[0], self.data * x[..., self.cols], dim=-1)

    def with_data(self, data) -> "COOMat":
        # kd is derived from data and now stale; predia() re-materializes
        return COOMat(data, self.rows, self.cols, self.shape, self.segs,
                      self.dia_pos, None, self.dia_offsets, self.trans)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[-1])

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"COOMat(shape={self.shape}, nnz={self.nnz})"

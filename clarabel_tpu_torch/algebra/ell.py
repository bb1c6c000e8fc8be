"""Row-sharded constraint matrices for the intra-problem parallel path.

PyTorch port of ``clarabel_tpu/algebra/ell.py``.  A rank of a row group
(one axis of a ``DeviceMesh``, ``parallel/distributed.py``) holds only its
own contiguous block of A's rows; every vector stays whole on every rank.
:class:`ELLRowMat` holds a sparse A as row-padded ELL arrays
(``vals``/``cols`` ``[m_loc, knz]``, knz the most nonzeros of any row), so
that ``ShardedRowSolver`` takes a tall scipy-sparse A (m >> n) without the
host ever materializing the dense [m, n] matrix: host memory stays O(nnz)
and each rank receives only its own rows.  :class:`DenseRowMat` holds a
dense block ``[..., m_loc, n]`` (with optional leading batch dimensions,
for ``BatchSolver`` on a 2-D mesh).

Both give the IPM what it needs of A -- ``A @ x``, ``A.T @ z``, row and
column inf-norms, row/column scaling -- with the communication fixed by
construction (``parallel/comm.py``):

- ``A @ x``   -- each rank multiplies its rows, then one all-gather of the
  [m] result (an m-vector, never A);
- ``A.T @ z`` -- each rank multiplies its rows' slice of z into [n], then
  one all-reduce (sum).  The ELL product scatters into [n] by a fixed-order
  segment sum (``algebra/coo.py``), never by an atomic scatter-add, so a
  solve repeats bit for bit;
- ``row_abs_max`` -- local, then one all-gather of [m];
- ``col_abs_max`` -- local, then one all-reduce (max) of [n];
- ``densify_sharded()`` -- the rank's dense [m_loc, n] row block, the
  operand of the Schur Gram reduction
  (``kkt/dense.py:prepare_schur_diag_rowsharded_ell``).  It lives only on
  the rank's device; no collective moves it, and A is never gathered.

The reference has no analog (its CSC matvecs are single-threaded pointer
loops, algebra/csc/matrix_math.rs).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..parallel import comm
from .coo import levels_to, segment_apply, segment_levels, segment_max


def _absmax(M, dim):
    """``max(|M|)`` along ``dim``, 0 for an empty dimension."""
    if M.shape[dim] == 0:
        shape = list(M.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=M.dtype, device=M.device)
    return torch.clamp(M.abs().amax(dim=dim), min=0.0)


class _RowSharded:
    """What both row-sharded forms share: the row group, this rank's place
    in it, and the collectives around the local products."""

    def __init__(self, shape, group, trans):
        self.shape = tuple(int(s) for s in shape)  # logical, this orientation
        self.group = group
        self.trans = bool(trans)
        world = torch.distributed.get_world_size(group)
        self.rank = torch.distributed.get_rank(group)
        m = self.base_shape[-2]
        if m % world:
            raise ValueError(f"rows ({m}) must divide the row group ({world})")
        self.m_loc = m // world
        self.row0 = self.rank * self.m_loc

    @property
    def base_shape(self):
        return self.shape[:-2] + self.shape[-2:][::-1] if self.trans else self.shape

    def row_block(self, v):
        """This rank's rows of an m-vector ``v [..., m]``."""
        return v[..., self.row0:self.row0 + self.m_loc]

    def __matmul__(self, x):
        if not self.trans:
            # local rows, then the [m] result on every rank
            return comm.all_gather(self._rows_mv(x), self.group)
        # this rank's rows' share of Aᵀz, summed over the group
        return comm.all_reduce(self._rows_rmv(self.row_block(x)), self.group)

    @property
    def T(self):
        return self._with(trans=not self.trans)

    mT = T

    def row_abs_max(self):
        """Per-row inf-norm, [..., m] on every rank."""
        return comm.all_gather(self._local_row_abs_max(), self.group)

    def col_abs_max(self):
        """Per-column inf-norm, [..., n] on every rank."""
        return comm.all_reduce(self._local_col_abs_max(), self.group, op="max")


class ELLRowMat(_RowSharded):
    """This rank's rows of a sparse A as padded ELL arrays: ``vals`` and
    ``cols`` ``[m_loc, knz]``, ``mask`` marking the stored entries (the
    padding sits at column 0 with value 0).  ``segs`` are the fixed-order
    segment sums by column of the stored entries (``algebra/coo.py``)."""

    def __init__(self, vals, cols, mask, segs, shape, group, trans=False, dense=None):
        self.vals, self.cols, self.mask, self.segs = vals, cols, mask, segs
        self._dense = dense
        super().__init__(shape, group, trans)

    def _with(self, vals=None, trans=None):
        flip = trans is not None and trans != self.trans
        same = vals is None
        return ELLRowMat(self.vals if same else vals, self.cols, self.mask, self.segs,
                         self.shape[::-1] if flip else self.shape, self.group,
                         self.trans ^ flip, self._dense if same else None)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_scipy(cls, A, mesh, axis, dtype, rows=None):
        """This rank's rows of the scipy-sparse ``A`` on the rank's device of
        ``mesh``, at torch ``dtype``; ``axis`` names the row axis.

        ``rows`` (optional, [m]) names the row of ``A`` each logical row
        takes, an index past A's last row for an empty row: a row
        permutation and padding applied without a permuted copy of ``A``.
        Only this rank's block is read; host memory stays
        O(nnz + m_loc·knz)."""
        from ..parallel.distributed import mesh_device

        group = mesh.get_group(axis)
        world = torch.distributed.get_world_size(group)
        rank = torch.distributed.get_rank(group)
        device = mesh_device(mesh)
        A = sp.csr_matrix(A)
        if not A.has_canonical_format:
            A = A.copy()
            A.sum_duplicates()
        n = A.shape[1]
        m = A.shape[0] if rows is None else len(rows)
        if m % world:
            raise ValueError(f"rows ({m}) must divide the row group ({world})")
        m_loc = m // world
        lo = rank * m_loc
        local = np.arange(lo, lo + m_loc) if rows is None else np.asarray(rows[lo:lo + m_loc])
        knz = max(int(np.diff(A.indptr).max(initial=0)), 1)
        valid = local < A.shape[0]
        sub = A[local[valid]]
        counts = np.zeros(m_loc, np.int64)
        counts[valid] = np.diff(sub.indptr)
        mask = np.arange(knz)[None, :] < counts[:, None]
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        vals = np.zeros((m_loc, knz), np_dtype)
        cols = np.zeros((m_loc, knz), np.int32)
        vals[mask] = sub.data
        cols[mask] = sub.indices
        # the stored entries' segment sums by column; the first level's
        # gathers index the flat [m_loc·knz] entries, padding left out
        levels = segment_levels(sub.indices, n)
        levels[0] = (np.flatnonzero(mask.ravel())[levels[0][0]], levels[0][1])
        as_t = lambda v: torch.as_tensor(v, device=device)
        return cls(as_t(vals), as_t(cols).long(), as_t(mask), levels_to(levels, device),
                   (m, n), group)

    # -- products --------------------------------------------------------
    def _rows_mv(self, x):
        if x.dim() != 1:
            raise ValueError("ELLRowMat products take one vector")
        return (self.vals * x[self.cols]).sum(dim=-1)

    def _rows_rmv(self, z_loc):
        if z_loc.dim() != 1:
            raise ValueError("ELLRowMat products take one vector")
        return segment_apply(self.segs, (self.vals * z_loc[:, None]).reshape(-1), dim=-1)

    # -- equilibration support ------------------------------------------
    def _local_row_abs_max(self):
        return _absmax(self.vals, -1)

    def _local_col_abs_max(self):
        return segment_max(self.segs, self.vals.abs().reshape(-1), dim=-1)

    def scale(self, e_row, d_col) -> "ELLRowMat":
        """diag(e_row) A diag(d_col): ``e_row`` [m], ``d_col`` [n]."""
        return self._with(vals=self.vals * self.row_block(e_row)[:, None] * d_col[self.cols])

    def densify_sharded(self):
        """This rank's dense [m_loc, n] row block (made once per matrix,
        after its values are final).  Each stored entry is written to its
        own place and each padding slot to a column of its own past n, so
        no two writes meet and the padding never lands on column 0."""
        if self._dense is None:
            m_loc, knz = self.vals.shape
            n = self.base_shape[1]
            width = n + knz
            r = torch.arange(m_loc, device=self.vals.device)[:, None] * width
            slot = torch.arange(knz, device=self.vals.device)[None, :] + n
            idx = r + torch.where(self.mask, self.cols, slot)
            dense = torch.zeros(m_loc * width, dtype=self.vals.dtype, device=self.vals.device)
            dense[idx.reshape(-1)] = self.vals.reshape(-1)
            self._dense = dense.reshape(m_loc, width)[:, :n]
        return self._dense

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"ELLRowMat(shape={self.shape}, rows {self.row0}+{self.m_loc}, knz={self.vals.shape[1]})"


class DenseRowMat(_RowSharded):
    """This rank's rows of a dense A, ``local [..., m_loc, n]`` (leading
    batch dimensions are independent problems), in a row group of logical
    height ``m``."""

    def __init__(self, local, m, group, trans=False):
        self.local = local
        shape = tuple(local.shape[:-2]) + (m, local.shape[-1])
        super().__init__(shape[:-2] + shape[-2:][::-1] if trans else shape, group, trans)

    @classmethod
    def from_mesh(cls, local, m, mesh, axis):
        return cls(local, m, mesh.get_group(axis))

    def _with(self, local=None, trans=None):
        return DenseRowMat(self.local if local is None else local, self.base_shape[-2],
                           self.group, self.trans if trans is None else trans)

    def _rows_mv(self, x):
        from ..kkt.dense import matvec

        return matvec(self.local, x)

    def _rows_rmv(self, z_loc):
        from ..kkt.dense import matvec

        return matvec(self.local.mT, z_loc)

    def _local_row_abs_max(self):
        return _absmax(self.local, -1)

    def _local_col_abs_max(self):
        return _absmax(self.local, -2)

    def scale(self, e_row, d_col) -> "DenseRowMat":
        """diag(e_row) A diag(d_col), rounded as the dense equilibration
        rounds it: ``e_row`` [..., m], ``d_col`` [..., n]."""
        return self._with(local=self.local * self.row_block(e_row)[..., :, None]
                          * d_col[..., None, :])

    def densify_sharded(self):
        return self.local

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"DenseRowMat(shape={self.shape}, rows {self.row0}+{self.m_loc})"

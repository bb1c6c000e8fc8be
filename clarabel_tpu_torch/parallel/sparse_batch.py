"""Batched sparse solving: B problems of one sparsity pattern through one
multifrontal plan.

PyTorch port of ``clarabel_tpu/parallel/sparse_batch.py``, at f64 and
f32.  MPC,
SQP and scenario workloads solve many conic programs with the SAME
sparsity pattern (the dynamics' structure is fixed; only values change).
The sparse multifrontal KKT engine is built from the pattern alone
(:mod:`clarabel_tpu_torch.kkt.mf_symbolic`), so one symbolic analysis
serves the whole batch and the numeric work takes a leading batch
dimension: fronts become ``[B, k, r, r]`` tensors, each bucket's diagonal
blocks of every lane go to one launch of the hand-written LDLᵀ kernel, and
the scatter assembly and the levelized triangular sweeps batch unchanged.
One host loop runs the IPM for every lane, so a factor launches as many
kernels for B problems as for one.  The reference has no analog (a
single-threaded library; SURVEY.md §2.9): this composes its sparse KKT
(qdldl.rs:468-700) with a scenario-batch axis.

Semantics contract as :class:`~clarabel_tpu_torch.BatchSolver`'s (no
presolve, chordal decomposition, callback or time limit; per-lane
freezing; on a 1-D ``DeviceMesh`` the lanes split contiguously over the
ranks, each rank solving and returning its own block), with the sparse
path's own rules: the structure is immutable, the values vary per lane,
and the KKT runs the multifrontal engine whatever ``direct_solve_method``
says.  The symbolic plan depends on the pattern alone, so every rank of a
mesh builds the same plan.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra.coo import COOMat
from ..cones import api
from ..cones.layout import ConeLayout
from ..infbound import get_infinity
from ..kkt import sparse as kkt_sparse
from ..settings import DefaultSettings
from ..solver import build_solve_core, check_ported, full_precision, resolve_device
from .batch import BatchSolution, _LaneSplit
from .distributed import check_mesh, mesh_device


def _stack_same_structure(mats, name):
    """Canonicalize a list of scipy matrices with identical sparsity to
    (csc_pattern, data [B, nnz]).  Raises when patterns differ."""
    first = sp.csc_matrix(mats[0], copy=True)
    first.sort_indices()
    data = np.empty((len(mats), first.nnz), np.float64)
    data[0] = first.data
    for i, M in enumerate(mats[1:], 1):
        Mc = sp.csc_matrix(M, copy=True)
        Mc.sort_indices()
        if Mc.shape != first.shape or Mc.nnz != first.nnz or not (
            np.array_equal(Mc.indptr, first.indptr)
            and np.array_equal(Mc.indices, first.indices)
        ):
            raise ValueError(
                f"all {name} instances must share one sparsity pattern "
                f"(instance {i} differs); pad with explicit zeros"
            )
        data[i] = Mc.data
    return first, data


class SparseBatchSolver:
    """Solve a batch of sparse conic programs sharing one sparsity pattern.

    Parameters
    ----------
    P, A : sequence of scipy.sparse matrices (identical patterns), or a
        single scipy.sparse matrix used for every instance.
    q : [B, n]; b : [B, m].
    cones : shared cone specification.
    dtype : "float64" (the default) or "float32" (with
        ``DefaultSettings.for_float32``).
    mesh : optional 1-D ``DeviceMesh``: every rank constructs and solves
        the batch with the same data, on the mesh's device, and gets its
        own block of lanes back (``BatchSolution.lanes``); B must divide the
        mesh.
    device : without a mesh the solve runs on a CUDA device unless this
        names another (``device="cpu"``); without a CUDA device and without
        it the constructor raises.

    One symbolic multifrontal analysis (ordering, supernodes, level
    schedule, scatter maps) is shared; the numeric factor and solves run
    on ``[B, ...]`` tensors in one host loop, each lane freezing when it
    stops.
    """

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[api.ConeSpec],
        settings: Optional[DefaultSettings] = None,
        dtype: Optional[str] = None,
        mesh=None,
        device=None,
    ):
        self.settings = settings if settings is not None else DefaultSettings()
        self.settings.validate()

        self._dtype = check_ported(dtype)
        if self.settings.time_limit != float("inf"):
            raise ValueError(
                "SparseBatchSolver has no wall-clock time limit: leave settings.time_limit "
                "at inf and bound the batch with max_iter"
            )
        if mesh is not None:
            check_mesh(mesh, (1,), "SparseBatchSolver")
            self._device = mesh_device(mesh)
        else:
            self._device = resolve_device(device)

        q = np.atleast_2d(np.asarray(q, np.float64))
        b = np.atleast_2d(np.asarray(b, np.float64))
        B, n = q.shape
        m = b.shape[1]
        if b.shape[0] != B:
            raise ValueError("q and b disagree on the batch size")

        if sp.issparse(P):
            P = [P] * B
        if sp.issparse(A):
            A = [A] * B
        if len(P) != B or len(A) != B:
            raise ValueError("P/A lists must have one matrix per instance")

        P0, P_data = _stack_same_structure(P, "P")
        A0, A_data = _stack_same_structure(A, "A")
        if P0.shape != (n, n) or A0.shape != (m, n):
            raise ValueError("P/A shapes do not match q/b")
        cones = tuple(cones)
        if sum(c.nvars for c in cones) != m:
            raise ValueError("cone dims do not match b")

        # --- host symbolic pipeline (pattern only, instance-independent) --
        # triu-symmetrize P with an explicit data map so every instance
        # rides the same deterministic COO order
        Pt = sp.triu(P0, format="csc")
        Pt.sort_indices()
        # map: position in P0's canonical CSC data -> kept-triu positions
        rows_all = P0.indices
        cols_all = np.repeat(np.arange(n), np.diff(P0.indptr))
        triu_src = np.where(rows_all <= cols_all)[0]
        tr = Pt.tocoo()
        strict = tr.row != tr.col
        sym_rows = np.concatenate([tr.row, tr.col[strict]]).astype(np.int64)
        sym_cols = np.concatenate([tr.col, tr.row[strict]]).astype(np.int64)
        self._sym_src = np.concatenate([triu_src, triu_src[strict]])
        self._P_nnz = P0.nnz
        P_sym_data = P_data[:, self._sym_src]
        self._p_is_zero = not np.any(P_sym_data)

        # no presolve in batch mode (value-dependent; see BatchSolver):
        # cap b at the infinity bound instead
        b = np.minimum(b, get_infinity())

        self._layout = ConeLayout(api.collapse_cones(cones))
        perm = self._layout.perm

        # cone-permute A rows once on the pattern, with a data map so the
        # per-instance values follow
        tmp = A0.copy()  # canonical CSC frame
        tmp.data = np.arange(A0.nnz, dtype=np.float64)
        A_perm = tmp.tocsr()[perm].tocoo()
        self._a_src = np.rint(A_perm.data).astype(np.int64)
        A_perm_data = A_data[:, self._a_src]
        b = b[:, perm]

        self._skkt = kkt_sparse.build(
            self._layout, n, sym_rows, sym_cols,
            A_perm.row.astype(np.int64), A_perm.col.astype(np.int64),
            ordering=self.settings.multifrontal_ordering, dtype=self._dtype,
        )
        self.B, self.n, self.m = B, n, m
        self._split = _LaneSplit(B, mesh)
        P_sym_data, A_perm_data, q, b = (self._split.take(v)
                                         for v in (P_sym_data, A_perm_data, q, b))
        dtype = getattr(torch, self._dtype)
        self._put = lambda v: torch.tensor(np.asarray(v, np.float64), dtype=dtype,
                                           device=self._device)

        self._skkt_data = self._skkt.device_data(dtype, self._device)
        # the values carry the batch; the pattern (rows, cols, DIA
        # positions, segment sums) is shared by every lane
        self._P = COOMat.from_coo(P_sym_data, sym_rows, sym_cols, (n, n), dtype,
                                  self._device, dia=True)
        self._A = COOMat.from_coo(A_perm_data, A_perm.row, A_perm.col, (m, n), dtype,
                                  self._device, dia=True)
        self._q = self._put(q)
        self._b = self._put(b)
        self._solve_fn = build_solve_core(
            self._layout, self.settings, n, self._p_is_zero, dtype,
            sparse_ctx=(self._skkt, self._skkt_data),
        )

    # ------------------------------------------------------------------
    @property
    def plan(self):
        """The shared multifrontal plan (for introspection/testing)."""
        return self._skkt.plan

    def solve(self, warm_start=None) -> BatchSolution:
        """Solve the batch; ``warm_start`` is a previous
        :class:`BatchSolution` or an (x, s, z) triple of [B, ...] arrays."""
        t0 = time.perf_counter()
        with full_precision():
            ws = None if warm_start is None else self._warm_iterates(warm_start)
            out = self._solve_fn(self._P, self._q, self._A, self._b, ws)
            out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        solve_time = time.perf_counter() - t0

        # undo the cone permutation per instance
        perm = self._layout.perm
        z = np.empty_like(out["z"])
        s = np.empty_like(out["s"])
        z[:, perm] = out["z"]
        s[:, perm] = out["s"]

        self._last_out = out
        return BatchSolution(
            x=out["x"],
            z=z,
            s=s,
            status=out["status"],
            obj_val=out["obj_val"],
            obj_val_dual=out["obj_val_dual"],
            iterations=out["iterations"],
            r_prim=out["r_prim"],
            r_dual=out["r_dual"],
            solve_time=solve_time,
            lanes=self._split.lanes,
        )

    def _warm_iterates(self, warm_start):
        """The warm start's (x, s, z) of this rank's lanes as tensors on the
        device, s and z in the layout's row order (the JAX package's
        ``_solve_warm``)."""
        x0, s0, z0 = self._split.warm(warm_start, self.n, self.m)
        perm = self._layout.perm
        return self._put(x0), self._put(s0[:, perm]), self._put(z0[:, perm])

    def update_values(self, P_data=None, q=None, A_data=None, b=None):
        """Replace per-instance numeric values in place (structure is
        immutable — the sparse-path analog of the reference's
        update_data nzval forms, data_updating.rs:98-160).  ``P_data`` /
        ``A_data`` are [B, nnz] in the canonical sorted-CSC data order of
        the setup matrices (full P; the triu-symmetrize map is re-applied
        here).  On a mesh each argument may also cover only this rank's
        lanes.  The plan is never rebuilt."""
        take = self._split.take
        if P_data is not None:
            P_data = take(np.asarray(P_data, np.float64), "P_data")
            if P_data.shape[1:] != (self._P_nnz,):
                raise ValueError("P_data must be [B, nnz(P)] in CSC order")
            self._P = self._P.with_data(self._put(P_data[:, self._sym_src]))
        if A_data is not None:
            A_data = take(np.asarray(A_data, np.float64), "A_data")
            if A_data.shape[1:] != (self._a_src.shape[0],):
                raise ValueError("A_data must be [B, nnz(A)] in CSC order")
            self._A = self._A.with_data(self._put(A_data[:, self._a_src]))
        if q is not None:
            q = take(np.asarray(q, np.float64), "q")
            if q.shape[1:] != (self.n,):
                raise ValueError("q must be [B, n]")
            self._q = self._put(q)
        if b is not None:
            b = take(np.asarray(b, np.float64), "b")
            if b.shape[1:] != (self.m,):
                raise ValueError("b must be [B, m]")
            self._b = self._put(np.minimum(b, get_infinity())[:, self._layout.perm])

    def iteration_history(self):
        """Per-lane progress tables [B, max_iter+1, 9] from the last solve
        (columns: pcost, dcost, gap_abs, gap_rel, pres, dres, k/t, μ, step)."""
        if not hasattr(self, "_last_out"):
            raise ValueError("no solve has been run yet")
        return np.asarray(self._last_out["history"])

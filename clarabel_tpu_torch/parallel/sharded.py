"""Intra-problem model parallelism: one large conic program whose
constraint rows are sharded over the ranks of a device mesh.

PyTorch port of ``clarabel_tpu/parallel/sharded.py``.  The constraint
dimension m is split over a 1-D mesh's ranks -- each rank holds only its
contiguous block of A's rows (``algebra/ell.py``: dense, or sparse ELL) --
while every vector (b, s, z, the scalings, and everything n-sized) stays
whole on every rank.  The IPM loop then runs unchanged and in lockstep on
every rank, and the only communication is what the JAX package writes out
by hand in ``shard_map`` (``parallel/comm.py`` counts it):

- the Schur Gram reduction S = P̃ + Σ_k A_kᵀ H_k⁻¹ A_k, one all-reduce of
  [n, n] per KKT factorization (``kkt/dense.py:prepare_schur_diag_rowsharded``);
- Aᵀv, one all-reduce of [n]; A·v, one all-gather of [m];
- in the equilibration, one all-reduce (max) of [n] and one all-gather of
  [m] per Ruiz pass.

A is never gathered.  Collectives hand every rank the same bits, so the
replicated state stays bitwise identical across ranks and every rank
returns the same solution; the wall-clock time limit is decided once for
the group (``loop.run_ipm``).  This is the "Schur-complement partitioned
KKT" axis of the TPU design (SURVEY.md §2.9 / BASELINE.md), with the small
[n, n] factorization replicated.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra.ell import DenseRowMat, ELLRowMat
from ..cones import api
from ..cones.layout import ConeLayout
from ..infbound import get_infinity
from ..loop import _demoted_kkt_method, _resolved_kkt_method
from ..settings import DefaultSettings
from ..solver import (
    DefaultSolution,
    _symmetrize_triu,
    build_solve_core,
    check_ported,
    full_precision,
)
from ..statuses import SolverStatus
from . import comm
from .distributed import check_mesh, mesh_device


class ShardedRowSolver:
    """Solve ONE conic program with the constraint rows sharded over a 1-D
    ``DeviceMesh``; construct and solve it on every rank of the mesh, with
    the same data.

    Best suited to tall problems (m >> n) with zero and nonnegative cones.
    Those layouts at f32 (``dtype="float32"``, the default, through "auto"
    or "schur_diag") take the explicit-collective path: m is padded to a
    multiple of the mesh size with inert nonnegative rows (0·x + s = 1),
    each rank holds its rows of A, and the KKT runs through the row-sharded
    Schur prepares.  A scipy-sparse A stays sparse there end to end, as
    row-padded ELL blocks: the host never materializes the dense [m, n]
    matrix and each rank builds only its own rows.  ``P`` is always
    densified ([n, n] is the replicated small side).

    Every other layout, dtype or KKT method takes the fallback: each rank
    holds A whole and runs the dense solve replicated, with no
    communication (the JAX package's fallback lets XLA's partitioner place
    the same dense solve).  The row permutation runs on the host as in
    :class:`~clarabel_tpu_torch.DefaultSolver`; there is no presolve and no
    chordal decomposition, and b is capped at the infinity bound.
    """

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[api.ConeSpec],
        settings: Optional[DefaultSettings] = None,
        mesh=None,
        dtype: str = "float32",
    ):
        if mesh is None:
            raise ValueError("ShardedRowSolver requires a 1-D mesh")
        check_mesh(mesh, (1,), "ShardedRowSolver")
        self.settings = settings if settings is not None else DefaultSettings()
        self.settings.validate()
        self._dtype = check_ported(dtype)
        self._mesh = mesh
        axis = mesh.mesh_dim_names[0] if mesh.mesh_dim_names else 0
        self._device = mesh_device(mesh)
        torch_dtype = getattr(torch, self._dtype)

        q = np.asarray(q, np.float64).ravel()
        b = np.minimum(np.asarray(b, np.float64).ravel(), get_infinity())
        P = _symmetrize_triu(P.toarray() if sp.issparse(P) else np.asarray(P, np.float64))
        A = A if sp.issparse(A) else np.asarray(A, np.float64)
        cones_int = list(api.collapse_cones(tuple(cones)))
        n, m_user = q.shape[0], b.shape[0]
        self.n, self.m = n, m_user
        if P.shape != (n, n) or A.shape != (m_user, n):
            raise ValueError(f"P must be {n}x{n} and A {m_user}x{n}")
        world = mesh.size()

        # zero/NN layouts at f32 whose route is "schur_diag" take the
        # explicit collectives: the Gram reduction is each rank's product
        # plus one all-reduce, and A is never gathered.  Their rows are
        # padded to a multiple of the mesh size with free nonnegative rows
        # (0·x + s = 1, s >= 0): structurally inert, so uneven problems
        # shard without user-side surgery
        diag_hs = all(c.kind in (api.ZERO, api.NONNEGATIVE) for c in cones_int)
        pad = (-m_user) % world if diag_hs and self._dtype == "float32" else 0
        padding = [api.ConeSpec(api.NONNEGATIVE, pad)] if pad else []
        self._layout = ConeLayout(tuple(cones_int + padding))
        route = _demoted_kkt_method(self._layout, _resolved_kkt_method(
            self._layout, self.settings, torch_dtype, n))
        explicit = bool(padding or diag_hs and self._dtype == "float32") \
            and route == "schur_diag"
        if pad and not explicit:
            pad, self._layout = 0, ConeLayout(tuple(cones_int))
        sparse_path = sp.issparse(A) and explicit
        self._row_pad = pad
        if pad:
            b = np.concatenate([b, np.ones(pad)])
        perm = self._layout.perm
        b = b[perm]
        m = m_user + pad

        put = lambda v: torch.tensor(np.asarray(v, np.float64), dtype=torch_dtype,
                                     device=self._device)
        if explicit:
            # logical row i is the user's row perm[i]; the padding rows'
            # perm entries lie past the user's rows
            if sparse_path:
                self._A = ELLRowMat.from_scipy(A, mesh, axis, torch_dtype, rows=perm)
            else:
                A = A.toarray() if sp.issparse(A) else A
                m_loc = m // world
                lo = torch.distributed.get_rank(mesh.get_group(axis)) * m_loc
                local = perm[lo:lo + m_loc]
                block = np.zeros((m_loc, n))
                block[local < m_user] = A[local[local < m_user]]
                self._A = DenseRowMat.from_mesh(put(block), m, mesh, axis)
            row_shard = (mesh, axis)
        else:
            A = A.toarray() if sp.issparse(A) else A
            self._A = put(A[perm])
            row_shard = None
        self._explicit_collectives = row_shard is not None
        self._sparse_A = sparse_path
        self._P, self._q, self._b = put(P), put(q), put(b)
        self._solve_fn = build_solve_core(self._layout, self.settings, n, not np.any(P),
                                          torch_dtype, row_shard=row_shard)
        #: the collectives of the last solve: {kind: {"calls": ..., "bytes": ...}}
        self.collectives = None

    def solve(self) -> DefaultSolution:
        """Solve; every rank returns the same solution (its solve_time its
        own wall time)."""
        before = comm.snapshot()
        t0 = time.perf_counter()
        with full_precision():
            out = self._solve_fn(self._P, self._q, self._A, self._b)
            out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        solve_time = time.perf_counter() - t0
        self.collectives = {k: {f: v[f] - before[k][f] for f in v}
                            for k, v in comm.snapshot().items()}

        # undo the cone permutation, then drop the padding rows (appended
        # after the user's cones)
        z = np.empty(self._layout.m, np.float64)
        s = np.empty(self._layout.m, np.float64)
        z[self._layout.perm] = out["z"]
        s[self._layout.perm] = out["s"]
        return DefaultSolution(
            x=np.asarray(out["x"], np.float64),
            z=z[: self.m],
            s=s[: self.m],
            status=SolverStatus(int(out["status"])),
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=solve_time,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )

"""Scenario-batch data parallelism: B problems of one structure, one solve.

PyTorch port of ``clarabel_tpu/parallel/batch.py`` on one device over
zero, nonnegative, second-order, exponential, power, generalized power and
PSD triangle cones: at f64, and at f32 where the KKT method is a structured
Schur path ("auto" picks "schur_diag" or "schur_lr" on the zero,
nonnegative and second-order cones).  B conic programs with the same cones
and shapes but different numbers (scenarios, MPC horizons, portfolio
draws) solve as one run of the IPM loop on tensors with a leading batch
dimension: every factorization factors the B KKT matrices at once (batched
pivoted LU or Cholesky, or one launch of the hand-written LDLᵀ kernel for
all of them), and the host reads the device as often as for one problem.
Problems that have converged freeze while the others run on, as under the
JAX package's ``jax.vmap``, so each problem's iterations and history equal
its solve alone; the wall time is that of the slowest problem.

The reference has no equivalent (it is a single-threaded library); this is
the throughput path for MPC, scenario and portfolio workloads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..cones import api
from ..cones.layout import ConeLayout
from ..infbound import get_infinity
from ..settings import DefaultSettings
from ..solver import (
    _not_ported,
    build_solve_core,
    check_ported,
    check_ported_dtype,
    full_precision,
    resolve_device,
)
from ..statuses import SolverStatus


@dataclasses.dataclass
class BatchSolution:
    """Stacked solutions for a problem batch (leading axis = batch).

    ``lanes`` names the batch indices the arrays cover; it is always
    ``None`` here (all of ``0..B-1``): the JAX package sets it only when a
    batch is sharded over several processes.
    """

    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    status: np.ndarray  # int codes; map via SolverStatus(...)
    obj_val: np.ndarray
    obj_val_dual: np.ndarray
    iterations: np.ndarray
    r_prim: np.ndarray
    r_dual: np.ndarray
    solve_time: float
    lanes: Optional[np.ndarray] = None

    def statuses(self):
        return [SolverStatus(int(v)) for v in self.status]


class BatchSolver:
    """Solve a batch of structurally identical conic programs in one shot.

    P: [B, n, n], q: [B, n], A: [B, m, n], b: [B, m].  All instances share
    the cone list.  The solve runs on a CUDA device unless ``device`` names
    another (``device="cpu"``); without a CUDA device and without that
    argument the constructor raises.

    Semantics contract vs :class:`~clarabel_tpu_torch.DefaultSolver`, the
    JAX package's own (the deliberate divergences; everything else --
    statuses, tolerances, certificates, scaling strategies -- is the same
    solve core):

    - **No row-reduction presolve.** Presolve is value-dependent and would
      fragment the batch into per-instance shapes; b is capped at the
      infinity bound instead.
    - **No chordal decomposition** (shape-changing, PSD-specific).
    - **No wall-clock time limit**: a finite ``settings.time_limit`` raises
      (the JAX package's vmapped loop cannot read the clock either);
      MaxIterations bounds the batch instead.
    - **Per-lane freezing**: converged instances stop updating while the
      batch runs to collective completion, so per-lane ``iterations`` are
      exact even though wall-clock is max-of-batch.
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

        if mesh is not None:
            raise _not_ported("sharding a batch over a device mesh (mesh=)", 16)
        self._dtype = check_ported(self.settings, dtype)
        if self.settings.time_limit != float("inf"):
            raise ValueError(
                "BatchSolver has no wall-clock time limit: leave settings.time_limit "
                "at inf and bound the batch with max_iter"
            )
        self._device = resolve_device(device)

        q = np.asarray(q, np.float64)
        b = np.asarray(b, np.float64)
        P = np.asarray(P, np.float64)
        A = np.asarray(A, np.float64)
        if q.ndim != 2:
            raise ValueError("batched q must be [B, n]")
        B, n = q.shape
        if b.ndim != 2:
            raise ValueError("batched b must be [B, m]")
        m = b.shape[1]
        if P.shape != (B, n, n) or A.shape != (B, m, n) or b.shape != (B, m):
            raise ValueError("inconsistent batch shapes")

        cones = tuple(cones)
        if sum(c.nvars for c in cones) != m:
            raise ValueError("cone dims do not match b")
        cones_int = api.collapse_cones(cones)

        # symmetrize-by-triu per instance (matches DefaultSolver semantics)
        U = np.triu(P)
        P = U + np.transpose(np.triu(P, 1), (0, 2, 1))

        # no row-reduction presolve (value-dependent, it would fragment the
        # batch into different shapes): b is capped at the infinity bound
        b = np.minimum(b, get_infinity())

        self._layout = ConeLayout(cones_int)
        perm = self._layout.perm
        A = A[:, perm, :]
        b = b[:, perm]

        self.B, self.n, self.m = B, n, m
        self._p_is_zero = not np.any(P)
        use_pallas = self._device.type == "cuda"
        check_ported_dtype(self._layout, self.settings, self._dtype, n, use_pallas)
        dtype = getattr(torch, self._dtype)

        self._put = lambda v: torch.tensor(v, dtype=dtype, device=self._device)
        self._P, self._q, self._A, self._b = (self._put(v) for v in (P, q, A, b))
        self._solve_fn = build_solve_core(
            self._layout, self.settings, n, self._p_is_zero, dtype, use_pallas=use_pallas,
        )

    # ------------------------------------------------------------------
    def solve(self, warm_start=None) -> BatchSolution:
        """Solve the batch.  ``warm_start`` is a previous
        :class:`BatchSolution` or an (x, s, z) triple of [B, ...] arrays
        used as initial iterates per lane (MPC/scenario re-solve loops)."""
        t0 = time.perf_counter()
        with full_precision():
            ws = None if warm_start is None else self._warm_iterates(warm_start)
            out = self._solve_fn(self._P, self._q, self._A, self._b, ws)
            out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        solve_time = time.perf_counter() - t0

        # undo the cone permutation per instance
        z = np.empty_like(out["z"])
        s = np.empty_like(out["s"])
        z[:, self._layout.perm] = out["z"]
        s[:, self._layout.perm] = out["s"]

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
        )

    def _warm_iterates(self, warm_start):
        """The warm start's [B, ·] (x, s, z) as tensors on the device, s and z
        in the layout's row order (the JAX package's ``_solve_warm``)."""
        if isinstance(warm_start, BatchSolution):
            x0, s0, z0 = warm_start.x, warm_start.s, warm_start.z
        else:
            x0, s0, z0 = warm_start
        x0 = np.asarray(x0, np.float64)
        s0 = np.asarray(s0, np.float64)
        z0 = np.asarray(z0, np.float64)
        if x0.shape != (self.B, self.n) or s0.shape != (self.B, self.m) \
                or z0.shape != (self.B, self.m):
            raise ValueError("warm start has wrong batch dimensions")
        perm = self._layout.perm
        return self._put(x0), self._put(s0[:, perm]), self._put(z0[:, perm])

    def iteration_history(self):
        """Per-lane progress tables [B, max_iter+1, 9] from the last solve
        (columns: pcost, dcost, gap_abs, gap_rel, pres, dres, k/t, μ, step)."""
        if not hasattr(self, "_last_out"):
            raise ValueError("no solve has been run yet")
        return np.asarray(self._last_out["history"])

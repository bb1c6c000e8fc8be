"""DefaultSolver: the user-facing solver object.

PyTorch port of ``clarabel_tpu/solver.py``: host-side orchestration
mirroring the reference setup pipeline (reference:
src/solver/implementations/default/solver.rs:57-126): dimension checks ->
cone collapsing -> presolve -> chordal decomposition of sparse PSD cones ->
cone layout (a row permutation groups the cones by kind) -> one solve on
the device covering equilibration, the IPM loop and solution unscaling.
Large sparse problems (or ``direct_solve_method="multifrontal"``) take the
sparse path: the data stay COO triplets, the KKT system is factored by the
multifrontal engine (``kkt/sparse.py``) and never densified; on "auto" a
cost model measured on the device may send a problem back to the dense
path after the symbolic analysis, as in the JAX package.

Problems solve as

    minimize    (1/2) xᵀPx + qᵀx
    subject to  Ax + s = b,   s ∈ K.

The solve runs on a CUDA device unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument the constructor raises.
f64 solves stay on the card, which runs f64 natively (the JAX package sends
them to the host CPU instead).  ``dtype="float32"`` runs on every dense KKT
method, on every cone: the structured Schur paths, the LDLᵀ kernels and the
pivoted LU with compensated refinement, and "lu" through the double-float
LU, PSD cones with their double-float scaling (``cones/psd.py``); and on
the sparse path, whose refinement evaluates its residuals with the
compensated sparse products (``kkt/sparse.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io as _io
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import equilibration, presolve
from .cones import api
from .cones.layout import ConeLayout
from .infbound import get_infinity
from .kkt.dense import _amax0
from .loop import _resolved_kkt_method, run_ipm
from .settings import DefaultSettings
from .statuses import SolverStatus
from .timers import Timers


@dataclasses.dataclass
class DefaultSolution:
    """Solver output.  reference: solution.rs:11-32"""

    x: np.ndarray
    z: np.ndarray
    s: np.ndarray
    status: SolverStatus
    obj_val: float
    obj_val_dual: float
    solve_time: float
    iterations: int
    r_prim: float
    r_dual: float


@dataclasses.dataclass
class EquilibrationData:
    """Ruiz equilibration scalings (reference: equilibration.rs:9-47).

    ``e`` is reported in the user's row order (the internal solver permutes
    rows by cone group).
    """

    d: np.ndarray
    e: np.ndarray
    c: float


@dataclasses.dataclass
class LinearSolverInfo:
    """Which KKT backend actually runs, and its dimensions.

    reference: kktsolvers/mod.rs:27-38 (LinearSolverInfo {name, threads,
    direct, nnzA, nnzL})."""

    name: str = "none"
    direct: bool = True
    nnzA: int = 0
    nnzL: int = 0
    dim: int = 0  # KKT dimension, including sparse-cone expansion rows
    #: the "auto" route's sparse-vs-dense cost model: its inputs, decision
    #: and provenance; None when no such choice was made
    cost_model: Optional[dict] = None


@dataclasses.dataclass
class DefaultInfo:
    """Progress information from the final iteration.  reference: info.rs:13-64"""

    mu: float = float("nan")
    sigma: float = float("nan")
    step_length: float = 0.0
    iterations: int = 0
    cost_primal: float = float("nan")
    cost_dual: float = float("nan")
    res_primal: float = float("nan")
    res_dual: float = float("nan")
    res_primal_inf: float = float("nan")
    res_dual_inf: float = float("nan")
    gap_abs: float = float("nan")
    gap_rel: float = float("nan")
    ktratio: float = float("nan")
    solve_time: float = 0.0
    status: SolverStatus = SolverStatus.Unsolved
    linear_solver: LinearSolverInfo = dataclasses.field(
        default_factory=LinearSolverInfo
    )


def _to_csc(M, name: str):
    """Accept scipy.sparse / array-likes; return a sorted f64 csc_matrix."""
    import scipy.sparse as sp

    if M is None:
        raise ValueError(f"{name} may not be None")
    if hasattr(M, "tocsc"):
        csc = M.tocsc().copy()
    else:
        M = np.asarray(M, np.float64)
        if M.ndim != 2:
            raise ValueError(f"{name} must be 2-dimensional")
        csc = sp.csc_matrix(M)
    csc.sort_indices()
    return csc.astype(np.float64)


def _full_from_triu(P_triu):
    """The full symmetric CSC matrix of an upper-triangle CSC ``P_triu``,
    every stored entry kept, explicit zeros included: a data update that
    zeroes an entry leaves the sparse path's structure, and so the order of
    its COO values, as it was at setup (a scipy sum would drop the zero)."""
    import scipy.sparse as sp

    T = P_triu.tocoo()
    strict = T.row != T.col
    rows = np.concatenate([T.row, T.col[strict]])
    cols = np.concatenate([T.col, T.row[strict]])
    data = np.concatenate([T.data, T.data[strict]])
    full = sp.csc_matrix((data, (rows, cols)), shape=P_triu.shape)
    full.sort_indices()
    return full


def _symmetrize_triu(P: np.ndarray) -> np.ndarray:
    """Use only the upper triangle of P, treated as symmetric.

    reference: problemdata.rs:79-81 (to_triu) + sym_up views.
    """
    U = np.triu(P)
    return U + np.triu(P, 1).T


# auto-selection gate for the sparse multifrontal KKT path: beyond this
# size a dense (n+m)^2 KKT stops being the right default
_SPARSE_AUTO_MIN_DIM = 3000
_SPARSE_AUTO_MAX_DENSITY = 0.02


def _estimate_hs_nnz(cones) -> int:
    """Lower-triangle nonzero estimate of the -Hs block per cone kind
    (reference: kkt_assembly.rs:53-103)."""
    nnz = 0
    for c in cones:
        if c.kind == api.PSD:
            tri = c.nvars
            nnz += tri * (tri - 1) // 2
        elif c.kind == api.SOC:
            d = c.nvars
            nnz += min(d * (d - 1) // 2, 2 * (d + 1))
        elif c.kind in (api.EXP, api.POW):
            nnz += 3
        elif c.kind == api.GENPOW:
            nnz += 3 * (c.nvars + 1)
    return nnz


def _wants_sparse(settings, P_csc, A_csc, n, m, cones) -> bool:
    """Whether to route this problem to the sparse multifrontal KKT engine
    (the JAX package's rule, clarabel_tpu/solver.py:348-382; the
    reference's auto backend picks between its sparse solvers,
    ldlsolvers/auto.rs:47-88).  A problem too dense only because of large
    decomposable PSD blocks routes there tentatively: the sparse setup
    re-checks the density after the chordal decomposition and falls back
    to the dense path if it did not help."""
    method = settings.direct_solve_method
    if method == "multifrontal":
        return True
    if method != "auto":
        return False
    N = n + m
    if N < _SPARSE_AUTO_MIN_DIM:
        return False
    nnz = 2 * P_csc.nnz + A_csc.nnz + N + _estimate_hs_nnz(cones)
    if nnz < _SPARSE_AUTO_MAX_DENSITY * float(N) * float(N):
        return True
    if (
        settings.chordal_decomposition_enable
        and any(c.kind == api.PSD and c.dim > 3 for c in cones)
    ):
        nnz_nopsd = nnz - _estimate_hs_nnz(
            [c for c in cones if c.kind == api.PSD]
        )
        return nnz_nopsd < _SPARSE_AUTO_MAX_DENSITY * float(N) * float(N)
    return False


# the dense fallback is representable up to this KKT dimension
_DENSE_FALLBACK_MAX_DIM = 8192

#: the JAX package's host-CPU constants of its auto-backend cost model
#: (clarabel_tpu/solver.py:434-441: an order-of-magnitude estimate, not a
#: measurement), used for solves on the CPU so that routes there agree
#: with the JAX package's: ``bucket_s`` (launch-chain latency per
#: multifrontal bucket), ``mf_gflops`` (front-work rate), ``dense_floor_s``
#: + ``dense_n4096_s`` (pivoted-LU latency floor and the cubic term
#: anchored at N = 4096), per iteration
_CPU_COST_MODEL = dict(
    bucket_s=1.0e-4, mf_gflops=5.0,
    dense_floor_s=1.0e-3, dense_n4096_s=3.0e-1,
    provenance="the JAX package's host-CPU estimate (unmeasured)",
)


def _timed(fn, device, reps=3):
    """The least wall seconds of ``reps`` calls of ``fn`` on ``device``,
    each ended by a synchronize, after one untimed call."""
    fn()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


@functools.cache
def _measure_cost_model(device: str) -> dict:
    """The cost model's constants measured once per CUDA device (cached by
    its name): the JAX package's probes (clarabel_tpu/solver.py:451-522),
    at f64; solves at f32 route with the same constants.

    - a 64-op chain of dependent batched [8, 64, 64] products: the per-op
      launch latency (``bucket_s``) and the small-front FLOP rate
      (``mf_gflops``);
    - f64 ``lu_factor`` + ``lu_solve`` at N = 512 and N = 4096, timed on
      the card: the latency floor and the cubic term anchored at N = 4096
      of ``t(N) = dense_floor_s + (N / 4096)³ · dense_n4096_s``, solved
      from the two times.

    A failed measurement raises: no constant stands in for it."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    chain, nb, bkt = 64, 8, 64
    x0 = torch.randn((nb, bkt, bkt), generator=gen, dtype=torch.float64).to(dev)

    def run_chain():
        x = x0
        for _ in range(chain):
            x = (x @ x) / torch.clamp(torch.abs(x).amax(), min=1.0)
        return x

    t_chain = _timed(run_chain, dev)
    bucket_s = max(t_chain / chain, 1e-7)
    mf_gflops = max(2.0 * nb * bkt**3 * chain / t_chain / 1e9, 0.1)

    sizes, times = (512, 4096), []
    for N in sizes:
        K = torch.randn((N, N), generator=gen, dtype=torch.float64)
        K = (K + K.T + 2 * N * torch.eye(N, dtype=torch.float64)).to(dev)
        rhs = torch.randn((N, 1), generator=gen, dtype=torch.float64).to(dev)

        def lu_solve(K=K, rhs=rhs):
            lu, piv = torch.linalg.lu_factor(K)
            return torch.linalg.lu_solve(lu, piv, rhs)

        times.append(_timed(lu_solve, dev))
    w = (sizes[0] / 4096.0) ** 3
    dense_n4096_s = max((times[1] - times[0]) / (1.0 - w), 1e-7)
    dense_floor_s = max(times[0] - w * dense_n4096_s, 1e-7)
    return dict(
        bucket_s=bucket_s, mf_gflops=mf_gflops,
        dense_floor_s=dense_floor_s, dense_n4096_s=dense_n4096_s,
        provenance=(
            f"measured at first use on '{name}': {chain}-op chain of f64 "
            f"[{nb}, {bkt}, {bkt}] products {t_chain * 1e3:.3f} ms, f64 lu_factor"
            f"+lu_solve N={sizes[0]} {times[0] * 1e3:.3f} ms, N={sizes[1]} "
            f"{times[1] * 1e3:.3f} ms"
        ),
    )


def _cost_model_for(device: torch.device) -> dict:
    """The auto route's cost-model constants for ``device``: the JAX
    package's CPU constants on the CPU, measured at first use on a CUDA
    device (keyed by its name)."""
    if device.type == "cpu":
        return dict(_CPU_COST_MODEL, device_kind="cpu")
    if device.type != "cuda":
        raise RuntimeError(f"no cost model for device {device}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    return dict(_measure_cost_model(f"cuda:{index}"), device_kind=name)


def _prefer_dense(plan, N, cost_model) -> bool:
    """Cost-model veto of the multifrontal choice after symbolic analysis
    (the analog of the reference's auto backend, which computes the AMD
    ordering + symbolic counts and switches on flops/nnz(L),
    ldlsolvers/auto.rs:47-88; the JAX package's solver.py:543-571): the
    predicted per-iteration time of the levelized multifrontal schedule
    (``bucket_s`` per bucket + front flops) against one dense LU of the
    full KKT (latency floor + cubic term).  Records the inputs and the
    decision in ``cost_model``."""
    if N > _DENSE_FALLBACK_MAX_DIM:
        cost_model["decision"] = "multifrontal (N beyond dense fallback)"
        return False
    n_buckets = sum(len(lvl) for lvl in plan.levels)
    t_mf = cost_model["bucket_s"] * n_buckets + plan.flops / (cost_model["mf_gflops"] * 1e9)
    t_dense = cost_model["dense_floor_s"] + (float(N) / 4096.0) ** 3 * (
        cost_model["dense_n4096_s"]
    )
    cost_model["t_mf_s"] = round(t_mf, 6)
    cost_model["t_dense_s"] = round(t_dense, 6)
    prefer = t_dense < t_mf
    cost_model["decision"] = "dense" if prefer else "multifrontal"
    return prefer


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: CUDA unless the caller names another.
    Raises when no device is named and no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to solve on the CPU"
        )
    return torch.device("cuda")


@contextlib.contextmanager
def full_precision():
    """Full-precision f32 products on the card, as the JAX package pins
    ``default_matmul_precision("highest")`` (clarabel_tpu/solver.py:274-295):
    no TF32 in matrix products or cuDNN.  Restores the previous flags."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def build_solve_core(layout: ConeLayout, settings: DefaultSettings,
                     n: int, p_is_zero: bool, dtype: torch.dtype,
                     use_pallas: bool = False, callback=None, sparse_ctx=None,
                     row_shard=None):
    """The solve function (P, q, A, b, warm_start=None) -> outputs, with the
    same output dictionary as the JAX package's
    (clarabel_tpu/solver.py:246-272).  The tensors stay on their device.  It
    solves one problem, or a batch of problems when the data carry a leading
    batch dimension (P [B, n, n], q [B, n], A [B, m, n], b [B, m]); every
    output then has it too.  ``warm_start`` is an (x0, s0, z0) initial
    iterate in the user frame (rows in the layout's order), ``callback`` a
    per-iteration termination callback of a single problem (``loop.run_ipm``).

    With ``sparse_ctx`` (a ``(kkt.sparse.SparseKKT, device data)`` pair) the
    function takes ``P``/``A`` as ``algebra.coo.COOMat`` (P full-symmetric)
    of one problem, or of a batch of one sparsity pattern (values
    ``[B, nnz]`` with q [B, n] and b [B, m]; ``parallel.sparse_batch``),
    and the KKT path runs the sparse multifrontal engine: nothing is
    densified.

    With ``row_shard = (DeviceMesh, axis)`` the function takes ``A`` as the
    rank's rows of a row-sharded matrix (``algebra.ell.ELLRowMat`` or
    ``DenseRowMat``) and P, q, b whole: the equilibration runs through
    ``equilibrate_ell`` and the KKT through the row-sharded Schur prepares,
    every rank in lockstep (``parallel/sharded.py``; the JAX package's
    solver.py:199-202).  Every output is the same on every rank."""

    def solve_core(P, q, A, b, warm_start=None):
        # unscaled inf-norms of the linear terms, cached before
        # equilibration (problemdata.rs:147-148)
        normq = _amax0(q)
        normb = _amax0(b)

        if sparse_ctx is not None:
            P, q, A, b, d, e, c_scale = equilibration.equilibrate_sparse(
                layout, settings, P, q, A, b
            )
            # values are final for the whole IPM: materialize the DIA
            # matvec layout once (no-op for non-compact patterns)
            P, A = P.predia(), A.predia()
        elif row_shard is not None:
            triu_mask = torch.triu(torch.ones((n, n), dtype=dtype, device=P.device))
            P, q, A, b, d, e, c_scale = equilibration.equilibrate_ell(
                layout, settings, P, q, A, b, triu_mask
            )
        else:
            triu_mask = torch.triu(torch.ones((n, n), dtype=dtype, device=P.device))
            P, q, A, b, d, e, c_scale = equilibration.equilibrate(
                layout, settings, P, q, A, b, triu_mask
            )
        dinv, einv, cinv = 1.0 / d, 1.0 / e, 1.0 / c_scale
        equil = (d, e, dinv, einv, cinv)

        if warm_start is not None:
            # scale the user-frame iterate into the equilibrated frame (the
            # inverse of the unscaling below, at τ = 1)
            x0, s0, z0 = warm_start
            warm_start = (x0 * dinv, s0 * e, z0 * c_scale.unsqueeze(-1) * einv)

        st = run_ipm(
            layout, settings, P, q, A, b, equil, normq, normb, p_is_zero, dtype,
            use_pallas=use_pallas, warm_start=warm_start, callback=callback,
            sparse_kkt=sparse_ctx, row_shard=row_shard,
        )

        # ---- solution post-processing (solution.rs:68-111,
        #      variables.rs:262-285)
        status = st.status
        is_infeasible = (
            (status == int(SolverStatus.PrimalInfeasible))
            | (status == int(SolverStatus.DualInfeasible))
            | (status == int(SolverStatus.AlmostPrimalInfeasible))
            | (status == int(SolverStatus.AlmostDualInfeasible))
        )
        scaleinv = torch.where(is_infeasible, 1.0 / st.kappa, 1.0 / st.tau)

        x = st.x * d * scaleinv.unsqueeze(-1)
        z = st.z * e * (scaleinv * cinv).unsqueeze(-1)
        s = st.s * einv * scaleinv.unsqueeze(-1)

        obj_val = torch.where(is_infeasible, torch.nan, st.cost_primal)
        obj_val_dual = torch.where(is_infeasible, torch.nan, st.cost_dual)

        return {
            "x": x,
            "z": z,
            "s": s,
            "status": status,
            "obj_val": obj_val,
            "obj_val_dual": obj_val_dual,
            "iterations": st.iterations,
            "r_prim": st.res_primal,
            "r_dual": st.res_dual,
            "tau": st.tau,
            "kappa": st.kappa,
            "mu": st.mu,
            "sigma": st.sigma,
            "step_length": st.step_length,
            "cost_primal": st.cost_primal,
            "cost_dual": st.cost_dual,
            "res_primal_inf": st.res_primal_inf,
            "res_dual_inf": st.res_dual_inf,
            "gap_abs": st.gap_abs,
            "gap_rel": st.gap_rel,
            "ktratio": st.ktratio,
            "equil_d": d,
            "equil_e": e,
            "equil_c": c_scale,
            "history": st.history,
        }

    return solve_core


def check_ported(dtype: Optional[str]) -> str:
    """The dtype name a solve runs at ("float64" unless given); raises for
    another dtype.  Every ``direct_solve_method`` the settings accept is
    ported, and each runs at f32 on every cone."""
    dtype = dtype or "float64"
    if dtype not in ("float64", "float32"):
        raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")
    return dtype


class DefaultSolver:
    """Interior-point solver for convex conic programs with quadratic
    objectives (reference: DefaultSolver, default/solver.rs:19-126) with
    zero, nonnegative, second-order, exponential, power, generalized power
    and PSD triangle cones, large sparse PSD cones decomposed into their
    cliques (chordal decomposition): on the dense path at f64 through every
    ported KKT method (the structured Schur paths fall back to LU on the
    nonsymmetric and PSD cones, as in the JAX package), and on the sparse
    multifrontal path, each at f64 and f32 on every cone.  Its data can be
    updated
    between solves (unless presolve or the decomposition changed the
    problem), a solve warm-started and stopped by a callback.  The problem
    saves to and loads from the reference's JSON format, and the report of
    a verbose solve goes to the chosen print target."""

    def __init__(
        self,
        P,
        q,
        A,
        b,
        cones: Sequence[api.ConeSpec],
        settings: Optional[DefaultSettings] = None,
        dtype: Optional[str] = None,
        device=None,
    ):
        self.settings = settings if settings is not None else DefaultSettings()
        self.settings.validate()
        self.timers = Timers()

        self._dtype = check_ported(dtype)
        self._device = resolve_device(device)
        self._callback = None

        with self.timers.scope("setup"):
            q = np.asarray(q, np.float64).ravel()
            b = np.asarray(b, np.float64).ravel()
            P_csc = _to_csc(P, "P")
            A_csc = _to_csc(A, "A")

            # dimension checks (default/solver.rs:129-159)
            n = q.shape[0]
            m = b.shape[0]
            if P_csc.shape != (n, n):
                raise ValueError(f"P must be {n}x{n}, got {P_csc.shape}")
            if A_csc.shape != (m, n):
                raise ValueError(f"A must be {m}x{n}, got {A_csc.shape}")
            cones = tuple(cones)
            m_cones = sum(c.nvars for c in cones)
            if m_cones != m:
                raise ValueError(
                    f"cone dimensions sum to {m_cones}, but A/b have {m} rows"
                )

            # the triu CSC structure of P and the CSC structure of A, for
            # nzval-indexed updates (the internal P is the triu part treated
            # as symmetric)
            import scipy.sparse as sp

            self._P_csc = sp.triu(P_csc, format="csc")
            self._P_csc.sort_indices()
            self._A_csc = A_csc
            self._nnzA = int(A_csc.nnz)

            # large sparse problems (or an explicit request) route to the
            # sparse multifrontal KKT engine and are never densified;
            # everything else uses the dense backends.  On the auto path the
            # post-chordal density re-check and the cost model may send the
            # problem back to the dense path.
            self._sparse = _wants_sparse(self.settings, P_csc, A_csc, n, m, cones)
            if self._sparse:
                self._sparse = self._setup_sparse(q, b, cones)
            if not self._sparse:
                self._setup_dense(
                    _symmetrize_triu(P_csc.toarray()), A_csc.toarray(), q, b, cones,
                )

        self.info = DefaultInfo(linear_solver=self._linear_solver)
        self.solution: Optional[DefaultSolution] = None
        self.equilibration: Optional[EquilibrationData] = None
        self.iteration_history: Optional[np.ndarray] = None
        self._print_stream = sys.stdout
        self._print_buffer = None

    # ------------------------------------------------------------------
    def _setup_sparse(self, q, b, cones) -> bool:
        """Sparse-path setup (the JAX package's solver.py:698-864): the
        scipy-sparse host pipeline and the multifrontal symbolic analysis;
        the problem data stay COO triplets on the device.  Returns False
        where the "auto" route goes back to the dense path: the
        post-chordal density re-check, or the cost model's veto."""
        import scipy.sparse as sp

        from .algebra.coo import COOMat
        from .kkt import sparse as kkt_sparse

        n, m = q.shape[0], b.shape[0]
        auto = self.settings.direct_solve_method != "multifrontal"
        with self.timers.scope("presolve"):
            # cone collapsing (supportedcone.rs:105-161)
            cones_int = api.collapse_cones(cones)

            # presolve reduction (problemdata.rs:85-90); row selection
            # stays sparse via CSR slicing
            A_work = self._A_csc.tocsr()
            self._presolver = presolve.try_presolve(A_work, b, cones_int, self.settings)
            if self._presolver is not None:
                A_work, b, cones_int = presolve.apply_presolve(
                    self._presolver, A_work, b, cones_int
                )

            # cap b at the infinity bound (problemdata.rs:126-131)
            b = np.minimum(b, get_infinity())
            # user-frame copies (after presolve, before the chordal
            # decomposition) for data updating and JSON round trips; the
            # matrices stay in self._P_csc / self._A_csc
            self._cones_int = cones_int
            self._np_q = q.copy()
            self._np_b = b.copy()

            # chordal decomposition of large PSD cones composes with the
            # sparse KKT path: the transform runs on the host, and the
            # decomposed problem -- many small clique cones with sparse
            # coupling rows -- is what the multifrontal engine is built for
            # (reference: problemdata.rs:94-112)
            from .chordal import try_chordal_info

            P_full_csc = _full_from_triu(self._P_csc)
            self._chordal = None
            if any(c.kind == api.PSD for c in cones_int):
                self._chordal = try_chordal_info(A_work, b, cones_int, self.settings)
                if self._chordal is not None:
                    P_s, q, A_s, b, cones_int = self._chordal.decomp_augment(
                        P_full_csc, q, A_work, b, self.settings,
                    )
                    P_full_csc = P_s.tocsc()
                    A_work = A_s.tocsr()

            n_int = P_full_csc.shape[0]
            self._layout = ConeLayout(cones_int)
            perm = self._layout.perm
            A_perm = A_work[perm].tocoo()
            b = b[perm]

        self.n = n
        self.m_full = m
        self.m = self._layout.m
        self._n_int = n_int
        self._torch_dtype = getattr(torch, self._dtype)
        P_sym = P_full_csc.tocoo()
        self._p_is_zero = not (P_sym.nnz and np.any(P_sym.data))
        self._use_pallas = False  # the dense path's LDLᵀ switch; the sparse path ignores it

        # post-chordal density re-check: a PSD problem routed here
        # tentatively, for its PSD blocks, goes back to the dense path if
        # the decomposition did not make it sparse enough
        if auto and any(c.kind == api.PSD for c in cones_int):
            N_est = n_int + self._layout.m
            nnz_est = 2 * P_full_csc.nnz + A_perm.nnz + N_est + _estimate_hs_nnz(cones_int)
            if nnz_est >= _SPARSE_AUTO_MAX_DENSITY * float(N_est) * float(N_est):
                return False

        self._cost_model = _cost_model_for(self._device)
        with self.timers.scope("kktinit"):
            t0 = time.perf_counter()
            self._skkt = kkt_sparse.build(
                self._layout, n_int, P_sym.row.astype(np.int64), P_sym.col.astype(np.int64),
                A_perm.row.astype(np.int64), A_perm.col.astype(np.int64),
                ordering=self.settings.multifrontal_ordering, dtype=self._dtype,
            )
            self._symbolic_seconds = time.perf_counter() - t0
            # auto-mode cost-model veto (ldlsolvers/auto.rs analog): a bad
            # fill/schedule on a medium problem falls back to dense LU
            if auto and _prefer_dense(self._skkt.plan, self._skkt.N, self._cost_model):
                return False
            self._skkt_data = self._skkt.device_data(self._torch_dtype, self._device)
            # DIA metadata where the pattern is banded-compact
            self._P = COOMat.from_coo(P_sym.data, P_sym.row, P_sym.col, (n_int, n_int),
                                      self._torch_dtype, self._device, dia=True)
            self._A = COOMat.from_coo(A_perm.data, A_perm.row, A_perm.col, (self.m, n_int),
                                      self._torch_dtype, self._device, dia=True)
            self._q = self._put(q)
            self._b = self._put(b)
            self._solve_fn = self._build_solve_fn()

        self._linear_solver = LinearSolverInfo(
            name="multifrontal",
            nnzA=self._nnzA,
            nnzL=int(self._skkt.plan.nnzL),
            dim=self._skkt.N,
            cost_model=self._cost_model,
        )
        return True

    def _setup_dense(self, P, A, q, b, cones):
        n, m = q.shape[0], b.shape[0]
        with self.timers.scope("presolve"):
            # cone collapsing (supportedcone.rs:105-161)
            cones_int = api.collapse_cones(cones)

            # presolve reduction (problemdata.rs:85-90)
            self._presolver = presolve.try_presolve(A, b, cones_int, self.settings)
            if self._presolver is not None:
                A, b, cones_int = presolve.apply_presolve(
                    self._presolver, A, b, cones_int
                )

            # cap b at the infinity bound (problemdata.rs:126-131)
            b = np.minimum(b, get_infinity())

            # user-frame copies (after presolve, before the chordal
            # decomposition) for data updating and JSON round trips
            self._cones_int = cones_int
            self._np_P = P
            self._np_q = q.copy()
            self._np_A = A.copy()
            self._np_b = b.copy()

            # chordal decomposition of large sparse PSD cones
            # (problemdata.rs:94-112)
            from .chordal import try_chordal_info

            self._chordal = try_chordal_info(A, b, cones_int, self.settings)
            if self._chordal is not None:
                P, q, A, b, cones_int = self._chordal.decomp_augment(
                    P, q, A, b, self.settings
                )

            self._layout = ConeLayout(cones_int)

            # permute rows so cone groups are contiguous
            perm = self._layout.perm
            A = A[perm, :]
            b = b[perm]

        self.n = n  # original variable count
        self.m_full = m  # original constraint count
        self.m = self._layout.m  # internal (reduced / augmented) count
        self._n_int = P.shape[0]  # internal variable count (chordal adds)
        self._p_is_zero = not np.any(P)
        self._torch_dtype = getattr(torch, self._dtype)

        self._P = self._put(P)
        self._q = self._put(q)
        self._A = self._put(A)
        self._b = self._put(b)

        self._use_pallas = self._device.type == "cuda"

        with self.timers.scope("kktinit"):
            self._solve_fn = self._build_solve_fn()

        N = self._n_int + self.m
        self._linear_solver = LinearSolverInfo(
            name=_resolved_kkt_method(
                self._layout, self.settings, self._torch_dtype,
                self._n_int, self._use_pallas,
            ),
            nnzA=self._nnzA,
            nnzL=N * (N + 1) // 2,  # dense factor
            dim=N,
            cost_model=getattr(self, "_cost_model", None),
        )

    def _put(self, v) -> torch.Tensor:
        """A copy of a host array as a tensor of the solve's dtype on its
        device (never a view of the caller's array)."""
        return torch.tensor(np.asarray(v, np.float64), dtype=self._torch_dtype,
                            device=self._device)

    # ------------------------------------------------------------------
    def solve(self, warm_start=None) -> DefaultSolution:
        """Solve the problem.

        ``warm_start`` (optional) is a previous :class:`DefaultSolution` or
        an (x, s, z) triple in the user frame, used as the initial iterate
        (the reference always cold starts)."""
        t0 = time.perf_counter()
        with self.timers.scope("solve"), full_precision():
            ws = None if warm_start is None else self._warm_iterate(warm_start)
            out = self._solve_fn(self._P, self._q, self._A, self._b, ws)
            out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        solve_time = time.perf_counter() - t0
        self._raw_out = out  # full core outputs (permuted frame)

        status = SolverStatus(int(out["status"]))

        e_user = np.empty(self.m, np.float64)
        e_user[self._layout.perm] = out["equil_e"]
        self.equilibration = EquilibrationData(
            d=np.asarray(out["equil_d"], np.float64),
            e=e_user,
            c=float(out["equil_c"]),
        )

        # undo the cone-group permutation
        z_int = np.empty(self.m, out["z"].dtype)
        s_int = np.empty(self.m, out["s"].dtype)
        z_int[self._layout.perm] = out["z"]
        s_int[self._layout.perm] = out["s"]
        x_int = np.asarray(out["x"], np.float64)

        # undo the chordal decomposition (+ PSD dual completion) before
        # the presolve reversal (solution.rs:92-105)
        if self._chordal is not None:
            x_int, z_int, s_int = self._chordal.decomp_reverse(
                x_int, z_int, s_int, self.settings
            )

        # undo presolve (solution.rs:96-105)
        if self._presolver is not None:
            z, s = presolve.reverse_presolve(self._presolver, z_int, s_int)
        else:
            z, s = z_int, s_int

        self.solution = DefaultSolution(
            x=x_int,
            z=np.asarray(z, np.float64),
            s=np.asarray(s, np.float64),
            status=status,
            obj_val=float(out["obj_val"]),
            obj_val_dual=float(out["obj_val_dual"]),
            solve_time=solve_time,
            iterations=int(out["iterations"]),
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
        )
        self.info = DefaultInfo(
            mu=float(out["mu"]),
            sigma=float(out["sigma"]),
            step_length=float(out["step_length"]),
            iterations=int(out["iterations"]),
            cost_primal=float(out["cost_primal"]),
            cost_dual=float(out["cost_dual"]),
            res_primal=float(out["r_prim"]),
            res_dual=float(out["r_dual"]),
            res_primal_inf=float(out["res_primal_inf"]),
            res_dual_inf=float(out["res_dual_inf"]),
            gap_abs=float(out["gap_abs"]),
            gap_rel=float(out["gap_rel"]),
            ktratio=float(out["ktratio"]),
            solve_time=solve_time,
            status=status,
            linear_solver=self._linear_solver,
        )

        if self.settings.verbose:
            self._print_report(out["history"])
        self.iteration_history = np.asarray(out["history"])

        return self.solution

    # ------------------------------------------------------------------
    def _warm_iterate(self, warm_start):
        """The warm start's (x, s, z) as tensors on the device, s and z in
        the layout's row order (the JAX package's ``_solve_warm``)."""
        if isinstance(warm_start, DefaultSolution):
            x0, s0, z0 = warm_start.x, warm_start.s, warm_start.z
        else:
            x0, s0, z0 = warm_start
        x0 = np.asarray(x0, np.float64).ravel()
        s0 = np.asarray(s0, np.float64).ravel()
        z0 = np.asarray(z0, np.float64).ravel()
        if x0.shape[0] != self.n or s0.shape[0] != self.m_full or z0.shape[0] != self.m_full:
            raise ValueError("warm start has wrong dimensions")
        if self._presolver is not None:
            # map the user-frame iterate through the presolve reduction:
            # eliminated rows carry s = inf, z = 0 and simply drop
            # (presolver.rs:134-154 reversed)
            keep = self._presolver.keep_logical
            s0 = s0[keep]
            z0 = z0[keep]
        if self._chordal is not None:
            # forward-map through the clique transform (per-clique gather
            # and exact/zero overlap split; decomp.decomp_warm_start)
            x0, s0, z0 = self._chordal.decomp_warm_start(x0, s0, z0)
        perm = self._layout.perm
        return self._put(x0), self._put(s0[perm]), self._put(z0[perm])

    # ------------------------------------------------------------------
    # data updating (reference: data_updating.rs:68-160)
    # ------------------------------------------------------------------

    def is_data_update_allowed(self) -> bool:
        """Updates are disallowed after presolve reduction or chordal
        decomposition (data_updating.rs:10-24, 153+)."""
        return self._presolver is None and self._chordal is None

    def _check_update_allowed(self):
        if not self.is_data_update_allowed():
            raise ValueError(
                "problem data cannot be updated after presolve reduction; "
                "construct the solver with presolve_enable=False to use "
                "parametric updates"
            )

    @staticmethod
    def _apply_matrix_update(dense, csc, data, symmetric):
        """Apply a full-matrix / nzval-vector / (index, value) update to the
        host copy ``dense``; ``csc`` is the structure the nzval indices
        refer to."""
        if hasattr(data, "tocsc") or (isinstance(data, np.ndarray) and data.ndim == 2):
            new = _to_csc(data, "update").toarray()
            if symmetric:
                new = _symmetrize_triu(new)
            if new.shape != dense.shape:
                raise ValueError("updated matrix has wrong shape")
            dense[...] = new
            return
        if isinstance(data, tuple) and len(data) == 2:
            idx, vals = data
            idx = np.asarray(idx, np.int64).ravel()
            vals = np.asarray(vals, np.float64).ravel()
        else:
            vals = np.asarray(data, np.float64).ravel()
            if vals.shape[0] != csc.nnz:
                raise ValueError(f"expected {csc.nnz} values for full nzval update")
            idx = np.arange(csc.nnz)
        # map nzval indices -> (row, col) through the stored CSC structure
        rows = csc.indices[idx]
        cols = np.searchsorted(csc.indptr, idx, side="right") - 1
        dense[rows, cols] = vals
        if symmetric:
            dense[cols, rows] = vals

    @staticmethod
    def _apply_vector_update(vec, data):
        if isinstance(data, tuple) and len(data) == 2:
            idx, vals = data
            vec[np.asarray(idx, np.int64).ravel()] = np.asarray(vals, np.float64).ravel()
        else:
            vals = np.asarray(data, np.float64).ravel()
            if vals.shape[0] != vec.shape[0]:
                raise ValueError("updated vector has wrong length")
            vec[...] = vals

    @staticmethod
    def _apply_csc_update(csc, data, name):
        """Sparse-path update: write through the retained CSC structure
        (the analog of the reference's AtoPAPt write-through,
        qdldl.rs:142-149).  The structure must be identical."""
        import scipy.sparse as sp

        if hasattr(data, "tocsc") or (isinstance(data, np.ndarray) and data.ndim == 2):
            new = _to_csc(data, name)
            if name == "P":
                new = sp.triu(new, format="csc")
                new.sort_indices()
            if (
                new.shape != csc.shape
                or new.nnz != csc.nnz
                or not np.array_equal(new.indices, csc.indices)
                or not np.array_equal(new.indptr, csc.indptr)
            ):
                raise ValueError(f"updated {name} must have identical sparsity structure")
            csc.data[:] = new.data
        elif isinstance(data, tuple) and len(data) == 2:
            idx, vals = data
            csc.data[np.asarray(idx, np.int64).ravel()] = np.asarray(vals, np.float64).ravel()
        else:
            vals = np.asarray(data, np.float64).ravel()
            if vals.shape[0] != csc.nnz:
                raise ValueError(f"expected {csc.nnz} values for full nzval update")
            csc.data[:] = vals

    def _push_data(self):
        """Copy the host data to the device; a change of whether P is zero
        rebuilds the solve function, whose start depends on it."""
        perm = self._layout.perm
        self._q = self._put(self._np_q)
        self._b = self._put(np.minimum(self._np_b, get_infinity())[perm])
        if self._sparse:
            # the structure is immutable, so the COO order is the one
            # captured at setup
            P_sym = _full_from_triu(self._P_csc).tocoo()
            A_perm = self._A_csc.tocsr()[perm].tocoo()
            self._P = self._P.with_data(self._put(P_sym.data))
            self._A = self._A.with_data(self._put(A_perm.data))
            p_is_zero = not (P_sym.nnz and np.any(P_sym.data))
        else:
            self._P = self._put(self._np_P)
            self._A = self._put(self._np_A[perm, :])
            p_is_zero = not np.any(self._np_P)
        if p_is_zero != self._p_is_zero:
            self._p_is_zero = p_is_zero
            self._rebuild_solve_fn()

    def _update_matrix(self, name, data):
        if self._sparse:
            self._apply_csc_update(self._P_csc if name == "P" else self._A_csc, data, name)
        elif name == "P":
            self._apply_matrix_update(self._np_P, self._P_csc, data, symmetric=True)
        else:
            self._apply_matrix_update(self._np_A, self._A_csc, data, symmetric=False)

    def update_P(self, data):
        """Update the P matrix: full matrix, full nzval vector of its upper
        triangle, or (nzval-indices, values).  reference:
        data_updating.rs:98-116"""
        self._check_update_allowed()
        self._update_matrix("P", data)
        self._push_data()

    def update_A(self, data):
        """reference: data_updating.rs:118-132"""
        self._check_update_allowed()
        self._update_matrix("A", data)
        self._push_data()

    def update_q(self, data):
        """reference: data_updating.rs:135-146"""
        self._check_update_allowed()
        self._apply_vector_update(self._np_q, data)
        self._push_data()

    def update_b(self, data):
        """reference: data_updating.rs:148-160"""
        self._check_update_allowed()
        self._apply_vector_update(self._np_b, data)
        self._push_data()

    def update_data(self, P=None, q=None, A=None, b=None):
        """Combined update (reference: data_updating.rs:68-86)."""
        self._check_update_allowed()
        if P is not None:
            self._update_matrix("P", P)
        if A is not None:
            self._update_matrix("A", A)
        if q is not None:
            self._apply_vector_update(self._np_q, q)
        if b is not None:
            self._apply_vector_update(self._np_b, b)
        self._push_data()

    # ------------------------------------------------------------------
    # settings and callbacks
    # ------------------------------------------------------------------

    def _build_solve_fn(self):
        sparse_ctx = (self._skkt, self._skkt_data) if self._sparse else None
        return build_solve_core(
            self._layout, self.settings, self._n_int, self._p_is_zero,
            self._torch_dtype, self._use_pallas, callback=self._callback,
            sparse_ctx=sparse_ctx,
        )

    def _rebuild_solve_fn(self):
        self._solve_fn = self._build_solve_fn()

    def update_settings(self, settings: DefaultSettings):
        """Replace settings between solves; structure-determining settings
        are immutable (settings.rs:259-335)."""
        settings.validate_as_update(self.settings)
        self.settings = settings
        self._rebuild_solve_fn()

    def set_termination_callback(self, callback):
        """Install a per-iteration termination callback.  The callback
        receives a ``DefaultInfo`` and returns True to stop the solver
        (reference: callbacks.rs, solver.rs:310-314).  It costs one device
        read per iteration."""

        def host_cb(snapshot):
            info = DefaultInfo(
                mu=float(snapshot["mu"]),
                step_length=float(snapshot["step_length"]),
                iterations=int(snapshot["iterations"]),
                cost_primal=float(snapshot["cost_primal"]),
                cost_dual=float(snapshot["cost_dual"]),
                res_primal=float(snapshot["res_primal"]),
                res_dual=float(snapshot["res_dual"]),
                gap_abs=float(snapshot["gap_abs"]),
                gap_rel=float(snapshot["gap_rel"]),
                ktratio=float(snapshot["ktratio"]),
            )
            return bool(callback(info))

        self._callback = host_cb
        self._rebuild_solve_fn()

    def unset_termination_callback(self):
        self._callback = None
        self._rebuild_solve_fn()

    # ------------------------------------------------------------------
    # JSON problem IO (reference: json.rs)
    # ------------------------------------------------------------------

    def save_to_file(self, path):
        """Write (P, q, A, b, cones, settings) as reference-format JSON: the
        problem after presolve and before the chordal decomposition, as the
        JAX package writes it."""
        from . import json_io

        if self._sparse:
            # stay O(nnz): triu P serializes directly; presolve row
            # selection happens on the CSC structure (json.rs:22-96)
            P, A = self._P_csc, self._A_csc
            if self._presolver is not None:  # match post-presolve b/cones
                keep = np.where(self._presolver.keep_logical)[0]
                A = A.tocsr()[keep, :].tocsc()
        else:
            P, A = self._np_P, self._np_A
        json_io.save_problem(path, P, self._np_q, A, self._np_b, self._cones_int,
                             self.settings)

    @classmethod
    def load_from_file(cls, path, settings: Optional[DefaultSettings] = None, **kwargs):
        """Construct a solver from a reference-format JSON problem file;
        ``kwargs`` (``dtype=``, ``device=``) pass through to the
        constructor, so the solver runs on ``cuda`` unless told otherwise."""
        from . import json_io

        P, q, A, b, cones, s = json_io.load_problem(path, settings)
        return cls(P, q, A, b, cones, s, **kwargs)

    # ------------------------------------------------------------------
    # printing (reference: io/mod.rs print targets, info_print.rs)
    # ------------------------------------------------------------------

    def print_to_stdout(self):
        self._print_stream = sys.stdout
        self._print_buffer = None

    def print_to_file(self, path):
        self._print_stream = open(path, "w")
        self._print_buffer = None

    def print_to_buffer(self):
        self._print_buffer = _io.StringIO()
        self._print_stream = self._print_buffer

    def print_to_stream(self, stream):
        """Route solver output to a caller-supplied writable object
        (reference: io/mod.rs:19-51, the ``Stream`` print-target variant)."""
        if not hasattr(stream, "write"):
            raise TypeError("stream must be a writable object (no .write)")
        self._print_stream = stream
        self._print_buffer = None

    def get_print_buffer(self) -> str:
        if self._print_buffer is None:
            raise ValueError("print_to_buffer() was not enabled")
        return self._print_buffer.getvalue()

    def print_to_sink(self):
        self._print_stream = None
        self._print_buffer = None

    def _print(self, *args, **kwargs):
        if self._print_stream is not None:
            print(*args, file=self._print_stream, **kwargs)

    def _print_report(self, history):  # pragma: no cover - cosmetic
        p = self._print
        p("-------------------------------------------------------------")
        from . import __version__

        p(f"     clarabel_tpu_torch v{__version__}  -  conic IPM on PyTorch/CUDA")
        p("-------------------------------------------------------------")
        L = self._layout
        p(f"problem:  variables n = {self.n}, constraints m = {self.m}")
        p(f"cones:    {list(L.cones)}")
        p(f"settings: dtype = {self._dtype}, device = {self._device}, "
          f"kkt = {self._linear_solver.name}")
        p("iter    pcost        dcost       gap       pres      dres      "
          "k/t       μ        step")
        rows = np.asarray(history)
        for it in range(rows.shape[0]):
            r = rows[it]
            if np.all(np.isnan(r)):
                break
            p(
                f"{it:3d}  {r[0]:+.4e}  {r[1]:+.4e}  {r[3]:.2e}  {r[4]:.2e}"
                f"  {r[5]:.2e}  {r[6]:.2e}  {r[7]:.2e}  {r[8]:.2e}"
            )
        i = self.info
        p("-------------------------------------------------------------")
        p(
            f"status = {i.status.name}, iterations = {i.iterations}, "
            f"obj = {i.cost_primal:.6e}, solve time = {i.solve_time*1e3:.2f} ms"
        )

    def print_timers(self):  # pragma: no cover - cosmetic
        self.timers.print_tree()

    # accessor aliases mirroring the reference Python binding surface
    # (impl_default_py.rs:626-791)
    def get_info(self) -> DefaultInfo:
        return self.info

    def get_solution(self) -> Optional[DefaultSolution]:
        return self.solution

    def get_settings(self) -> DefaultSettings:
        return self.settings

    def profile(self, log_dir):
        """Context manager tracing the next solve(s) with ``torch.profiler``:
        host activity, and the card's kernels when the solver runs on one;
        leaves a Chrome trace (``*.pt.trace.json``) in ``log_dir``."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)))

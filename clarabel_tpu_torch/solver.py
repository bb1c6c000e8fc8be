"""DefaultSolver: the user-facing solver object.

PyTorch port of the dense path of ``clarabel_tpu/solver.py``: host-side
orchestration mirroring the reference setup pipeline (reference:
src/solver/implementations/default/solver.rs:57-126): dimension checks ->
cone collapsing -> presolve -> cone layout (a row permutation groups the
cones by kind) -> one solve on the device covering equilibration, the IPM
loop and solution unscaling.

Problems solve as

    minimize    (1/2) xᵀPx + qᵀx
    subject to  Ax + s = b,   s ∈ K.

The solve runs on a CUDA device unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument the constructor raises.
f64 solves stay on the card, which runs f64 natively (the JAX package sends
them to the host CPU instead).  ``dtype="float32"`` runs where the KKT
method is a structured Schur path ("auto" picks one on the ported cones).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import equilibration, presolve
from .cones import api
from .cones.layout import ConeLayout
from .infbound import get_infinity
from .kkt.dense import _amax0
from .loop import _demoted_kkt_method, _resolved_kkt_method, run_ipm
from .settings import DefaultSettings
from .statuses import SolverStatus
from .timers import Timers

#: direct_solve_method values this port runs ("dense", "qdldl" and "faer"
#: are LU aliases), and the ROADMAP items that port the others
_PORTED_METHODS = ("auto", "lu", "pallas", "schur", "schur_diag", "schur_lr",
                   "dense", "qdldl", "faer")
_METHOD_ITEMS = {"multifrontal": 14}
#: the methods that run at f32: the others need the compensated f32 stack
_F32_METHODS = ("schur_diag", "schur_lr")
#: cone kinds this port runs, and the ROADMAP items that port the others
_PORTED_CONES = (api.ZERO, api.NONNEGATIVE, api.SOC)
_CONE_ITEMS = {api.EXP: 10, api.POW: 10, api.GENPOW: 10, api.PSD: 11}


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
    dim: int = 0  # KKT dimension
    #: the JAX package's sparse-vs-dense cost model; this port has no
    #: sparse path, so it is always None
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


def _symmetrize_triu(P: np.ndarray) -> np.ndarray:
    """Use only the upper triangle of P, treated as symmetric.

    reference: problemdata.rs:79-81 (to_triu) + sym_up views.
    """
    U = np.triu(P)
    return U + np.triu(P, 1).T


# the JAX package's gate for its sparse multifrontal auto route
# (clarabel_tpu/solver.py:320-382); the port raises where it would route
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
    """Whether the JAX package would route this problem to its sparse
    multifrontal KKT engine (clarabel_tpu/solver.py:348-382)."""
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
                     use_pallas: bool = False):
    """The solve function (P, q, A, b) -> outputs, with the same output
    dictionary as the JAX package's (clarabel_tpu/solver.py:246-272).  The
    tensors stay on their device.  It solves one problem, or a batch of
    problems when the data carry a leading batch dimension (P [B, n, n],
    q [B, n], A [B, m, n], b [B, m]); every output then has it too."""

    def solve_core(P, q, A, b):
        triu_mask = torch.triu(torch.ones((n, n), dtype=dtype, device=P.device))
        # unscaled inf-norms of the linear terms, cached before
        # equilibration (problemdata.rs:147-148)
        normq = _amax0(q)
        normb = _amax0(b)

        P, q, A, b, d, e, c_scale = equilibration.equilibrate(
            layout, settings, P, q, A, b, triu_mask
        )
        dinv, einv, cinv = 1.0 / d, 1.0 / e, 1.0 / c_scale
        equil = (d, e, dinv, einv, cinv)

        st = run_ipm(
            layout, settings, P, q, A, b, equil, normq, normb, p_is_zero, dtype,
            use_pallas=use_pallas,
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


def _not_ported(what: str, item):
    return NotImplementedError(
        f"{what} is not ported to clarabel_tpu_torch yet (ROADMAP.md Queue 1 item {item})"
    )


def check_ported(settings: DefaultSettings, dtype: Optional[str]) -> str:
    """The dtype name a solve runs at ("float64" unless given); raises for a
    dtype or a ``direct_solve_method`` this port does not run yet."""
    dtype = dtype or "float64"
    if dtype not in ("float64", "float32"):
        raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")
    method = settings.direct_solve_method
    if method not in _PORTED_METHODS:
        raise _not_ported(f"direct_solve_method={method!r}", _METHOD_ITEMS.get(method, 5))
    return dtype


def check_ported_dtype(layout: ConeLayout, settings: DefaultSettings, dtype: str,
                       n: int, use_pallas: bool) -> None:
    """Raises for an f32 solve whose KKT method, resolved and demoted as
    ``_kkt_prepare`` runs it, is not a structured Schur path: f32 through
    "lu", "pallas", "schur" or an LU alias needs the compensated f32 stack."""
    if dtype != "float32":
        return
    method = _demoted_kkt_method(layout, _resolved_kkt_method(
        layout, settings, torch.float32, n, use_pallas))
    if method not in _F32_METHODS:
        raise _not_ported(
            f"dtype='float32' through the {method!r} KKT method (the compensated "
            "f32 refinement and the double-float LU)", "12b")


def check_ported_cones(cones_int) -> None:
    """Raises for a (collapsed) cone this port does not run yet."""
    for c in cones_int:
        if c.kind not in _PORTED_CONES:
            raise _not_ported(f"the {c!r} cone", _CONE_ITEMS[c.kind])


class DefaultSolver:
    """Interior-point solver for convex conic programs with quadratic
    objectives (reference: DefaultSolver, default/solver.rs:19-126), on the
    dense path with zero, nonnegative and second-order cones: at f64 through
    every ported KKT method, at f32 through "schur_diag" and "schur_lr"."""

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

        self._dtype = check_ported(self.settings, dtype)
        self._device = resolve_device(device)

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

            self._nnzA = int(A_csc.nnz)

            if _wants_sparse(self.settings, P_csc, A_csc, n, m, cones):
                raise _not_ported("the sparse multifrontal auto route", 14)
            self._setup_dense(
                _symmetrize_triu(P_csc.toarray()), A_csc.toarray(), q, b, cones,
            )

        self.info = DefaultInfo(linear_solver=self._linear_solver)
        self.solution: Optional[DefaultSolution] = None
        self.equilibration: Optional[EquilibrationData] = None
        self.iteration_history: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _setup_dense(self, P, A, q, b, cones):
        n, m = q.shape[0], b.shape[0]
        with self.timers.scope("presolve"):
            # cone collapsing (supportedcone.rs:105-161)
            cones_int = api.collapse_cones(cones)
            check_ported_cones(cones_int)

            # presolve reduction (problemdata.rs:85-90)
            self._presolver = presolve.try_presolve(A, b, cones_int, self.settings)
            if self._presolver is not None:
                A, b, cones_int = presolve.apply_presolve(
                    self._presolver, A, b, cones_int
                )

            # cap b at the infinity bound (problemdata.rs:126-131)
            b = np.minimum(b, get_infinity())

            # chordal decomposition of large sparse PSD cones
            # (problemdata.rs:94-112): never applies to the cones ported
            from .chordal import try_chordal_info

            self._chordal = try_chordal_info(A, b, cones_int, self.settings)

            self._layout = ConeLayout(cones_int)

            # permute rows so cone groups are contiguous
            perm = self._layout.perm
            A = A[perm, :]
            b = b[perm]

        self.n = n  # original variable count
        self.m_full = m  # original constraint count
        self.m = self._layout.m  # internal (reduced) count
        self._n_int = P.shape[0]
        self._p_is_zero = not np.any(P)
        self._torch_dtype = getattr(torch, self._dtype)

        put = lambda v: torch.as_tensor(
            np.asarray(v, np.float64), dtype=self._torch_dtype, device=self._device
        )
        self._P = put(P)
        self._q = put(q)
        self._A = put(A)
        self._b = put(b)

        self._use_pallas = self._device.type == "cuda"
        check_ported_dtype(self._layout, self.settings, self._dtype, self._n_int,
                           self._use_pallas)

        with self.timers.scope("kktinit"):
            self._solve_fn = build_solve_core(
                self._layout, self.settings, self._n_int,
                self._p_is_zero, self._torch_dtype, self._use_pallas,
            )

        N = self._n_int + self.m
        self._linear_solver = LinearSolverInfo(
            name=_resolved_kkt_method(
                self._layout, self.settings, self._torch_dtype,
                self._n_int, self._use_pallas,
            ),
            nnzA=self._nnzA,
            nnzL=N * (N + 1) // 2,  # dense factor
            dim=N,
        )

    # ------------------------------------------------------------------
    def solve(self) -> DefaultSolution:
        """Solve the problem (a cold start, as the reference always does)."""
        t0 = time.perf_counter()
        with self.timers.scope("solve"), full_precision():
            out = self._solve_fn(self._P, self._q, self._A, self._b)
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
    # printing (reference: info_print.rs)
    # ------------------------------------------------------------------

    def _print_report(self, history):  # pragma: no cover - cosmetic
        p = print
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

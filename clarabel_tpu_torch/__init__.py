"""clarabel_tpu_torch: the interior-point conic solver on PyTorch and CUDA.

A port of ``clarabel_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
module for module.  It carries the dense single-problem solve over zero,
nonnegative, second-order, exponential, power, generalized power and PSD
triangle cones (large sparse PSD cones decomposed into their cliques), with
data updates, warm starts and termination callbacks: Ruiz equilibration, the
homogeneous-embedding IPM with Mehrotra predictor-corrector steps and
Nesterov-Todd scalings, certificate-producing infeasibility detection, and
its KKT backends -- pivoted LU (``direct_solve_method="lu"``, "auto" at f64),
the hand-written quasidefinite LDLᵀ CUDA kernels (``"pallas"``, the name the
JAX package gives its TPU kernel) and the Schur-complement Cholesky paths
(``"schur"``, ``"schur_diag"`` and ``"schur_lr"``, "auto" at f32, the only
f32 paths) -- and the batched solve of many problems of one structure
(:class:`BatchSolver`), which runs the same loop on a leading batch
dimension.

Solves run on a CUDA device unless ``device="cpu"`` is passed; on the CPU the
LDLᵀ kernels' plain PyTorch versions run in their place.
"""

from .cones.api import (
    ExponentialConeT,
    GenPowerConeT,
    NonnegativeConeT,
    PowerConeT,
    PSDTriangleConeT,
    SecondOrderConeT,
    ZeroConeT,
)
from .infbound import default_infinity, get_infinity, set_infinity
from .parallel import BatchSolution, BatchSolver
from .settings import DefaultSettings, SettingsError
from .solver import DefaultInfo, DefaultSolution, DefaultSolver
from .statuses import SolverStatus

__version__ = "0.6.0"

__all__ = [
    "DefaultSolver",
    "BatchSolver",
    "BatchSolution",
    "DefaultSettings",
    "DefaultSolution",
    "DefaultInfo",
    "SolverStatus",
    "SettingsError",
    "ZeroConeT",
    "NonnegativeConeT",
    "SecondOrderConeT",
    "ExponentialConeT",
    "PowerConeT",
    "GenPowerConeT",
    "PSDTriangleConeT",
    "get_infinity",
    "set_infinity",
    "default_infinity",
    "__version__",
]

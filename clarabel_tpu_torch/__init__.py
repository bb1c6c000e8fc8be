"""clarabel_tpu_torch: the interior-point conic solver on PyTorch and CUDA.

A port of ``clarabel_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
module for module.  This slice carries the dense single-problem solve in f64
over zero, nonnegative and second-order cones: Ruiz equilibration, the
homogeneous-embedding IPM with Mehrotra predictor-corrector steps and
Nesterov-Todd scalings, certificate-producing infeasibility detection, and
two KKT backends — pivoted LU (``direct_solve_method="auto"`` or ``"lu"``)
and the hand-written quasidefinite LDLᵀ CUDA kernels
(``direct_solve_method="pallas"``, the name the JAX package gives its TPU
kernel).

Solves run on a CUDA device unless ``device="cpu"`` is passed; on the CPU the
LDLᵀ kernels' plain PyTorch versions run in their place.
"""

from .cones.api import NonnegativeConeT, SecondOrderConeT, ZeroConeT
from .infbound import default_infinity, get_infinity, set_infinity
from .settings import DefaultSettings, SettingsError
from .solver import DefaultInfo, DefaultSolution, DefaultSolver
from .statuses import SolverStatus

__version__ = "0.2.0"

__all__ = [
    "DefaultSolver",
    "DefaultSettings",
    "DefaultSolution",
    "DefaultInfo",
    "SolverStatus",
    "SettingsError",
    "ZeroConeT",
    "NonnegativeConeT",
    "SecondOrderConeT",
    "get_infinity",
    "set_infinity",
    "default_infinity",
    "__version__",
]

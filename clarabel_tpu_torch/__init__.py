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
dimension; and, for a large sparse problem, the sparse multifrontal KKT
path (``"multifrontal"``, or ``"auto"`` past its size and density gate),
which never densifies the KKT system and factors its fronts' diagonal
blocks with the same hand-written LDLᵀ kernel; and the batched solve of
many sparse problems of one sparsity pattern through one multifrontal plan
(:class:`SparseBatchSolver`).  Both batch solvers split their lanes over the
ranks of a ``torch.distributed`` device mesh (``mesh=``), and
:class:`ShardedRowSolver` shards one tall problem's constraint rows over
one, A never gathered (``parallel/distributed.py`` starts the process group
and builds the mesh).

Around the solvers sits the JAX package's host surface: problems saved to
and loaded from the reference's JSON format (``DefaultSolver.save_to_file``,
``DefaultSolver.load_from_file``; files cross between the two packages),
print targets (``print_to_buffer``, ``print_to_file``, ``print_to_stream``,
``print_to_sink``), accessors, ``print_timers`` and a ``torch.profiler``
trace (``DefaultSolver.profile``); :func:`buildinfo`; the native C++
symbolic engine (``native.py``), which the sparse path's and the chordal
decomposition's symbolic analyses run through when ``g++`` has built it;
and the C ABI of ``include/clarabel_tpu.h`` (``capi_support.py``,
``capi/capi.cpp``), both built with ``g++`` at first use into ``build/``.

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
from .buildinfo import buildinfo, print_buildinfo
from .infbound import default_infinity, get_infinity, set_infinity
from .parallel import BatchSolution, BatchSolver, ShardedRowSolver, SparseBatchSolver, distributed
from .settings import DefaultSettings, SettingsError
from .solver import DefaultInfo, DefaultSolution, DefaultSolver
from .statuses import SolverStatus

__version__ = "0.10.0"

__all__ = [
    "DefaultSolver",
    "BatchSolver",
    "BatchSolution",
    "SparseBatchSolver",
    "ShardedRowSolver",
    "distributed",
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
    "buildinfo",
    "print_buildinfo",
    "__version__",
]

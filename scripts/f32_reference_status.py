#!/usr/bin/env python3
"""The JAX package's own f32 outcome on chip_smoke.py's phase 3i, 3j and 3k problems.

Where an f32 solve of the port misses ``Solved`` on the card, this script
solves the same data (chip_smoke.py's builders, the same seed) with the JAX
package at f32 on the CPU, through the same KKT method, its Pallas kernels
in interpret mode, and prints its status, iterations and objective (the
entropy batch's lanes: scripts/f32_entropy_lanes.py).  A batch problem
(phase 3j's SDP batch, ``sdp64``) goes through the JAX package's
BatchSolver and prints each lane that ends short of ``Solved``; with
``--lanes`` the named lanes go one by one through DefaultSolver, each with
its distance from the generator's x*.  Phase 3k's sparse problems (the
banded QP and SDP, the expanded SOC, and the sparse batches
``sparse_qp_b32``, ``sparse_qp_b512`` and ``nn_soc_b64``, which go through
the JAX package's SparseBatchSolver) take "multifrontal" unless
``--method`` says otherwise.  It imports JAX and is not part of the port.

    JAX_PLATFORMS=cpu python3 scripts/f32_reference_status.py \\
        [--seed S] [--problem socp] [--method pallas] [--dtype float32]
        [--lanes 922,1133]
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

import clarabel_tpu as ct  # noqa: E402
import clarabel_tpu.kkt.pallas_ldl as jax_pallas_ldl  # noqa: E402
import chip_smoke  # noqa: E402  (the problem builders)
from clarabel_tpu_torch import convert  # noqa: E402

#: phase 3i's problems, as chip_smoke.f32_dense_phase builds them
PROBLEMS = {
    "qp": lambda seed: chip_smoke.portfolio_qp(1000, 50, seed),
    "socp": lambda seed: chip_smoke.portfolio_socp(500, 50, seed + 1),
    "small_qp": lambda seed: chip_smoke.portfolio_qp(100, 10, seed + 2),
    "geomean": lambda seed: chip_smoke.geomean_allocation(16, 4, 16, seed + 22),
    "entropy": lambda seed: chip_smoke.entropy_max(500, 20, 20, seed + 20),
    "pnorm": lambda seed: chip_smoke.pnorm_regression(300, 100, 1.5, seed + 21),
    # phase 3j's (and 3e's) SDP batches at B = 64 and 2048, N = 58, with
    # the generator's x*
    "sdp64": lambda seed: chip_smoke.sdp_batch(64, 16, 4, seed + 32 + 64, optimum=True),
    "sdp2048": lambda seed: chip_smoke.sdp_batch(2048, 16, 4, seed + 32 + 2048, optimum=True),
    # phase 3k's sparse problems
    "banded_qp": lambda seed: chip_smoke.banded_qp(20000, seed + 40),
    "banded_sdp": lambda seed: chip_smoke.banded_sdp(250),
    "soc300": lambda seed: chip_smoke.expanded_soc(300),
    "sparse_qp_b32": lambda seed: chip_smoke.sparse_qp_batch(32, 1000, seed + 50),
    "sparse_qp_b512": lambda seed: chip_smoke.sparse_qp_batch(512, 1000, seed + 51),
    "nn_soc_b64": lambda seed: chip_smoke.nn_soc_batch(64, 500, seed + 52),
}
#: the sparse problems' method when --method is not given
SPARSE = {"banded_qp", "banded_sdp", "soc300", "sparse_qp_b32", "sparse_qp_b512", "nn_soc_b64"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--problem", default="socp", choices=sorted(PROBLEMS))
    parser.add_argument("--method", help='the KKT method ("pallas", or "multifrontal" for '
                        "phase 3k's sparse problems, unless given)")
    parser.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    parser.add_argument("--lanes", help="solve these lanes of a batch problem one by one "
                        "through DefaultSolver (comma-separated) and print each lane's "
                        "distance from x*")
    args = parser.parse_args()
    if args.method is None:
        args.method = "multifrontal" if args.problem in SPARSE else "pallas"
    jax_pallas_ldl.make_ldl_factor = functools.partial(jax_pallas_ldl.make_ldl_factor,
                                                       interpret=True)
    made = PROBLEMS[args.problem](args.seed)
    (P, q, A, b, cones), x_star = made if len(made) == 2 else (made, None)
    # the builders return the port's cones; the JAX package's from their specs
    jcones = [ct.cones.api.ConeSpec(kind, dim, alpha=params.get("alpha", ()),
                                    dim2=params.get("dim2", 0))
              for kind, dim, params in convert.cone_specs(cones)]
    sparse_batch = isinstance(P, list)  # one matrix per lane: SparseBatchSolver
    verbose = not sparse_batch and P.ndim == 2  # a batch prints no per-iteration table
    settings = (ct.DefaultSettings.for_float32(verbose=verbose, direct_solve_method=args.method)
                if args.dtype == "float32"
                else ct.DefaultSettings(verbose=verbose, direct_solve_method=args.method))
    t0 = time.perf_counter()
    if sparse_batch:
        if args.lanes:
            for i in map(int, args.lanes.split(",")):
                sol = ct.DefaultSolver(P[i], q[i], A[i], b[i], jcones, settings, dtype=args.dtype,
                                       device=jax.devices("cpu")[0]).solve()
                print(f"{args.problem} lane {i} {args.method} {args.dtype} alone: "
                      f"{sol.status.name}, {sol.iterations} iterations, objective "
                      f"{sol.obj_val!r}, {time.perf_counter() - t0:.1f} s")
            return 0
        sol = ct.SparseBatchSolver(P, q, A, b, jcones, settings, dtype=args.dtype,
                                   device=jax.devices("cpu")[0]).solve()
        names = [s.name for s in sol.statuses()]
        short = {i: n for i, n in enumerate(names) if n != "Solved"}
        print(f"{args.problem} SparseBatchSolver {args.dtype}: {len(names) - len(short)}/"
              f"{len(names)} Solved, short {short}, iterations {list(sol.iterations)}, "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    if args.lanes:
        for i in map(int, args.lanes.split(",")):
            solver = ct.DefaultSolver(P[i], q[i], A[i], b[i], jcones, settings, dtype=args.dtype,
                                      device=jax.devices("cpu")[0])
            sol = solver.solve()
            print(f"{args.problem} lane {i} {args.method} {args.dtype}: {sol.status.name}, "
                  f"{sol.iterations} iterations, max|x - x*| "
                  f"{abs(np.asarray(sol.x) - x_star[i]).max():.3e}, gap_rel "
                  f"{solver.info.gap_rel:.2e}, {time.perf_counter() - t0:.1f} s")
        return 0
    if P.ndim == 3:
        sol = ct.BatchSolver(P, q, A, b, jcones, settings, dtype=args.dtype,
                             device=jax.devices("cpu")[0]).solve()
        names = [s.name for s in sol.statuses()]
        short = {i: n for i, n in enumerate(names) if n != "Solved"}
        print(f"{args.problem} {args.method} {args.dtype}: {len(names) - len(short)}/"
              f"{len(names)} Solved, short {short}, iterations {list(sol.iterations)}, "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    solver = ct.DefaultSolver(P, q, A, b, jcones, settings, dtype=args.dtype,
                              device=jax.devices("cpu")[0])
    sol = solver.solve()
    print(f"{args.problem} {args.method} {args.dtype}: {sol.status.name}, {sol.iterations} "
          f"iterations, objective {sol.obj_val!r}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The JAX package's own f32 outcome on chip_smoke.py's phase 3i problems.

Where an f32 solve of the port misses ``Solved`` on the card, this script
solves the same data (chip_smoke.py's builders, the same seed) with the JAX
package at f32 on the CPU, through the same KKT method, its Pallas kernels
in interpret mode, and prints its status, iterations and objective (the
entropy batch's lanes: scripts/f32_entropy_lanes.py).  It imports JAX and
is not part of the port.

    JAX_PLATFORMS=cpu python3 scripts/f32_reference_status.py \\
        [--seed S] [--problem socp] [--method pallas] [--dtype float32]
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

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
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--problem", default="socp", choices=sorted(PROBLEMS))
    parser.add_argument("--method", default="pallas")
    parser.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    args = parser.parse_args()
    jax_pallas_ldl.make_ldl_factor = functools.partial(jax_pallas_ldl.make_ldl_factor,
                                                       interpret=True)
    P, q, A, b, cones = PROBLEMS[args.problem](args.seed)
    # the builders return the port's cones; the JAX package's from their specs
    jcones = [ct.cones.api.ConeSpec(kind, dim, alpha=params.get("alpha", ()),
                                    dim2=params.get("dim2", 0))
              for kind, dim, params in convert.cone_specs(cones)]
    settings = (ct.DefaultSettings.for_float32(verbose=True, direct_solve_method=args.method)
                if args.dtype == "float32"
                else ct.DefaultSettings(verbose=True, direct_solve_method=args.method))
    t0 = time.perf_counter()
    solver = ct.DefaultSolver(P, q, A, b, jcones, settings, dtype=args.dtype,
                              device=jax.devices("cpu")[0])
    sol = solver.solve()
    print(f"{args.problem} {args.method} {args.dtype}: {sol.status.name}, {sol.iterations} "
          f"iterations, objective {sol.obj_val!r}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

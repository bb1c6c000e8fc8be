#!/usr/bin/env python3
"""Which lanes of chip_smoke.py phase 3g's NN + SOC batch end AlmostSolved,
in the JAX package and in the port.

Builds the batch from its default seed (B = 64, n = 500, P = I, A = [I; I],
NonnegativeConeT(500) + SecondOrderConeT(500) with the cone's radius 2 --
the JAX package's test_sparse_batch_socp_lane at scale; KKT N = 1502 with
the SOC's rank-2 expansion) and solves it on the CPU at f64 through the JAX
package's SparseBatchSolver and through the port's.  For every lane that
either batch leaves short of Solved it also solves the lane alone through
each package's DefaultSolver, "multifrontal" and "lu".  It prints the
lanes by status and iteration count for each batch and the lone solves'
statuses and iterations, so the phase's gate (every lane in the Solved
tier, the Solved lanes' host KKT residuals at most 1e-7) can be read
against what the reference does with the same data.

    python3 scripts/sparse_batch_soc_statuses.py [--seed S] [--out FILE]

About 3 minutes on an 8-core CPU; the JAX package runs with
``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    parser.add_argument("--out")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import clarabel_tpu as ct
    import clarabel_tpu_torch as tt
    import chip_smoke

    P, q, A, b, _ = chip_smoke.nn_soc_batch(64, 500, args.seed + 52)
    n = q.shape[1]
    packages = {
        "jax": (ct, [ct.NonnegativeConeT(n), ct.SecondOrderConeT(n)], {}),
        "port": (tt, [tt.NonnegativeConeT(n), tt.SecondOrderConeT(n)], dict(device="cpu")),
    }
    report = {}
    short = set()
    for name, (pkg, cones, kw) in packages.items():
        settings = pkg.DefaultSettings(verbose=False, direct_solve_method="multifrontal")
        sol = pkg.SparseBatchSolver(P, q, A, b, cones, settings, **kw).solve()
        lanes = [(int(i), pkg.SolverStatus(int(s)).name, int(it))
                 for i, (s, it) in enumerate(zip(sol.status, sol.iterations))]
        report[name] = dict(batch=lanes, iterations=np.bincount(sol.iterations).tolist())
        short |= {i for i, status, _ in lanes if status != "Solved"}
        print(f"{name} SparseBatchSolver: lanes not Solved "
              f"{[lane for lane in lanes if lane[1] != 'Solved']}; lanes by iterations "
              f"(0, 1, 2, ...) {report[name]['iterations']}", flush=True)
    for name, (pkg, cones, kw) in packages.items():
        report[name]["alone"] = {}
        for i in sorted(short):
            for method in ("multifrontal", "lu"):
                settings = pkg.DefaultSettings(verbose=False, direct_solve_method=method)
                one = pkg.DefaultSolver(P[i], q[i], A[i], b[i], cones, settings, **kw).solve()
                report[name]["alone"][f"{i} {method}"] = (one.status.name, one.iterations)
                print(f"{name} DefaultSolver lane {i} {method}: {one.status.name}, "
                      f"{one.iterations} iterations", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

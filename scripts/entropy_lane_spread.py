#!/usr/bin/env python3
"""How far apart rounding alone puts the iteration counts of the lanes
that chip_smoke.py solves as one BatchSolver batch: phase 3d's entropy
lanes, or (``--problem sdp``) phase 3e's SDP lanes.

Builds chip_smoke.py's entropy batch (B = 512 maximizations of n = 40,
p = q = 4, KKT N = 208, one draw of (F, g, G, h) per lane, from its
default seed), or its SDP batch (the JAX bench's strictly complementary
SDP at n = 16, NonnegativeConeT(32) + PSDTriangleConeT(4), N = 58, B =
2048, from its default seed), and solves it on the CPU at f64 through the JAX package's
BatchSolver -- "auto" (pivoted LU) and "pallas" (the LDLᵀ kernel in
interpret mode), in chunks of lanes -- and through the port's BatchSolver
(the plain twins).  For lanes 0, B/2, B - 1 and the slowest lane under
"pallas" it also solves each lane alone through each package's
DefaultSolver.  It prints, for each package, the lanes by the difference
of their iteration counts (0, 1, 2, ...): LU against LDLᵀ in one batch,
and a lane alone against the same lane in the batch through one backend.
The JAX package's largest difference is the allowance chip_smoke.py gives
each lane of that batch on the card (ENTROPY_ITERATIONS_APART,
SDP_ITERATIONS_APART).

    python3 scripts/entropy_lane_spread.py [--problem entropy|sdp] [--lanes B]
                                           [--chunk C] [--out FILE]

About 6 minutes at the entropy defaults (B = 512, C = 64) on an 8-core
CPU; the JAX package runs with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the problem builder)
import clarabel_tpu as ct  # noqa: E402
import clarabel_tpu.kkt.pallas_ldl as jax_pallas_ldl  # noqa: E402
import clarabel_tpu_torch as tt  # noqa: E402

# the Pallas kernel runs in interpret mode on the CPU, as the tests run it
jax_pallas_ldl.make_ldl_factor = functools.partial(jax_pallas_ldl.make_ldl_factor,
                                                   interpret=True)

N_VARS, P_ROWS, Q_ROWS, SEED = 40, 4, 4, 23  # chip_smoke.py's phase 3d at --seed 0
SDP_N, SDP_DMAT, SDP_SEED = 16, 4, 32  # phase 3e at --seed 0: seed + 32 + B
METHODS = ("auto", "pallas")


def _problem(name, lanes):
    """(P, q, A, b, the port's cones, the JAX package's cones)."""
    if name == "entropy":
        P, q, A, b, cones = chip_smoke.entropy_batch(lanes, N_VARS, P_ROWS, Q_ROWS, SEED)
        jax_cones = [ct.ExponentialConeT()] * N_VARS + [ct.ZeroConeT(P_ROWS),
                                                         ct.NonnegativeConeT(Q_ROWS)]
    else:
        P, q, A, b, cones = chip_smoke.sdp_batch(lanes, SDP_N, SDP_DMAT, SDP_SEED + lanes)
        jax_cones = [ct.NonnegativeConeT(2 * SDP_N), ct.PSDTriangleConeT(SDP_DMAT)]
    return P, q, A, b, cones, jax_cones


def _histogram(a, b):
    return np.bincount(np.abs(np.asarray(a) - np.asarray(b))).tolist()


def batch_iterations(package, P, q, A, b, cones, method, chunk):
    """Per-lane iteration counts and statuses of one package's BatchSolver
    over the lanes, ``chunk`` lanes per solve."""
    iterations, statuses = [], []
    for lo in range(0, len(q), chunk):
        hi = lo + chunk
        settings = package.DefaultSettings(verbose=False, direct_solve_method=method)
        extra = {"device": "cpu"} if package is tt else {}
        sol = package.BatchSolver(P[lo:hi], q[lo:hi], A[lo:hi], b[lo:hi], cones, settings,
                                  **extra).solve()
        iterations.extend(int(i) for i in np.asarray(sol.iterations))
        statuses.extend(int(s) for s in np.asarray(sol.status))
    return np.array(iterations), statuses


def alone_iterations(package, P, q, A, b, cones, method, lanes):
    extra = {"device": "cpu"} if package is tt else {}
    settings = package.DefaultSettings(verbose=False, direct_solve_method=method)
    return [package.DefaultSolver(P[i], q[i], A[i], b[i], cones, settings, **extra)
            .solve().iterations for i in lanes]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--problem", choices=("entropy", "sdp"), default="entropy")
    parser.add_argument("--lanes", type=int)
    parser.add_argument("--chunk", type=int, default=64)
    parser.add_argument("--out", help="also write the readings to this JSON file")
    args = parser.parse_args(argv)
    if args.lanes is None:
        args.lanes = 512 if args.problem == "entropy" else 2048

    P, q, A, b, port_cones, jax_cones = _problem(args.problem, args.lanes)
    out = {}
    for name, package, cones in (("jax", ct, jax_cones), ("port", tt, port_cones)):
        t0 = time.perf_counter()
        its = {}
        for method in METHODS:
            its[method], statuses = batch_iterations(package, P, q, A, b, cones, method,
                                                     args.chunk)
            solved = sum(s == int(package.SolverStatus.Solved) for s in statuses)
            print(f"{name} {method}: {solved}/{args.lanes} Solved, iterations "
                  f"{its[method].min()}-{its[method].max()} (sum {its[method].sum()})", flush=True)
        lanes = sorted({0, args.lanes // 2, int(np.argmax(its["pallas"])), args.lanes - 1})
        alone = {m: alone_iterations(package, P, q, A, b, cones, m, lanes) for m in METHODS}
        reading = {
            "backends": _histogram(its["pallas"], its["auto"]),
            "lanes": lanes,
            "alone_vs_batch": {m: _histogram(alone[m], its[m][lanes]) for m in METHODS},
            "alone": {m: [(a, int(its[m][i])) for a, i in zip(alone[m], lanes)] for m in METHODS},
            "seconds": time.perf_counter() - t0,
        }
        out[name] = dict(reading, iterations={m: its[m].tolist() for m in METHODS})
        print(f"{name}: lanes by |pallas - auto| iterations (0, 1, 2, ...): "
              f"{reading['backends']}", flush=True)
        print(f"{name}: lanes {lanes} (alone, in the batch) iterations {reading['alone']}; "
              f"by |alone - batch| {reading['alone_vs_batch']}", flush=True)
    both = [i for i in range(args.lanes)
            if any(out["jax"]["iterations"][m][i] != out["port"]["iterations"][m][i]
                   for m in METHODS)]
    print(f"lanes whose iterations differ between the packages in either backend: "
          f"{len(both)}/{args.lanes}; by |port - jax| (0, 1, 2, ...): " + ", ".join(
              f"{m} {_histogram(out['port']['iterations'][m], out['jax']['iterations'][m])}"
              for m in METHODS))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

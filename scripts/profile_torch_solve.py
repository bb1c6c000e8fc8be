#!/usr/bin/env python3
"""Where the time of one clarabel_tpu_torch solve goes on a CUDA card.

Solves the portfolio problems of chip_smoke.py (QP: n = 1000, k = 50,
N = 2001; SOCP: n = 500, k = 50, N = 1552; the small QP: n = 100, k = 10,
N = 201, whose "pallas" solve runs the unblocked kernel) and, through
BatchSolver, the JAX bench's box-QP batch (n = 32, m = 64, B = 2048, KKT
N = 96) once through each f64 KKT backend ("pallas" and "auto"), then the
box-QP batch and the JAX bench's SOCP batch (n = 32, one
SecondOrderConeT(33), B = 1024) at f32 through "auto" (the Schur paths
"schur_diag" and "schur_lr"), chip_smoke.py's entropy maximization
(n = 500, 500 exponential cones, N = 2540) and its PSD problems -- the
max-cut SDP (one PSDTriangleConeT(100), N = 10200), the chordal max-cut
(PSDTriangleConeT(124) of a sparse graph, decomposed into its cliques) and
the bench's SDP batch at B = 2048 (N = 58) -- through "pallas" and "auto",
each under torch.profiler after one untraced warm-up solve, and prints for
each: the wall time, the summed device time of the kernels, the device's
idle share (1 - device time / wall time; the kernels of one stream do not
overlap), the kernels that take the most device time, and, from a second
untraced solve, the device reads through ``timers.host_read`` and every
device wait ``torch.cuda.set_sync_debug_mode`` reports (the reads among
them; on PSD layouts the SVDs and eigenvalue solves add theirs).  For the
entropy and max-cut solves it also splits the host's wall time over the
loop's parts (an untraced solve with each part's function wrapped by a host
clock: inclusive times, device waits included) and counts the device
reads.  Then it profiles the LDLᵀ factor alone, f64: the blocked variant
at the large problems' KKT shapes (1 x 2001², 1 x 1552², 1 x 2540²,
1 x 10200²) and the unblocked one at 1 x 201², 8 x 200², 1 x 256² and the
batches' 2048 x 96² and 2048 x 58², and prints each kernel's device time
and launches per factor.

    python3 scripts/profile_torch_solve.py [--seed S] [--top K] [--out FILE]
                                           [--problems LABEL,...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the problem builders)
import clarabel_tpu_torch as tt  # noqa: E402
from clarabel_tpu_torch.solver import full_precision  # noqa: E402


def profile_solve(problem, method, top, solver_type=tt.DefaultSolver, dtype="float64"):
    P, q, A, b, cones = problem
    settings = (tt.DefaultSettings.for_float32(verbose=False, direct_solve_method=method)
                if dtype == "float32"
                else tt.DefaultSettings(verbose=False, direct_solve_method=method))
    make = lambda: solver_type(P, q, A, b, cones, settings, dtype=dtype, device="cuda")
    make().solve()  # warm-up
    solver = make()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sol = solver.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    kernels = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    waits = device_waits(make)
    if solver_type is tt.BatchSolver:  # the slowest lane's iterations
        solved = sum(s == tt.SolverStatus.Solved for s in sol.statuses())
        status, iterations = f"{solved}/{len(sol.status)} Solved", int(sol.iterations.max())
    else:
        status, iterations = sol.status.name, sol.iterations
    return dict(
        method=method, dtype=dtype, status=status, iterations=iterations,
        wall_ms=wall * 1e3, device_ms=device_us / 1e3,
        idle_share=1.0 - device_us / 1e6 / wall, **waits,
        kernels=[dict(name=e.key[:90], calls=e.count,
                      device_ms=e.self_device_time_total / 1e3) for e in kernels],
    )


def device_waits(make):
    """One untraced solve of a new solver from ``make``: its device reads
    through ``timers.host_read`` and the device waits of every kind, as
    chip_smoke.SyncCounter counts them."""
    from clarabel_tpu_torch.timers import host_read

    solver = make()
    torch.cuda.synchronize()
    host_read.count = 0
    with chip_smoke.SyncCounter() as syncs:
        solver.solve()
    return dict(device_reads=host_read.count, device_waits=syncs.count)


def waits_per_call():
    """The device waits one call of each linear-algebra function of the PSD
    path makes (chip_smoke.SyncCounter), at the max-cut's and the chordal
    max-cut's shapes, f64."""
    rng = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in ((1, 100, 100), (10, 21, 21), (2048, 1, 4, 4)):
        M = torch.randn(shape, generator=rng, dtype=torch.float64, device="cuda")
        S = M @ M.mT + torch.eye(shape[-1], dtype=torch.float64, device="cuda")
        calls = {"svd": lambda: torch.linalg.svd(M, full_matrices=False),
                 "eigvalsh": lambda: torch.linalg.eigvalsh(S),
                 "cholesky_ex": lambda: torch.linalg.cholesky_ex(S),
                 "lu_factor_ex": lambda: torch.linalg.lu_factor_ex(S)}
        for name, fn in calls.items():
            fn()  # warm-up
            torch.cuda.synchronize()
            with chip_smoke.SyncCounter() as syncs:
                fn()
            out[f"{name} {list(shape)}"] = syncs.count
    return out


def host_split(problem, method):
    """One untraced solve with the loop's parts wrapped by a host clock:
    {part: (calls, inclusive host ms)}, the wall time and the device reads.
    The parts nest: the step length contains the cones' feasibility
    backtracking and, on the combined step, the barrier backtracking, whose
    barriers run the Newton-Raphson loops of the power cones."""
    from clarabel_tpu_torch import loop
    from clarabel_tpu_torch.cones import nonsymmetric as ns, ops
    from clarabel_tpu_torch.kkt import dense
    from clarabel_tpu_torch.timers import host_read

    parts = {"kkt factor (loop._kkt_prepare)": (loop, "_kkt_prepare"),
             "Hs assembly (cones.ops.hs_dense)": (ops, "hs_dense"),
             "refined solves (kkt.dense.solve_refined)": (dense, "solve_refined"),
             "scaling update (cones.ops.update_scaling)": (ops, "update_scaling"),
             "step length (loop.calc_step_length)": (loop, "calc_step_length"),
             "feasibility backtracking (nonsymmetric.step_length)": (ns, "step_length"),
             "Newton-Raphson (nonsymmetric._newton_raphson)": (ns, "_newton_raphson")}
    totals = {k: [0, 0.0] for k in parts}
    saved = {k: getattr(mod, name) for k, (mod, name) in parts.items()}

    def wrap(key, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[key][0] += 1
                totals[key][1] += (time.perf_counter() - t0) * 1e3
        return timed

    P, q, A, b, cones = problem
    settings = tt.DefaultSettings(verbose=False, direct_solve_method=method)
    solver = tt.DefaultSolver(P, q, A, b, cones, settings, device="cuda")
    for key, (mod, name) in parts.items():
        setattr(mod, name, wrap(key, saved[key]))
    try:
        torch.cuda.synchronize()
        host_read.count = 0
        t0 = time.perf_counter()
        sol = solver.solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for key, (mod, name) in parts.items():
            setattr(mod, name, saved[key])
    return dict(method=method, iterations=sol.iterations, wall_ms=wall,
                device_reads=host_read.count,
                parts={k: dict(calls=c, host_ms=ms) for k, (c, ms) in totals.items()})


def profile_factor(n, m, seed, variant="blocked", B=1, reps=5):
    """Device time and launches per factor of each kernel that one LDLᵀ
    factor of ``variant`` runs on B (n + m)² f64 KKT matrices, the
    wrapper's own copies and checks included."""
    from clarabel_tpu_torch.kkt import pallas_ldl as pl

    settings = tt.DefaultSettings()
    K = chip_smoke.kkt_batch(B, n, m, torch.float64, seed, "cuda")
    pl.ldl_factor(K, n, m, settings, variant)  # warm-up, and the build
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            pl.ldl_factor(K, n, m, settings, variant)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = sorted(events, key=lambda e: -e.self_device_time_total)
    return dict(variant=variant, B=B, N=n + m, factors=reps, kernels=[
        dict(name=e.key[:90], launches_per_factor=e.count / reps,
             device_ms_per_factor=e.self_device_time_total / 1e3 / reps,
             us_per_launch=e.self_device_time_total / e.count) for e in kernels])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--out")
    parser.add_argument("--problems", help="profile only these problems (comma-separated "
                        "labels, e.g. maxcut_n100,sdp_batch_B2048)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_solve: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    # label -> (problem, solver, [(method, dtype), ...])
    f64 = [("pallas", "float64"), ("auto", "float64")]
    problems = {
        "qp_n1000": (chip_smoke.portfolio_qp(1000, 50, args.seed), tt.DefaultSolver, f64),
        "socp_n500": (chip_smoke.portfolio_socp(500, 50, args.seed + 1), tt.DefaultSolver, f64),
        "qp_n100": (chip_smoke.portfolio_qp(100, 10, args.seed + 2), tt.DefaultSolver, f64),
        # the batches of chip_smoke.py's "box QP B=2048" and "SOCP B=1024"
        "box_qp_batch_B2048": (chip_smoke.box_qp_batch(2048, 32, args.seed + 1),
                               tt.BatchSolver, f64 + [("auto", "float32")]),
        "socp_batch_B1024": (chip_smoke.socp_batch(1024, 32, args.seed + 2),
                             tt.BatchSolver, [("auto", "float32")]),
        # chip_smoke.py phase 3d's entropy maximization
        "entropy_n500": (chip_smoke.entropy_max(500, 20, 20, args.seed + 20),
                         tt.DefaultSolver, f64),
        # chip_smoke.py phase 3e's PSD problems
        "maxcut_n100": (chip_smoke.maxcut_primal(100, 248, args.seed + 30), tt.DefaultSolver, f64),
        # "auto" raises here: the JAX package's route needs its multifrontal
        # analysis (ROADMAP item 14)
        "chordal_maxcut_n124": (chip_smoke.maxcut_dual(124, 3, args.seed + 31),
                                tt.DefaultSolver, [("pallas", "float64"), ("lu", "float64")]),
        "sdp_batch_B2048": (chip_smoke.sdp_batch(2048, 16, 4, args.seed + 32 + 2048),
                            tt.BatchSolver, f64),
    }
    chosen = set(problems if args.problems is None else args.problems.split(","))
    report = dict(card=card, runs=[])
    with full_precision():
        for label, (problem, solver_type, runs) in problems.items():
            if label not in chosen:
                continue
            for method, dtype in runs:
                r = profile_solve(problem, method, args.top, solver_type, dtype)
                r["problem"] = label
                report["runs"].append(r)
                its = max(r["iterations"], 1)
                print(f"{label} {method} {dtype}: {r['status']} in {r['iterations']} iterations, "
                      f"wall {r['wall_ms']:.1f} ms, device {r['device_ms']:.1f} ms, "
                      f"idle {100 * r['idle_share']:.1f}%, device reads "
                      f"{r['device_reads'] / its:.1f} and waits {r['device_waits'] / its:.1f} "
                      f"per iteration")
                for k in r["kernels"]:
                    print(f"    {k['device_ms']:9.3f} ms  {k['calls']:6d}x  {k['name']}")
        report["waits_per_call"] = waits_per_call()
        print("device waits per call:", report["waits_per_call"])
        report["host_split"] = []
        for label in chosen & {"entropy_n500", "maxcut_n100"}:
            for method in ("pallas", "auto"):
                r = host_split(problems[label][0], method)
                r["problem"] = label
                report["host_split"].append(r)
                print(f"{label} {method} host split: {r['iterations']} iterations, wall "
                      f"{r['wall_ms']:.1f} ms, {r['device_reads']} device reads")
                for key, part in r["parts"].items():
                    print(f"    {part['host_ms']:9.1f} ms  {part['calls']:5d}x  {key}")
        report["factors"] = []
        for variant, B, n, m in (("blocked", 1, 1000, 1001), ("blocked", 1, 500, 1052),
                                 ("unrolled", 1, 100, 101), ("fori", 8, 100, 100),
                                 ("unrolled", 1, 128, 128), ("unrolled", 2048, 32, 64),
                                 ("blocked", 1, 1000, 1540), ("blocked", 1, 5050, 5150),
                                 ("unrolled", 2048, 16, 42)):
            r = profile_factor(n, m, args.seed, variant, B)
            report["factors"].append(r)
            print(f"{variant} factor {B}x{r['N']}² f64, per factor:")
            for k in r["kernels"]:
                print(f"    {k['device_ms_per_factor']:9.3f} ms  {k['launches_per_factor']:6.1f}x  "
                      f"{k['us_per_launch']:8.2f} us/launch  {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

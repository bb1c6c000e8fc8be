#!/usr/bin/env python3
"""Phase 3i's f32 solves on the card, lane by lane, for comparing two trees.

    python3 scripts/f32_df_parity.py run --tree DIR --out FILE [--seed S]
    python3 scripts/f32_df_parity.py compare FILE_A FILE_B [FILE ...]

``run`` imports ``clarabel_tpu_torch`` from the checkout at DIR (this one,
or an unpacked ``git archive`` of another commit) and this checkout's
``chip_smoke``, solves every f32 problem of its phase 3i
(``chip_smoke.F32_PROBLEMS``, so both trees get the same problems) twice
with the f32 preset on the card, and writes each problem's lane statuses, iterations, objectives,
a SHA-256 of x, the double-float LU's launches and the wall times.
``compare`` holds every file to the first: the same statuses, iterations
and x bit for bit, and prints each problem's ms per iteration and, for the
batches, solves per second.  Kernels that are bitwise equal to their twins
leave the solves bitwise unchanged, so two trees that differ only in such
kernels must compare equal.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tree, out, seed):
    tree = os.path.abspath(tree)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs

    sys.path.insert(0, tree)
    import clarabel_tpu_torch as tt

    assert tt.__file__.startswith(tree), f"imported {tt.__file__}, not from {tree}"
    if not torch.cuda.is_available():
        print("f32_df_parity: no CUDA device", file=sys.stderr)
        return 2
    report = dict(tree=tree, card=cs.card_line(), seed=seed, problems={})
    for label, make, method, _, batch in cs.F32_PROBLEMS:
        P, q, A, b, cones = make(seed)
        settings = tt.DefaultSettings.for_float32(verbose=False, direct_solve_method=method)
        cls = tt.BatchSolver if batch else tt.DefaultSolver
        walls = []
        for _ in range(2):
            solver = cls(P, q, A, b, cones, settings, dtype="float32", device="cuda")
            torch.cuda.synchronize()
            read = cs.f32_counts()
            t0 = time.perf_counter()
            sol = solver.solve()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = read()
        statuses = [s.name for s in (sol.statuses() if batch else [sol.status])]
        its = np.atleast_1d(sol.iterations).tolist()
        rec = dict(method=method, statuses=statuses, iterations=its,
                   obj=np.atleast_1d(sol.obj_val).tolist(),
                   x_sha256=hashlib.sha256(np.ascontiguousarray(sol.x).tobytes()).hexdigest(),
                   wall_ms=walls, ms_per_iteration=[w / max(max(its), 1) for w in walls],
                   solves_per_s=[len(statuses) / w * 1e3 for w in walls] if batch else None,
                   df_factor=counts["df_factor"], df_solve=counts["df_solve"])
        report["problems"][f"{label} {method}"] = rec
        short = {i: s for i, s in enumerate(statuses) if s != "Solved"}
        print(f"{label} {method}: iterations {min(its)}-{max(its)}, not Solved {short}, "
              f"ms/iteration {rec['ms_per_iteration'][0]:.2f}/{rec['ms_per_iteration'][1]:.2f}"
              + (f", solves/s {rec['solves_per_s'][0]:.1f}/{rec['solves_per_s'][1]:.1f}"
                 if batch else "") + f", df launches {counts['df_factor']}/{counts['df_solve']}",
              flush=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


def compare(files):
    runs = []
    for path in files:
        with open(path) as f:
            runs.append(json.load(f))
    base = runs[0]["problems"]
    same = True
    for label, rec in base.items():
        for other in runs[1:]:
            o = other["problems"][label]
            for key in ("statuses", "iterations", "x_sha256"):
                if o[key] != rec[key]:
                    same = False
                    print(f"{label}: {key} differs between {runs[0]['tree']} and {other['tree']}")
        ms = " | ".join(f"{r['problems'][label]['ms_per_iteration'][0]:.2f}" for r in runs)
        sps = (" | ".join(f"{r['problems'][label]['solves_per_s'][0]:.1f}" for r in runs)
               if rec["solves_per_s"] else None)
        print(f"{label}: ms/iteration {ms}" + (f"; solves/s {sps}" if sps else ""))
    print("every problem the same statuses, iterations and x:", same)
    return 0 if same else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", default=".")
    r.add_argument("--out", required=True)
    r.add_argument("--seed", type=int, default=0)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs="+")
    args = parser.parse_args()
    if args.cmd == "run":
        return run(args.tree, args.out, args.seed)
    return compare(args.files)


if __name__ == "__main__":
    sys.exit(main())

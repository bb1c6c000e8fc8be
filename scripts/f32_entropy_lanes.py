#!/usr/bin/env python3
"""Which lanes of chip_smoke.py's f32 entropy batch end short of Solved, in
the JAX package and in the port, and whether rounding alone explains it.

The batch is phase 3i's: B = 512 entropy problems (N = 208, seed 23) at f32
through "auto" (the double-float LU), DefaultSettings.for_float32.

    # one BatchSolver over lanes [lo, hi): the JAX package or the port on
    # the CPU (one thread), at f32, f32 with b moved by one f32 ulp, or f64
    JAX_PLATFORMS=cpu python3 scripts/f32_entropy_lanes.py count \\
        --package jax [--variant f32|ulp|f64] --lanes 0:128 --out DIR
    python3 scripts/f32_entropy_lanes.py count --package port \\
        [--variant f32|ulp|f64] --lanes 0:128 --out DIR
    # counts and missed lanes of every saved run; per IPM iteration, the
    # geometric mean over lanes of the largest relative gap in (gap, pres,
    # dres, mu) between two runs' histories
    python3 scripts/f32_entropy_lanes.py summary --out DIR
    # on the card: the batch twice, reversed and as four batches of 128
    # (the first and the last saved to DIR as the runs card512 and card128),
    # every lane missed in any of them solved alone; the f32 portfolio SOCP
    # through "pallas" repeated, and K1 repeated on its recorded inputs
    python3 scripts/f32_entropy_lanes.py card [--repeats 8] --out DIR

``count --package jax`` imports the JAX package; nothing else does, so the
``card`` command runs where JAX is not installed.
"""

from __future__ import annotations

import argparse
import itertools
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the problem builders)

B, SEED = 512, 23
#: history columns compared: gap_abs, pres, dres, mu
COLUMNS = [2, 4, 5, 7]


def batch():
    return chip_smoke.entropy_batch(B, 40, 4, 4, SEED)


def count(args):
    """Solve lanes [lo, hi) in one BatchSolver and save statuses,
    iterations, objectives and histories to ``DIR/<run>_<lo>_<hi>.npz``."""
    lo, hi = (int(v) for v in args.lanes.split(":"))
    P, q, A, b, cones = batch()
    lanes = np.arange(lo, hi)
    P, q, A, b = (v[lanes] for v in (P, q, A, b))
    if args.variant == "ulp":
        b = b * (1 + 2.0**-23)  # one f32 ulp on the data
    dtype = "float64" if args.variant == "f64" else "float32"
    t0 = time.perf_counter()
    if args.package == "jax":
        import jax

        jax.config.update("jax_enable_x64", True)
        import clarabel_tpu as ct
        from clarabel_tpu_torch import convert

        jcones = [ct.cones.api.ConeSpec(kind, dim, alpha=params.get("alpha", ()),
                                        dim2=params.get("dim2", 0))
                  for kind, dim, params in convert.cone_specs(cones)]
        solver = ct.BatchSolver(P, q, A, b, jcones, ct.DefaultSettings.for_float32(verbose=False),
                                dtype=dtype)
    else:
        import torch

        import clarabel_tpu_torch as tt

        torch.set_num_threads(1)
        solver = tt.BatchSolver(P, q, A, b, cones, tt.DefaultSettings.for_float32(verbose=False),
                                dtype=dtype, device="cpu")
    run = args.package if args.variant == "f32" else f"{args.package}_{args.variant}"
    sol = solver.solve()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"{run}_{lo}_{hi}.npz", lanes=lanes, status=np.asarray(sol.status),
             its=np.asarray(sol.iterations), obj=np.asarray(sol.obj_val),
             hist=solver.iteration_history())
    status = np.asarray(sol.status)
    print(f"{run} lanes {lo}:{hi}: {time.perf_counter() - t0:.0f} s, "
          f"{int((status != 1).sum())} short of Solved")
    return 0


def load(out):
    """run -> (lanes, status, iterations, histories), chunks concatenated."""
    runs = {}
    for path in sorted(pathlib.Path(out).glob("*.npz")):
        run = path.stem.rsplit("_", 2)[0]
        d = np.load(path)
        runs.setdefault(run, []).append((d["lanes"], d["status"], d["its"], d["hist"]))
    merged = {}
    for run, chunks in runs.items():
        chunks.sort(key=lambda c: int(c[0][0]))
        parts = list(zip(*chunks))
        width = max(h.shape[1] for h in parts[3])
        hist = [np.pad(h, ((0, 0), (0, width - h.shape[1]), (0, 0)), constant_values=np.nan)
                for h in parts[3]]
        merged[run] = (np.concatenate(parts[0]), np.concatenate(parts[1]),
                       np.concatenate(parts[2]), np.concatenate(hist))
    return merged


def gaps(h1, h2, iterations=range(1, 7)):
    """Per iteration, the geometric mean over lanes of the largest relative
    gap of ``COLUMNS`` between two histories (lanes where either has ended
    are left out)."""
    out = []
    for it in iterations:
        a, b = h1[:, it, COLUMNS], h2[:, it, COLUMNS]
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.nanmax(np.abs(a - b) / np.abs(b), axis=1)
        rel = rel[np.isfinite(rel) & (rel > 0)]
        out.append(float(np.exp(np.log(rel).mean())) if rel.size else float("nan"))
    return out


def summary(args):
    runs = load(args.out)
    names = {1: "Solved", 4: "AlmostSolved", 10: "InsufficientProgress"}
    missed = {}
    for run, (lanes, status, its, _) in runs.items():
        off = {int(i): names.get(int(s), str(int(s))) for i, s in zip(lanes, status) if s != 1}
        missed[run] = set(off)
        print(f"{run}: {len(lanes)} lanes, {len(off)} short of Solved, iterations "
              f"{its.min()}-{its.max()}: {off}")
    for r1, r2 in itertools.combinations(sorted(runs), 2):
        l1, l2 = runs[r1][0], runs[r2][0]
        common = np.intersect1d(l1, l2)
        if not common.size:
            continue
        i1, i2 = np.searchsorted(l1, common), np.searchsorted(l2, common)
        both = sorted(missed[r1] & missed[r2] & set(common.tolist()))
        print(f"{r1} vs {r2} on {common.size} lanes: missed by both {both}; relative gap per "
              f"iteration 1-6 "
              + ", ".join(f"{g:.1e}" for g in gaps(runs[r1][3][i1], runs[r2][3][i2])))
    return 0


def card(args):
    """The port on the card: the batch's statuses under other batch shapes
    and orders, and the f32 SOCP's repeats."""
    import torch

    import clarabel_tpu_torch as tt
    from clarabel_tpu_torch.kkt import pallas_ldl as pl
    from clarabel_tpu_torch.solver import full_precision

    def equal(a, b):
        return bool(torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))
                    and torch.equal(torch.isnan(a), torch.isnan(b)))

    with full_precision():
        # the f32 portfolio SOCP through "pallas" (K1 at f32), repeated
        recorded, launch = [], pl._launch

        def recording(variant, K, sign, eps, delta):
            out = launch(variant, K, sign, eps, delta)
            recorded.append((variant, K.clone(), sign.clone(), eps, delta, out.clone()))
            return out

        pl._launch = recording
        P, q, A, b, cones = chip_smoke.portfolio_socp(500, 50, 1)
        settings = tt.DefaultSettings.for_float32(verbose=False, direct_solve_method="pallas")
        try:
            for deterministic in (False, True):
                torch.use_deterministic_algorithms(deterministic, warn_only=True)
                runs = []
                for _ in range(args.repeats):
                    recorded.clear()
                    sol = tt.DefaultSolver(P, q, A, b, cones, settings, dtype="float32",
                                           device="cuda").solve()
                    runs.append((sol.status.name, sol.iterations, sol.x, sol.z, list(recorded)))
                first = runs[0]
                same = sum(r[:2] == first[:2]
                           and np.array_equal(r[2], first[2], equal_nan=True)
                           and np.array_equal(r[3], first[3], equal_nan=True)
                           and all(equal(c[1], c0[1]) and equal(c[5], c0[5])
                                   for c, c0 in zip(r[4], first[4]))
                           for r in runs[1:])
                print(f"SOCP f32 pallas (deterministic algorithms {deterministic}): "
                      f"{first[0]} after {first[1]} iterations; {same} of {len(runs) - 1} "
                      f"repeats bitwise equal (x, z, every K1 input and output)", flush=True)
        finally:
            torch.use_deterministic_algorithms(False)
            pl._launch = launch
        for c, (variant, K, sign, eps, delta, out) in enumerate(first[4]):
            differing = sum(not equal(launch(variant, K, sign, eps, delta), out)
                            for _ in range(40))
            print(f"  K1 {variant} f32 on the solve's input {c} (N = {K.shape[-1]}, "
                  f"{int((~torch.isfinite(out)).sum())} non-finite entries out): "
                  f"{differing} of 40 repeats differ", flush=True)

        # the entropy batch under other batch shapes and orders; the runs
        # "card512" and "card128" saved for ``summary``
        P, q, A, b, cones = batch()
        settings = tt.DefaultSettings.for_float32(verbose=False)
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)

        def statuses(lanes, run=None):
            solver = tt.BatchSolver(P[lanes], q[lanes], A[lanes], b[lanes], cones, settings,
                                    dtype="float32", device="cuda")
            sol = solver.solve()
            if run is not None:
                np.savez(out / f"{run}_{lanes[0]}_{lanes[-1] + 1}.npz", lanes=lanes,
                         status=np.asarray(sol.status), its=np.asarray(sol.iterations),
                         obj=np.asarray(sol.obj_val), hist=solver.iteration_history())
            return {int(i): s.name for i, s in zip(lanes, sol.statuses())}

        every = np.arange(B)
        shapes = {
            "B = 512": statuses(every, "card512"),
            "B = 512 again": statuses(every),
            "B = 512 reversed": statuses(every[::-1]),
            "4 x B = 128": {k: v for lo in range(0, B, 128)
                            for k, v in statuses(every[lo:lo + 128], "card128").items()},
        }
        short = {}
        for name, st in shapes.items():
            off = {i: s for i, s in sorted(st.items()) if s != "Solved"}
            short[name] = set(off)
            print(f"entropy f32 {name}: {B - len(off)}/{B} Solved; short of Solved {off}",
                  flush=True)
        anywhere = sorted(set().union(*short.values()))
        alone = {i: statuses(np.array([i]))[i] for i in anywhere}
        print(f"  missed in {short['B = 512'] & short['4 x B = 128'] or 'no lane'} at both "
              f"B = 512 and B = 128; each lane missed anywhere, alone (B = 1): "
              f"{sum(s == 'Solved' for s in alone.values())} of {len(alone)} Solved {alone}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    c = sub.add_parser("count")
    c.add_argument("--package", choices=("jax", "port"), required=True)
    c.add_argument("--variant", choices=("f32", "ulp", "f64"), default="f32")
    c.add_argument("--lanes", default=f"0:{B}")
    c.add_argument("--out", required=True)
    s = sub.add_parser("summary")
    s.add_argument("--out", required=True)
    k = sub.add_parser("card")
    k.add_argument("--repeats", type=int, default=8)
    k.add_argument("--out", required=True)
    args = parser.parse_args()
    return {"count": count, "summary": summary, "card": card}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What three design choices of the unblocked LDLᵀ kernel (K2/K3) buy on a
CUDA card.

Builds ``clarabel_tpu_torch/kkt/csrc/ldl.cu`` as it stands ("base") and one
variant for each choice, with that choice flipped by an edit of the source:

  no-switch    every row's update starts at its first 32-column chunk
               (loads the chunks left of the row, stores none of them),
               instead of a switch to an update specialized for the row's
               first chunk;
  rotated      the rows of each W-row group (W warps) dealt to the warps
               rotated by the group, so that the divisions of a warp's
               lanes read different banks, instead of in order (a choice
               this measurement took out of the kernel);
  32-warps     1,024 threads a block at every width, instead of 256 when
               the triangle has at most 64 columns;
  8-warps-160  256 threads a block up to 160 columns (5 chunks), so that
               more than two blocks share an SM at the batched solver's
               N = 96 and 129.

All five build at once.  Each launch is timed alone with CUDA events
(the factor's input copied in before the first event), f64, at 1 x 201²
(the small QP's KKT shape), 264 x 64² (more matrices than SMs), and the
batch shapes of chip_smoke.py's box QP (2048 x 96²) and SOCP (1024 x 129²);
the variants take turns in every round, and each variant's factor must
equal the plain twin bit for bit.  Prints the card, then one line per shape and
variant: the median milliseconds and the ratio to base.

    python3 scripts/ab_unblocked_kernel.py [--rounds R] [--reps K] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (kkt_batch, card_line)
import clarabel_tpu_torch as tt  # noqa: E402
from clarabel_tpu_torch.kkt import build, pallas_ldl as pl  # noqa: E402

SHAPES = ((1, 100, 101), (264, 32, 32), (2048, 32, 64), (1024, 32, 97))  # (B, n, m), N = n + m

# variant: (pattern of csrc/ldl.cu, replacement, the matches it must have)
EDITS = {
    "no-switch": (r"      switch \(r >> 5\) \{.*?#undef UPDATE_FROM\n      \}\n",
                  "      update_row<T, CH, 0>(row, r - lane, last_ok, l0, l1, u0, u1);\n", 1),
    "rotated": (r"W \* (lane|i) \+ warp;", r"W * \1 + ((warp - \1) & (W - 1));", 2),
    "32-warps": (r"return chunks <= 2 \? 8 : 32;", "return 32;", 1),
    "8-warps-160": (r"return chunks <= 2 \? 8 : 32;", "return chunks <= 5 ? 8 : 32;", 1),
}


def sources(out_dir: pathlib.Path) -> dict[str, pathlib.Path]:
    """The base source and one edited copy per variant, under ``out_dir``."""
    base = (build.CSRC / "ldl.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {"base": out_dir / "ldl_base.cu"}
    paths["base"].write_text(base)
    for name, (pattern, repl, matches) in EDITS.items():
        text, count = re.subn(pattern, repl, base, flags=re.S)
        if count != matches:
            raise RuntimeError(f"{name}: the edit matched {count} times, not {matches}")
        paths[name] = out_dir / f"ldl_{name}.cu"
        paths[name].write_text(text)
    return paths


def compile_all(paths: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together; the libraries, loaded."""
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in paths.items()}
    libs = {}
    for name, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{output}")
        lib = ctypes.CDLL(str(paths[name].with_suffix(".so")))
        for fn_name, argtypes in build._SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=20, help="launches per variant per round")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also write the timings to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_unblocked_kernel: no CUDA device", file=sys.stderr)
        return 2

    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = compile_all(sources(build.BUILD_DIR / "ab"))
    settings = tt.DefaultSettings()
    eps, delta = pl._regularization(settings)
    stream = torch.cuda.current_stream().cuda_stream
    report = dict(card=card, rounds=args.rounds, reps=args.reps, shapes=[])
    for B, n, m in SHAPES:
        N = n + m
        K = chip_smoke.kkt_batch(B, n, m, torch.float64, args.seed + N, "cuda")
        sign = torch.ones(N, dtype=K.dtype, device="cuda")
        sign[n:] = -1.0
        ref = pl.ldl_unblocked_plain(K, sign, eps, delta)
        j0, nbytes = pl.unblocked_plan(N, 8, libs["base"].ldl_smem_capacity())
        out = torch.empty_like(K)

        def launch(lib):
            err = lib.ldl_unblocked_f64(out.data_ptr(), sign.data_ptr(), B, N, j0, nbytes,
                                        eps, delta, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        times = {name: [] for name in libs}
        for name, lib in libs.items():  # warm-up, and each variant against the twin
            out.copy_(K)
            launch(lib)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name} B={B} N={N}: not bitwise equal to the twin")
        names = list(libs)
        for r in range(args.rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                for _ in range(args.reps):
                    out.copy_(K)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    launch(libs[name])
                    stop.record()
                    stop.synchronize()
                    times[name].append(start.elapsed_time(stop))
        base = statistics.median(times["base"])
        shape = dict(B=B, N=N, switch_column=j0, variants=[])
        for name in names:
            med = statistics.median(times[name])
            shape["variants"].append(dict(name=name, median_ms=med, min_ms=min(times[name]),
                                          max_ms=max(times[name]), ratio_to_base=med / base))
            print(f"{B:4d} x {N:4d}² f64  {name:12s} median {med:.4f} ms  "
                  f"(min {min(times[name]):.4f}, max {max(times[name]):.4f})  "
                  f"{med / base:.3f} x base", flush=True)
        report["shapes"].append(shape)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

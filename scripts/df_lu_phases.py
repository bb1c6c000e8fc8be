#!/usr/bin/env python3
"""Where the double-float LU factor kernel spends its time, part by part.

Run from the root of a checkout:  python3 scripts/df_lu_phases.py [--out FILE]

Builds ``clarabel_tpu_torch/kkt/csrc/df_lu.cu`` once more with
``-DDF_LU_PROFILE`` (into ``build/``, beside the normal library, which has
no counters), which makes the factor's first block add its clock cycles per
part to a counter read by the build's ``df_lu_profile_read``:
the scaling, the panels (staging and the column-by-column factorization),
the deferred swaps with the U rows, and the trailing updates.  Factors
``chip_smoke.df_matrices`` at the phase 3i shapes and the one-block forms' edge
(1 x 176², 512 x 208², 1 x 512²) and prints each part's share of the
block's cycles beside the kernel's time from CUDA events (that build, its
counters included).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PARTS = ("scaling", "panels", "swaps and U rows", "trailing updates")
SHAPES = ((1, 176), (512, 208), (1, 512))


def profiled_library():
    from clarabel_tpu_torch.kkt import build

    path, _, log = build.compile_shared(build._nvcc(), build.CSRC / "df_lu.cu",
                                        (*build.NVCC_FLAGS, "-DDF_LU_PROFILE"))
    lib = ctypes.CDLL(str(path))
    signatures = {**build._SIGNATURES["df_lu.cu"], **build.PROFILE_SIGNATURES["df_lu.cu"]}
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int
    return lib, log


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("df_lu_phases: no CUDA device", file=sys.stderr)
        return 2
    from clarabel_tpu_torch.kkt import df_ldl

    card = chip_smoke.card_line()
    sm_hz = chip_smoke.sm_clock_hz()
    print(f"card: {card}, SM clock up to {sm_hz / 1e6:.0f} MHz")
    lib, log = profiled_library()
    print("\n".join(line for line in log.splitlines() if "registers" in line))
    cycles = (ctypes.c_ulonglong * 4)()
    rows = []
    for B, N in SHAPES:
        K_hi, _ = chip_smoke.df_matrices(B, N, "random", args.seed + B + N, "cuda", False)
        run = lambda: df_ldl._launch_factor(lib, K_hi, None, 1e-6)
        ms = chip_smoke.cuda_ms(run, 3)
        assert lib.df_lu_profile_read(cycles) == 0
        run()
        torch.cuda.synchronize()
        assert lib.df_lu_profile_read(cycles) == 0
        total = sum(cycles)
        row = dict(B=B, N=N, ms=ms, block_cycles=total, block_ms_at_max_clock=total / sm_hz * 1e3,
                   parts={p: c / total for p, c in zip(PARTS, cycles)})
        rows.append(row)
        print(f"B={B} N={N}: kernel {ms:.3f} ms; block 0 {total} cycles "
              f"({row['block_ms_at_max_clock']:.3f} ms at the maximum clock): "
              + ", ".join(f"{p} {100 * c / total:.1f}%" for p, c in zip(PARTS, cycles)),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

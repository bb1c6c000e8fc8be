"""Run one cell of the benchmark of clarabel_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, makes its instance pool from
the seed, warms up its shapes with one call (set-up), calls the solver for
``--seconds`` seconds, with ``--trace 1`` traces a few more calls under
``torch.profiler``, checks every answer against the plain reference, and
prints one JSON line as the last line of standard output (and the numbers
compared, beside their limits, as the last lines of standard error).

It exits with another code than 0, and prints no result, when there is no
CUDA device, when the port is not in the checkout, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``clarabel_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "clarabel_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``clarabel_tpu_torch`` is not)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    try:
        import clarabel_tpu_torch
    except ImportError as exc:
        print(f"benchmark: the port is not in this checkout ({exc})", file=sys.stderr)
        return 1
    if Path(clarabel_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"benchmark: clarabel_tpu_torch was loaded from {clarabel_tpu_torch.__file__}, "
              "not from this checkout", file=sys.stderr)
        return 1
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    t_imported = time.perf_counter()
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"benchmark: imports {t_imported - T_START:.3f} s, CUDA device query "
          f"{time.perf_counter() - t_imported:.3f} s", file=sys.stderr)
    if found < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                         log=lambda text: print(f"benchmark: {text}", file=sys.stderr))
    if args.trace:
        result["device"]["power_limit_w"] = power_limit_w()

    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it (None if
    it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


if __name__ == "__main__":
    sys.exit(main())

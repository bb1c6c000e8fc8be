"""The control of the limits that decide ``correct``: the program's own
lower-precision path at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--out FILE]

For each seed it makes the cell's instance pool and makes one call through
the cell's entry at float32 with ``DefaultSettings.for_float32``, and judges
every answer with the reference.  Each reading prints as one JSON line: the
largest value of each number compared (``benchmark/reference/kkt.py``),
whether the configuration's limits pass it, and the call's iterations.  The
control has to come out as not correct.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device: str = "cuda") -> dict:
    from benchmark import harness
    from benchmark.reference import kkt

    program = harness.Program(cell, device, "float32")
    pool = harness.make_pool(cell, seed)
    call = program.call(pool[0], 0)
    verdict = kkt.judge([(pool[0], call.out)], cell.config["limits"])
    return dict(workload=cell.name, seed=seed, dtype="float32", worst=verdict["worst"],
                judged=verdict["judged"], failed=verdict["failed"],
                correct=verdict["correct"], iterations=call.iterations)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None, help="also append each reading to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = readings(cell, seed)
        line["seconds"] = time.perf_counter() - t0
        line["card"] = torch.cuda.get_device_name(0)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

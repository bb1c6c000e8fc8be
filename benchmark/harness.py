"""One run of one cell: set-up, the measured window, the traced calls, and
the check of every answer.

The loop is closed, with one caller.  Set-up makes a pool of instances from
the seed and makes one call of the cell's own shapes.  Then each call takes
the next instance of the pool and does what a user does, as the traffic's
call module (``calls/<call>.py``) sets out: for ``construct_solve``, it
builds the solver through the public entry the traffic names
(``clarabel_tpu_torch.DefaultSolver``, ``BatchSolver``, ...) and calls
``.solve()``, which brings the solution to the host as NumPy arrays.  Calls
start until the window's seconds have passed.

Everything that belongs to one configuration, traffic mix, cone kind or
metric is found by its name: ``configs/``, ``generators/``, ``traffic/``,
``calls/``, ``reference/cones/`` and ``metrics/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    manifest: dict

    @property
    def lanes(self):
        return self.traffic.get("lanes")

    def metrics(self, kind: str) -> list[dict]:
        """The manifest's ``end_to_end`` or ``per_layer`` entries this cell
        reports."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(path: Path = MANIFEST) -> dict:
    return _read_json(path)


def load_cell(name: str, manifest: dict | None = None, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest with its configuration
    (``configs/<config>.json``, the file the manifest names) and traffic
    (``traffic/<traffic>.json``).  ``overrides`` ({"config": {...},
    "traffic": {...}}) replaces keys of either, for tests at small sizes."""
    manifest = manifest if manifest is not None else load_manifest()
    work = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    config = _read_json(ROOT / cfg_entry["file"])
    traffic = _read_json(HERE / "traffic" / f"{work['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return Cell(name, work, config, traffic, manifest)


def metric_module(name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py``."""
    return importlib.import_module(f"benchmark.metrics.{name}")


def call_module(name: str):
    """What one call of traffic that names ``call`` does:
    ``benchmark/calls/<name>.py``, whose ``make(program)`` returns a function
    of (instance, mark) that returns the seconds of its two phases (build,
    solve) and the solution."""
    return importlib.import_module(f"benchmark.calls.{name}")


def instance_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of pool instance ``index`` of run seed ``seed`` (any
    whole number)."""
    return np.random.default_rng(np.random.SeedSequence(int(seed) % (1 << 64),
                                                        spawn_key=(index,)))


def make_pool(cell: Cell, seed: int) -> list[dict]:
    gen = importlib.import_module(f"benchmark.generators.{cell.config['generator']}")
    return [gen.make(cell.config, cell.lanes, instance_rng(seed, i))
            for i in range(cell.traffic["pool"])]


def kkt_dim(inst: dict) -> int:
    """n + m of an instance: the dense KKT system's order."""
    return np.shape(inst["q"])[-1] + np.shape(inst["b"])[-1]


@dataclasses.dataclass
class Call:
    instance: int
    construct_s: float
    solve_s: float
    end: float  # perf_counter at the end of the call
    iterations: int  # the most of any lane
    lanes: int
    solved: int
    out: dict  # x, s, z, status names, obj_val as host arrays


class Program:
    """The system under test: the port's public entry that the traffic
    names, with the cell's settings, on ``device`` (the card unless a test
    names the CPU), at ``dtype`` (the configuration's unless a control names
    another), driven as the traffic's call module says."""

    def __init__(self, cell: Cell, device: str, dtype: str | None = None):
        import clarabel_tpu_torch as tt

        self.tt = tt
        self.cell = cell
        self.device = device
        self.dtype = dtype or cell.config["dtype"]
        self.entry = getattr(tt, cell.traffic["entry"])
        settings = {**cell.config["settings"], **cell.traffic["settings"]}
        if self.dtype == "float32":
            self.settings = lambda: tt.DefaultSettings.for_float32(**settings)
        else:
            self.settings = lambda: tt.DefaultSettings(**settings)
        self.kwargs = dict(dtype=self.dtype)
        if device != "cuda":
            self.kwargs["device"] = device
        self._call = call_module(cell.traffic["call"]).make(self)

    def cones(self, inst: dict) -> list:
        """The instance's cones as the port's cone objects: each ``[class
        name, arguments]`` pair of the generator built as
        ``clarabel_tpu_torch.<class name>(*arguments)``."""
        return [getattr(self.tt, name)(*args) for name, args in inst["cones"]]

    def call(self, inst: dict, index: int, mark=contextlib.nullcontext) -> Call:
        construct_s, solve_s, sol = self._call(inst, mark)
        end = time.perf_counter()
        status = np.atleast_1d(np.asarray(sol.status, np.int64))
        names = np.array([self.tt.SolverStatus(int(v)).name for v in status])
        out = dict(x=np.atleast_2d(sol.x), s=np.atleast_2d(sol.s), z=np.atleast_2d(sol.z),
                   status=names, obj_val=np.atleast_1d(np.asarray(sol.obj_val, np.float64)))
        iters = int(np.max(np.asarray(sol.iterations)))
        return Call(index, construct_s, solve_s, end, iters, names.size,
                    int(np.sum(names == "Solved")), out)


class Card:
    """Device-side housekeeping of a run on ``device``: synchronisation and
    the allocator's peak (nothing on the CPU)."""

    def __init__(self, device: str):
        self.cuda = device == "cuda"
        if self.cuda:
            import torch

            self.torch = torch

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def describe(self) -> dict:
        if not self.cuda:
            return dict(platform="cpu", kind="cpu", count=1)
        return dict(platform="gpu", kind=self.torch.cuda.get_device_name(0), count=1)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_start: float
    calls: list  # the window's calls
    trace: object  # benchmark.trace.Trace of the traced calls, or None
    lanes: int
    kkt_dim: int
    itemsize: int
    window_peak_bytes: int


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", dtype: str | None = None, log=None) -> dict:
    """Run ``cell`` once: set-up from ``t_start`` (the process's first
    clock reading) to the end of the warm-up call, the window of
    ``seconds``, with ``trace`` the traced calls after it, then the check
    of every answer.  Returns the result line's fields; ``log`` (a
    function of one string) is told the set-up's parts."""
    t_enter = time.perf_counter()
    card = Card(device)
    program = Program(cell, device, dtype)
    pool = make_pool(cell, seed)
    t_pool = time.perf_counter()
    # warm-up: one call of the cell's own shapes, on the instance the window
    # does not start with
    program.call(pool[-1], len(pool) - 1)
    card.sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    if log is not None:
        log(f"set-up {setup_s:.3f} s: imports {t_enter - t_start:.3f} s, pool "
            f"{t_pool - t_enter:.3f} s, warm-up call {t_warm - t_pool:.3f} s")
    setup_peak = card.peak()

    card.reset_peak()
    calls = []
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        calls.append(program.call(pool[i % len(pool)], i % len(pool)))
        i += 1
    window_peak = card.peak()
    if log is not None:
        log("window calls: iterations " + " ".join(str(c.iterations) for c in calls)
            + "; construct s " + " ".join(f"{c.construct_s:.3f}" for c in calls)
            + "; solve s " + " ".join(f"{c.solve_s:.3f}" for c in calls))

    traced, tr = [], None
    if trace:
        from benchmark import trace as tracing

        def traced_calls(mark):
            nonlocal i
            for _ in range(cell.traffic["trace_calls"]):
                traced.append(program.call(pool[i % len(pool)], i % len(pool), mark))
                i += 1
            card.sync()

        tr = tracing.record(traced_calls, cuda=card.cuda)

    device_info = card.describe()
    device_info["memory_peak_bytes"] = max(setup_peak, card.peak())
    state = Run(cell, setup_s, start, calls, tr, cell.lanes or 1, kkt_dim(pool[0]),
                8 if program.dtype == "float64" else 4, window_peak)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in cell.metrics(kind):
        value = metric_module(entry["name"]).read(state)
        if value is not None:
            metrics[entry["name"]] = dict(value=float(value), unit=entry["unit"])

    # the program's state is freed (a solver can sit in a reference cycle
    # until the collector runs); the reference judges every answer
    del program
    gc.collect()
    if card.cuda:
        card.torch.cuda.empty_cache()
    from benchmark.reference import kkt

    limits = cell.config["limits"]
    t_check = time.perf_counter()
    verdict = kkt.judge(((pool[c.instance], c.out) for c in calls + traced), limits)
    if log is not None:
        log(f"reference check of {verdict['judged']} solutions: "
            f"{time.perf_counter() - t_check:.3f} s")
    result = dict(correct=verdict["correct"], attempted=verdict["judged"],
                  failed=verdict["failed"], metrics=metrics, device=device_info)
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: dict(value=verdict["worst"][k], limit=limits[k])
                        for k in kkt.NUMBERS}
    return result

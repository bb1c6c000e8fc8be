"""The device trace of the traced calls, from ``torch.profiler``.

The traced calls run under the profiler with CPU and CUDA activities.  Its
Chrome trace is read back (and deleted) and kept as plain intervals, in
seconds on the trace's clock:

- ``device``: every operation that ran on the card (kernels, copies,
  fills), with its name and the correlation id of its launch;
- ``ops``: the host's ``aten::`` operators on the calling thread;
- ``ranges``: the benchmark's own ``bench.construct``/``bench.solve``
  ranges around each call;
- ``launches``: correlation id → (host time, thread) of each launch.

The traced window runs from the start of the first call's range to the end
of the last one's.  ``busy_s`` is the union of the device intervals inside
it, so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile

#: Chrome-trace categories of work on the device
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
#: categories of a launch on the host
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
RANGE_PREFIX = "bench."


@dataclasses.dataclass
class Span:
    start: float
    end: float
    name: str
    corr: int = -1
    tid: object = None

    @property
    def dur(self) -> float:
        return self.end - self.start


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    def __init__(self, events: list[dict]):
        self.device, self.ops, self.ranges, self.launches = [], [], [], {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            start = float(ev["ts"]) * 1e-6
            end = start + float(ev.get("dur", 0.0)) * 1e-6
            args = ev.get("args") or {}
            corr = int(args.get("correlation", -1))
            if cat in DEVICE_CATS:
                self.device.append(Span(start, end, ev["name"], corr))
            elif cat in LAUNCH_CATS:
                self.launches[corr] = (start, ev.get("tid"))
            elif cat == "cpu_op":
                self.ops.append(Span(start, end, ev["name"], tid=ev.get("tid")))
            elif cat == "user_annotation" and ev["name"].startswith(RANGE_PREFIX):
                self.ranges.append(Span(start, end, ev["name"], tid=ev.get("tid")))
        self.ranges.sort(key=lambda r: r.start)
        main = {r.tid for r in self.ranges}
        self.ops = sorted((o for o in self.ops if o.tid in main), key=lambda o: (o.start, -o.end))
        if self.ranges:
            self.t0 = self.ranges[0].start
            self.t1 = max(r.end for r in self.ranges)
        else:
            self.t0 = self.t1 = 0.0
        self.busy = [(max(s, self.t0), min(e, self.t1))
                     for s, e in union((d.start, d.end) for d in self.device)
                     if e > self.t0 and s < self.t1]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernels(self, pattern: str) -> list[Span]:
        rx = re.compile(pattern)
        return [d for d in self.device if rx.search(d.name)]

    def outermost_ops(self, name: str) -> list[Span]:
        """The host operators called ``name`` that no other of that name
        encloses."""
        out = []
        for o in self.ops:
            if o.name == name and not (out and o.start < out[-1].end):
                out.append(o)
        return out

    def launched_within(self, spans: list[Span]) -> list[Span]:
        """The device operations whose launch lies inside one of ``spans``
        (host operators, sorted and disjoint)."""
        starts = [s.start for s in spans]
        found = []
        for d in self.device:
            launch = self.launches.get(d.corr)
            if launch is None:
                continue
            k = bisect.bisect_right(starts, launch[0]) - 1
            if k >= 0 and launch[0] <= spans[k].end:
                found.append(d)
        return found

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the traced window."""
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_label(self, points: list[float]) -> list[str]:
        """What the host was doing at each of the sorted ``points``: the
        benchmark's range and the innermost operator open then."""
        labels, stack, j = [], [], 0
        starts = [r.start for r in self.ranges]
        for t in points:
            while j < len(self.ops) and self.ops[j].start <= t:
                while stack and stack[-1].end <= self.ops[j].start:
                    stack.pop()
                stack.append(self.ops[j])
                j += 1
            while stack and stack[-1].end < t:
                stack.pop()
            k = bisect.bisect_right(starts, t) - 1
            rng = self.ranges[k].name if k >= 0 and t <= self.ranges[k].end else "between calls"
            labels.append(f"{rng} / {stack[-1].name if stack else 'no operator'}")
        return labels

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the idle
        time of the traced window by what the host was doing."""
        ops = collections.Counter()
        for d in self.device:
            if d.end > self.t0 and d.start < self.t1:
                ops[short_name(d.name)] += d.dur
        gaps = self.gaps()
        mids = [(s + e) / 2 for s, e in gaps]
        idle = collections.Counter()
        for (s, e), label in zip(gaps, self.host_label(mids)):
            idle[label] += e - s
        return dict(device_ops=[[k, v] for k, v in ops.most_common(top)],
                    idle_gaps=[[k, v] for k, v in idle.most_common(top)])


def record(fn, cuda: bool) -> Trace:
    """Run ``fn(mark)`` under ``torch.profiler``; ``mark(name)`` opens one
    of the benchmark's ranges.  Returns the trace it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        fn(record_function)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    del prof
    if cuda:
        torch.cuda.synchronize()
    return Trace(events)

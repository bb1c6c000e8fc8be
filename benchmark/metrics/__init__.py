"""One reader per metric of ``BENCHMARK.json``, found by the metric's name.

Each module states the metric's ``UNIT``, ``SOURCE``, ``LAYER`` (per-layer
metrics; the name PERF.md's list of layers gives) and ``MOVES`` (the
end-to-end metric a per-layer metric should move), and has ``read(run)``,
which takes a ``harness.Run`` and returns the value, or None where the run
holds nothing to read (the harness then leaves the metric out)."""

"""Milliseconds of ``.solve()`` per IPM iteration over the window's calls:
the benchmark's clock around every ``.solve()``, over the iterations of
every call (a batch's: the most of any lane)."""

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "IPM loop: loop.py"
MOVES = "solves_per_s"


def read(run):
    iters = sum(c.iterations for c in run.calls)
    if not iters:
        return None
    return 1e3 * sum(c.solve_s for c in run.calls) / iters

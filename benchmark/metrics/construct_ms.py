"""Milliseconds per call in the solver's constructor (``DefaultSolver`` or
``BatchSolver``: checks, symmetrisation, presolve and layout, the copies to
the card), by the benchmark's clock over the window's calls."""

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "entry: solver.py DefaultSolver and parallel/batch.py BatchSolver constructors"
MOVES = "solves_per_s"


def read(run):
    if not run.calls:
        return None
    return 1e3 * sum(c.construct_s for c in run.calls) / len(run.calls)

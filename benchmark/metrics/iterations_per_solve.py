"""IPM iterations per call as the port reports them (a batch's: the most of
any lane), the mean over the window's calls."""

UNIT = "iterations"
SOURCE = "program_counter"
LAYER = "IPM loop: loop.py"
MOVES = "solves_per_s"


def read(run):
    if not run.calls:
        return None
    return sum(c.iterations for c in run.calls) / len(run.calls)

"""Solutions with status ``Solved`` per second of the window: the Solved
lanes of every call completed in the window, over the time from the
window's start to the end of the last completed call."""

UNIT = "solves/s"
SOURCE = "host_clock"


def read(run):
    if not run.calls:
        return None
    return sum(c.solved for c in run.calls) / (run.calls[-1].end - run.window_start)

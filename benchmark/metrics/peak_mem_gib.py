"""The allocator's peak over the window: ``torch.cuda.max_memory_allocated()``
after ``reset_peak_memory_stats()`` at the window's start, in GiB."""

UNIT = "GiB"
SOURCE = "program_counter"
LAYER = "device"
MOVES = "solves_per_s"


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None

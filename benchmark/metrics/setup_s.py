"""Seconds from the harness's first line to the end of the warm-up call:
imports, the CUDA context, the kernel library (built on a checkout's first
run, loaded from ``build/`` after), the instance pool, and one call of the
cell's own shapes."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s

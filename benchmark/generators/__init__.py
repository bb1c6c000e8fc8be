"""Problem generators, one module per family, named by a configuration's
``generator`` key.  Each module has ``make(config, lanes, rng)`` returning
one instance: ``P``, ``q``, ``A``, ``b`` in the form users pass them to the
solver's entry (``[B, ...]`` arrays for a batch of ``lanes`` problems, one
problem when ``lanes`` is None), and ``cones``, the cone list in row order
as ``[class name, arguments]`` pairs: the harness builds
``clarabel_tpu_torch.<class name>(*arguments)``, and the reference judges
each by ``reference/cones/<class name>.py``."""

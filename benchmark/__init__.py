"""The benchmark of clarabel_tpu_torch, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line.  Everything a cell needs is found by name: its
configuration in ``configs/<name>.json`` (with the generator module of
``generators/`` it names), its traffic in ``traffic/<name>.json``, and each
metric in ``metrics/<name>.py``.  ``reference/`` holds the plain NumPy check
that decides ``correct``; it imports nothing of the program.

Nothing here imports ``jax`` or the JAX package ``clarabel_tpu``
(``tests/test_bench_imports.py`` checks).
"""

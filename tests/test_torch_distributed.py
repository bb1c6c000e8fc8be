"""Multi-process execution of the port's distributed helpers, as
``tests/test_distributed.py`` runs the JAX package's: two processes join
through ``distributed.initialize("127.0.0.1:<port>", 2, rank)`` (gloo: the
CPU has no NCCL), build ``global_mesh(("batch",), device_type="cpu")`` and
solve ``tests/_distributed_worker.py``'s batch (B = 8, n = 6, f64) split
over the two ranks.  Each rank must get its own lanes back, all Solved,
within 1e-8 (objective) and 1e-7 (x) of the port's single-process solve of
the same lanes -- the JAX test's tolerances.
"""

import numpy as np

import _torch_distributed_worker as worker
import clarabel_tpu_torch as tt


def test_two_process_sharded_batch(tmp_path):
    procs = worker.spawn("batch", 2, tmp_path)
    results = worker.collect(procs, tmp_path, timeout=240)
    for rank, r in enumerate(results):
        lanes = np.arange(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(r["batch_lanes"], lanes)
        assert r["batch_status"].shape == (4,)
        assert (r["batch_status"] == int(tt.SolverStatus.Solved)).all(), r["batch_status"]
        assert r["batch_x"].shape == (4, 6) and r["batch_z"].shape == (4, 12)
        np.testing.assert_allclose(r["batch_obj"], r["ref_obj"][lanes], atol=1e-8)
        np.testing.assert_allclose(r["batch_x"], r["ref_x"][lanes], atol=1e-7)

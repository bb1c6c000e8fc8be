"""The multifrontal factor and solve of clarabel_tpu_torch against the JAX
package's on the same plan, as test_torch_multifrontal.py states it
(test_multifrontal.py's quasidefinite K, whose children extend-add into
their parents): the fronts' factors and the solve within 1e-12 relative,
through the pivot scan and through the unblocked kernel's route (its plain
twin on the CPU).  A file of two tests (the JAX package's multifrontal
compiles), which pytest-xdist's loadfile scheduling runs beside
tests/test_df_lu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clarabel_tpu.kkt import multifrontal as jmf
from clarabel_tpu_torch.kkt import multifrontal as tmf
from test_torch_multifrontal import DELTA, EPS, _close, _setup


@pytest.mark.parametrize("route", ["scan", "kernel_twin"])
def test_factor_and_solve_match_reference(route):
    plan, tplan, jarrays, tarrays, kvals, K = _setup()
    assert any(B.asm for lvl in plan.levels for B in lvl)  # children extend-add
    jf, jok = jmf.mf_factor(plan, jarrays, jnp.asarray(kvals), EPS, DELTA)
    diag_fn = tmf._diag_factor_scan if route == "scan" else tmf._diag_factor_ldl
    tf, tok = tmf.mf_factor(tplan, tarrays, torch.as_tensor(kvals), EPS, DELTA,
                            diag_fn=diag_fn)
    assert bool(jok) and bool(tok)
    _close(tf["dvec"], jf["dvec"])
    for jl, tl in zip(jf["levels"], tf["levels"]):
        for (jLc, jd, jLinv), (tLc, td, tLinv) in zip(jl, tl):
            _close(tLc, jLc)
            _close(td, jd)
            _close(tLinv, jLinv)
    rng = np.random.default_rng(1)
    for rhs in (rng.normal(size=K.shape[0]), rng.normal(size=(K.shape[0], 2))):
        ref = jmf.mf_solve(plan, jarrays, jf, jnp.asarray(rhs))
        got = tmf.mf_solve(tplan, tarrays, tf, torch.as_tensor(rhs))
        _close(got, ref)
        _close(got, np.linalg.solve(K, rhs), rel=1e-10)

"""The f32 "lu" route past the double-float LU's default gate, in both
packages: the entropy maximization of tests/_torch_parity.py at n = 100
(p = 6, q = 7: KKT order N = 513, one past the default ``DF_LU_MAX_DIM``)
through "auto" at f32, which routes exponential cones to "lu".  At the
default gate both packages factor it with the Jacobi-equilibrated LU;
with ``DF_LU_MAX_DIM`` raised to 4096 in both (as CT_DF_LU_MAX_DIM does on
import), both factor it with the double-float LU (the port's
``df_ldl.factor``, which a card runs through the grid-form kernels).

Each solve stops at its first KKT factorization (a sentinel raised by the
factor's spy): in the JAX package the route is taken at trace time, before
its compile.  The whole solves, which take about five minutes of the JAX
package's f32 compile and solve and a minute and a half of the port's plain
twin at this order, are compared by scripts/f32_df_route_past_512.py
(both Solved, iterations within 2, objectives within 1e-4 of each other
and of the f64 solve, x within twice the JAX package's own distance from
the f64 x); on the card chip_smoke.py's phase 3m solves the entropy
problem at N = 2540 and a p-norm regression at N = 1300 through the
double-float route.
"""

import functools

import jax
import pytest

import _torch_parity as tp
import clarabel_tpu as ct
import clarabel_tpu_torch as tt
import test_torch_f32_dense as f32d
from clarabel_tpu.kkt import dense as jdense
from clarabel_tpu_torch.kkt import dense as tdense


class _Factored(Exception):
    """Raised by the spies at the first KKT factorization."""


def _spy(seen, name, K_reg, *args):
    seen.append((name, K_reg.shape[-1]))
    raise _Factored


@pytest.mark.parametrize("gate, route", [(None, "factor_jacobi"), (4096, "factor_df")])
def test_f32_lu_route_past_512(gate, route, monkeypatch):
    P, q, A, b, cones = tp.entropy_max(n=100, p=6, q=7, seed=5)
    N = P.shape[0] + A.shape[0]
    assert N == 513 and tdense.DF_LU_MAX_DIM == jdense.DF_LU_MAX_DIM == 512
    seen = {"jax": [], "port": []}
    for module, key in ((jdense, "jax"), (tdense, "port")):
        if gate is not None:
            monkeypatch.setattr(module, "DF_LU_MAX_DIM", gate)
        for name in ("factor_df", "factor_jacobi"):
            monkeypatch.setattr(module, name, functools.partial(_spy, seen[key], name))
    settings = f32d.f32_settings()
    with pytest.raises(_Factored):
        ct.DefaultSolver(P, q, A, b, cones, settings, dtype="float32",
                         device=jax.devices("cpu")[0]).solve()
    with pytest.raises(_Factored):
        tt.DefaultSolver(P, q, A, b, tp.port_cones(cones), tp.port_settings(settings),
                         dtype="float32", device="cpu").solve()
    assert seen["jax"] == seen["port"] == [(route, N)]

"""The plain PyTorch versions of the three LDLᵀ kernels
(clarabel_tpu_torch/kkt/pallas_ldl.py) against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

Inputs are batches of quasidefinite KKT matrices built as bench.py builds
them, from a numpy seed.  D is compared on the diagonal and L on the strict
triangle that the solve reads (above the diagonal for the unblocked K2/K3,
below it for the blocked K1), then the solves themselves.  Tolerances:
1e-12·max|K| at f64 and 1e-4 of the reference's largest entry at f32 --
the arithmetic is the same, only the order of summation differs (the
blocked variant also uses 32-column panels where the TPU kernel uses 128).
"""

import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clarabel_tpu.kkt.pallas_ldl as jl
from clarabel_tpu.settings import DefaultSettings as JaxSettings
import _torch_parity  # noqa: F401  (pins torch's threads)
from clarabel_tpu_torch import convert
from clarabel_tpu_torch.kkt import pallas_ldl as tl


def _kkt_batch(B, n, m, dtype, seed):
    """Quasidefinite [[P, Aᵀ], [A, -I]] with P = MMᵀ/n + I (bench.py:275-279)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + np.eye(n)
    A = rng.normal(size=(B, m, n))
    H = np.tile(np.eye(m), (B, 1, 1))
    K = np.block([[P, np.transpose(A, (0, 2, 1))], [A, -H]])
    return K.astype(dtype)


# (row, pivot) pairs the regularization must catch at n = m = 20: a negative
# pivot (row 0) and a zero pivot (row 5) in the + block, and a positive pivot
# in the - block (row n + 2).
PIVOTS = [(0, -1.0), (5, 0.0), (22, 0.5)]
# At n = 64, m = 65 (N = 129, the least N with a second 128-column TPU
# panel): rows 0, 31, 32 and 63 (+ block) sit on the edges of the port's
# 32-column panels, rows 127 and 128 (- block) on the edge of the TPU
# kernel's 128-column panel too.
PANEL_EDGE_PIVOTS = [(0, -1.0), (31, 0.0), (32, -1.0), (63, 0.0), (127, 0.5), (128, 0.0)]
# Shared memory one block may use on the H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin).
H100_SMEM = 232448
# At n = m = 128 the f64 unblocked kernel on the H100 runs its first SWITCH
# (16) steps in device memory, then the rest in shared memory: pivots just
# before, at and after that column (+ block), and two in the - block.  The
# twin has no such switch; this holds it to the JAX K3 at those pivots, and
# chip_smoke.py holds the kernel to the twin there.
SWITCH = tl.unblocked_plan(256, 8, H100_SMEM)[0]
SWITCH_PIVOTS = [(SWITCH - 1, -1.0), (SWITCH, 0.0), (SWITCH + 1, -1.0), (130, 0.5), (192, 0.0)]


def _with_irregular_pivots(K, pivots):
    """Decouple the rows of ``pivots``, leaving the given pivot on each
    one's diagonal."""
    K = K.copy()
    for r, v in pivots:
        K[:, r, :] = 0.0
        K[:, :, r] = 0.0
        K[:, r, r] = v
    return K


@functools.cache
def _reference_factor(n, m, dynamic_regularization_enable, dtype, variant):
    """The JAX kernel mapped over a batch, jitted once per shape, dtype,
    variant and regularization switch: the cases of this module that share
    them share its compile."""
    settings = JaxSettings(dynamic_regularization_enable=dynamic_regularization_enable)
    factor = jl.make_ldl_factor(n, m, settings, jnp.dtype(dtype), interpret=True,
                                variant=variant)

    def one(Kb):
        (_, (packed, _)), ok = factor(Kb)
        return packed, ok

    return jax.jit(jax.vmap(one))


def _reference(K, n, m, settings, variant):
    """The JAX kernel on each matrix of the batch: packed [B, N, N], ok [B]."""
    assert settings == JaxSettings(
        dynamic_regularization_enable=settings.dynamic_regularization_enable)
    factor = _reference_factor(n, m, settings.dynamic_regularization_enable,
                               np.dtype(K.dtype).name, variant)
    packed, ok = factor(jnp.asarray(K))
    N = n + m
    return np.asarray(packed)[:, :N, :N], np.asarray(ok)


def _port(K, n, m, settings, variant):
    port_settings = convert.settings_from_dict(dataclasses.asdict(settings))
    (kind, (packed, N)), ok = tl.ldl_factor(
        torch.as_tensor(K), n, m, port_settings, variant
    )
    return kind, packed, ok.numpy()


def _triangle(packed, kind):
    return np.tril(packed, -1) if kind == "pldl_lower" else np.triu(packed, 1)


def _tol(K, ref, dtype):
    if dtype == np.float64:
        return 1e-12 * np.abs(K).max()
    return 1e-4 * np.abs(ref).max()


#: (80, 80, "unrolled") and (80, 80, "blocked") in test_torch_ldl_unrolled.py
#: and test_torch_ldl_blocked.py, files of two tests (each its own JAX
#: compiles), which pytest-xdist's loadfile scheduling runs beside
#: tests/test_df_lu.py
CASES = [(20, 20, "unrolled"), (20, 20, "fori"), (80, 80, "fori")]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,m,variant", CASES)
def test_factor_and_solve_match_pallas(n, m, variant, dtype):
    check_factor_and_solve(n, m, variant, dtype)


def check_factor_and_solve(n, m, variant, dtype):
    """The kernel's plain version against the JAX package's Pallas kernel
    on a batch of two KKT matrices: D, L's strict triangle and the solve."""
    settings = JaxSettings()
    K = _kkt_batch(2, n, m, dtype, seed=n + m)
    ref, ref_ok = _reference(K, n, m, settings, variant)
    kind, packed, ok = _port(K, n, m, settings, variant)
    assert kind == ("pldl_lower" if variant == "blocked" else "pldl")
    assert ok.all() and ref_ok.all()
    got = packed.numpy()
    tol = _tol(K, ref, dtype)
    d_got = np.diagonal(got, axis1=1, axis2=2)
    d_ref = np.diagonal(ref, axis1=1, axis2=2)
    assert np.abs(d_got - d_ref).max() <= tol
    for b in range(K.shape[0]):
        assert np.abs(_triangle(got[b], kind) - _triangle(ref[b], kind)).max() <= tol

    rhs = np.random.default_rng(7).normal(size=n + m).astype(dtype)
    solve_ref = jl.ldl_solve_lower if kind == "pldl_lower" else jl.ldl_solve
    solve_port = tl.ldl_solve_lower if kind == "pldl_lower" else tl.ldl_solve
    x_ref = np.asarray(solve_ref(jnp.asarray(ref[0]), n + m, jnp.asarray(rhs)))
    x_got = solve_port(packed[0], n + m, torch.as_tensor(rhs)).numpy()
    scale = np.abs(x_ref).max()
    assert np.abs(x_got - x_ref).max() <= (1e-12 if dtype == np.float64 else 1e-4) * scale
    # and the factors solve the system they factor
    resid = K[0].astype(np.float64) @ x_got - rhs
    assert np.abs(resid).max() <= (1e-10 if dtype == np.float64 else 1e-3) * scale


@pytest.mark.parametrize("variant,n,m,pivots", [
    pytest.param("unrolled", 20, 20, PIVOTS, id="unrolled"),
    pytest.param("fori", 20, 20, PIVOTS, id="fori"),
    pytest.param("blocked", 20, 20, PIVOTS, id="blocked"),
    pytest.param("blocked", 64, 65, PANEL_EDGE_PIVOTS, id="blocked-panel-edges"),
    pytest.param("fori", 128, 128, SWITCH_PIVOTS, id="fori-n256-around-column-16"),
])
def test_dynamic_regularization_fires_on_the_same_pivots(variant, n, m, pivots):
    settings = JaxSettings()
    K = _with_irregular_pivots(_kkt_batch(2, n, m, np.float64, seed=3), pivots)
    ref, ref_ok = _reference(K, n, m, settings, variant)
    kind, packed, ok = _port(K, n, m, settings, variant)
    assert ok.all() and ref_ok.all()
    delta = settings.dynamic_regularization_delta
    d_ref = np.diagonal(ref, axis1=1, axis2=2)
    d_got = np.diagonal(packed.numpy(), axis1=1, axis2=2)
    fired_ref = np.abs(d_ref) == delta
    fired_got = np.abs(d_got) == delta
    assert np.array_equal(fired_got, fired_ref)
    rows = [r for r, _ in pivots]
    assert fired_ref[:, rows].all() and fired_ref.sum() == 2 * len(rows)
    # the + block takes +delta, the - block -delta
    for r in rows:
        assert (d_got[:, r] == (delta if r < n else -delta)).all()
    tol = _tol(K, ref, np.float64)
    assert np.abs(d_got - d_ref).max() <= tol
    for b in range(2):
        assert np.abs(_triangle(packed.numpy()[b], kind) - _triangle(ref[b], kind)).max() <= tol


@pytest.mark.parametrize("variant", ["unrolled", "fori", "blocked"])
def test_regularization_disabled_keeps_every_pivot(variant):
    n = m = 20
    settings = JaxSettings(dynamic_regularization_enable=False)
    K = _kkt_batch(2, n, m, np.float64, seed=4)
    K[:, 0, :] = K[:, :, 0] = 0.0
    K[:, 0, 0] = -1.0  # a wrong-signed pivot, kept as it is
    ref, ref_ok = _reference(K, n, m, settings, variant)
    kind, packed, ok = _port(K, n, m, settings, variant)
    assert ok.all() and ref_ok.all()
    d_got = np.diagonal(packed.numpy(), axis1=1, axis2=2)
    assert (d_got[:, 0] == -1.0).all()
    tol = _tol(K, ref, np.float64)
    assert np.abs(d_got - np.diagonal(ref, axis1=1, axis2=2)).max() <= tol

    # a zero pivot, unregularized, poisons the factor in both packages
    K[:, 0, 0] = 0.0
    _, ref_ok = _reference(K, n, m, settings, variant)
    _, _, ok = _port(K, n, m, settings, variant)
    assert not ok.any() and not ref_ok.any()


@pytest.mark.parametrize("capacity", [H100_SMEM, 48 * 1024], ids=["h100", "48k"])
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
@pytest.mark.parametrize("N", [1, 201, 240, 241, 256, 2001])
def test_unblocked_plan_fits_shared_memory(N, itemsize, capacity):
    """The unblocked kernel's plan: the packed trailing triangle and its
    pad to whole 32-column chunks fit the capacity; the switch column is 0
    whenever the whole triangle fits, and otherwise as small as fits."""
    def nbytes(M):
        return (M * (M + 1) // 2 + -M % 32) * itemsize

    def fits(M):
        return M <= tl.SMEM_MAX_COLS and nbytes(M) <= capacity

    j0, got = tl.unblocked_plan(N, itemsize, capacity)
    M = N - j0
    assert 0 <= j0 < N
    assert got == nbytes(M) <= capacity and fits(M)
    if fits(N):
        assert j0 == 0
    else:
        assert j0 > 0 and not fits(M + 1)
    if capacity == H100_SMEM and itemsize == 8:
        # the f64 triangle fits whole up to N = 240
        assert j0 == max(0, N - 240)


def test_ctypes_signatures_match_the_cuda_source():
    """Every C entry point of csrc/ldl.cu (and of every other kernel source
    build.py binds, csrc/df_lu.cu) is declared in build.py with one ctypes
    type per parameter: a pointer left undeclared would be passed as a
    32-bit int and cut.  Those only a -DDF_LU_PROFILE build has are
    declared apart (build.PROFILE_SIGNATURES), never in the library the
    wrappers load."""
    import re

    from clarabel_tpu_torch.kkt import build

    assert sorted(build._SIGNATURES) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    ctype = {"double": ctypes.c_double, "float": ctypes.c_float, "int": ctypes.c_int}

    def entry_points(text):
        found = {}
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", text, flags=re.M):
            types = []
            for param in params.split(","):
                param = " ".join(param.split())
                if param in ("", "void"):
                    continue
                types.append(ctypes.c_void_p if "*" in param else ctype[param.split()[-2]])
            found[name] = tuple(types)
        return found

    profiled = re.compile(r"^#ifdef DF_LU_PROFILE\n(.*?)^#endif", flags=re.M | re.S)
    for name_cu, signatures in build._SIGNATURES.items():
        source = (build.CSRC / name_cu).read_text()
        extern_c = source[source.index('extern "C" {'):]
        assert entry_points(profiled.sub("", extern_c)) == signatures, name_cu
        assert (entry_points("".join(profiled.findall(extern_c)))
                == build.PROFILE_SIGNATURES.get(name_cu, {})), name_cu

"""Batched unpivoted LDLᵀ of quasidefinite KKT matrices.

Port of ``clarabel_tpu/kkt/pallas_ldl.py``, whose three Pallas TPU kernels
become the hand-written CUDA kernels of ``csrc/ldl.cu``:

==========================================  ============================
TPU kernel (clarabel_tpu/kkt/pallas_ldl.py)   here
==========================================  ============================
``_ldl_kernel_call_blocked`` (K1)             variant ``"blocked"``
``_ldl_kernel_call_unrolled`` (K2)            variant ``"unrolled"``
``_ldl_kernel_call`` (K3)                     variant ``"fori"``
==========================================  ============================

All three compute the reference's QDLDL numeric factorization
(reference: src/qdldl/qdldl.rs:468-700) of K = [[P̃, Aᵀ], [A, -H̃]] without
pivoting, with per-pivot *dynamic regularization* (qdldl.rs:517-527): a pivot
d with ``d * sign < eps`` becomes ``delta * sign``, sign being +1 on the
first n rows and -1 on the m cone rows.  K2 and K3 run the same elimination
and share one CUDA kernel.

:func:`ldl_factor` takes the plain PyTorch version of a kernel for a tensor
on the CPU and launches the kernel for a tensor on a CUDA device; there is
no fallback from one to the other.  ``ldl_factor.launches`` counts the
kernel launches per variant.

Unlike the TPU kernels, nothing here pads N to a multiple of 128: the
factors are N x N.
"""

from __future__ import annotations

import functools
import math

import torch

#: columns per panel of the blocked variant, here and in csrc/ldl.cu
PANEL_WIDTH = 32
#: widest trailing triangle the unblocked kernel keeps in shared memory,
#: here and in csrc/ldl.cu
SMEM_MAX_COLS = 352

VARIANTS = ("blocked", "unrolled", "fori")


def unblocked_plan(N: int, itemsize: int, capacity: int) -> tuple[int, int]:
    """``(j0, nbytes)`` for the unblocked kernel on N x N matrices of
    ``itemsize``-byte entries, with ``capacity`` bytes of shared memory per
    block: steps 0 .. j0 - 1 run in device memory, then the packed upper
    triangle of rows and columns j0 .. N - 1 moves into shared memory:
    M(M+1)/2 entries for M = N - j0, and a pad behind them up to the next
    multiple of 32 columns (the kernel's loads run whole 32-column chunks),
    ``nbytes`` bytes in all.  j0 is 0 when the whole triangle fits."""

    def entries(M):
        return M * (M + 1) // 2 + -M % 32

    M = min(N, SMEM_MAX_COLS, (math.isqrt(8 * (capacity // itemsize) + 1) - 1) // 2)
    while M > 0 and entries(M) * itemsize > capacity:
        M -= 1
    if M < 1:
        raise ValueError(f"{capacity} bytes of shared memory hold no {itemsize}-byte entry")
    return N - M, entries(M) * itemsize


def _regularization(settings):
    """(eps, delta) from settings; (-inf, 0) when dynamic regularization is
    off (pallas_ldl.py:219-222)."""
    if not settings.dynamic_regularization_enable:
        return -float("inf"), 0.0
    return (
        float(settings.dynamic_regularization_eps),
        float(settings.dynamic_regularization_delta),
    )


def _resolve_variant(variant: str, N: int) -> str:
    if variant == "auto":
        # the TPU package's choice (pallas_ldl.py:224-228)
        return "unrolled" if N <= 256 else "blocked"
    if variant not in VARIANTS:
        raise ValueError(f"unknown LDL variant {variant!r}; expected 'auto' or one of {VARIANTS}")
    return variant


# -----------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)
# -----------------------------------------------------------------


def ldl_unblocked_plain(K, sign, eps, delta):
    """Column-by-column LDLᵀ of a batch ``K`` [B, N, N]: the arithmetic of
    the K2/K3 TPU kernels.  Returns the packed factors: Lᵀ strictly above
    the diagonal, D on it, and row j left of the diagonal 0/d_j (zeros for
    a finite nonzero pivot)."""
    out = K.clone()
    N = out.shape[-1]
    for j in range(N):
        d = out[:, j, j]
        s = sign[j]
        d = torch.where(d * s < eps, delta * s, d)
        rowv = out[:, j, j + 1:]
        colv = rowv / d[:, None]
        out[:, j + 1:, j + 1:] -= colv[:, :, None] * rowv[:, None, :]
        out[:, j, :j] = 0.0 / d[:, None]
        out[:, j, j] = d
        out[:, j, j + 1:] = colv
    return out


def ldl_blocked_plain(K, sign, eps, delta, pw=PANEL_WIDTH):
    """Panel-blocked LDLᵀ of a batch ``K`` [B, N, N]: the arithmetic of the
    K1 TPU kernel with panels of ``pw`` columns.  Inside a panel, rank-1
    steps on the panel's columns; then the panel is normalized into L and
    one matrix product updates the trailing block, K22 -= L21·D·L21ᵀ.
    Returns L strictly below the diagonal, D on it (as d + 0·pivot) and
    zeros above."""
    out = K.clone()
    B, N, _ = out.shape
    rows = torch.arange(N, device=out.device)
    for p0 in range(0, N, pw):
        pe = min(p0 + pw, N)
        dvec = torch.ones((B, pe - p0), dtype=out.dtype, device=out.device)
        for j in range(p0, pe):
            d = out[:, j, j]
            s = sign[j]
            d = torch.where(d * s < eps, delta * s, d)
            dvec[:, j - p0] = d
            rowv = out[:, j, j + 1:pe]
            colv = out[:, j + 1:, j] / d[:, None]
            out[:, j + 1:, j + 1:pe] -= colv[:, :, None] * rowv[:, None, :]
        panel = out[:, :, p0:pe]
        diag_pos = rows[p0:pe][None, :]
        below = rows[:, None] > diag_pos
        on = rows[:, None] == diag_pos
        packed = torch.where(
            below,
            panel / dvec[:, None, :],
            torch.where(on, dvec[:, None, :] + 0.0 * panel, 0.0),
        )
        out[:, :, p0:pe] = packed
        if pe < N:
            L21 = out[:, pe:, p0:pe]
            out[:, pe:, pe:] -= (L21 * dvec[:, None, :]) @ L21.mT
    return out


# -----------------------------------------------------------------
# kernel launches
# -----------------------------------------------------------------


@functools.cache
def _smem_capacity() -> int:
    """Shared-memory bytes one block may use on the card, as the card
    reports it to the kernels' library at its first query."""
    from . import build

    capacity = build.library().ldl_smem_capacity()
    if capacity <= 0:
        raise RuntimeError(f"shared-memory capacity query failed: CUDA error {-capacity}")
    return capacity


def _launch(variant, K, sign, eps, delta):
    """Factor the batch ``K`` [B, N, N] on its CUDA device with the
    hand-written kernel; returns the packed factors."""
    from . import build

    lib = build.library()
    if lib.ldl_panel_width() != PANEL_WIDTH or lib.ldl_smem_max_cols() != SMEM_MAX_COLS:
        raise RuntimeError("csrc/ldl.cu and pallas_ldl.py disagree on PANEL_WIDTH or SMEM_MAX_COLS")
    B, N, _ = K.shape
    f64 = K.dtype == torch.float64
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "blocked":
            # the kernel works on K column-major (see csrc/ldl.cu)
            out = K.mT.contiguous()
            # scratch: the pivots, and one panel's diagonal-block columns
            dbuf = torch.empty((B, N), dtype=K.dtype, device=K.device)
            ubuf = torch.empty((B, PANEL_WIDTH, PANEL_WIDTH), dtype=K.dtype, device=K.device)
            fn = lib.ldl_blocked_f64 if f64 else lib.ldl_blocked_f32
            err = fn(out.data_ptr(), dbuf.data_ptr(), ubuf.data_ptr(), sign.data_ptr(),
                     B, N, eps, delta, stream)
        else:
            out = K.clone(memory_format=torch.contiguous_format)
            j0, nbytes = unblocked_plan(N, K.element_size(), _smem_capacity())
            fn = lib.ldl_unblocked_f64 if f64 else lib.ldl_unblocked_f32
            err = fn(out.data_ptr(), sign.data_ptr(), B, N, j0, nbytes, eps, delta, stream)
    if err != 0:
        raise RuntimeError(f"LDL kernel ({variant}) launch failed: CUDA error {err}")
    return out


def ldl_factor(K, n: int, m: int, settings, variant: str = "auto"):
    """Factor the regularized KKT matrix ``K`` ([n+m, n+m] or a batch
    [B, n+m, n+m], float32 or float64).

    Returns ``((kind, (packed, N)), ok)``: kind ``"pldl_lower"`` for the
    blocked variant (L below the diagonal), ``"pldl"`` for the others (Lᵀ
    above it), as the TPU package returns them, and ``ok`` =
    all(isfinite(packed)) per matrix.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel and raises if it cannot.
    """
    N = n + m
    batched = K.dim() == 3
    Kb = K if batched else K.unsqueeze(0)
    if Kb.dim() != 3 or Kb.shape[-2:] != (N, N):
        raise ValueError(f"expected K of shape [N, N] or [B, N, N] with N={N}, got {tuple(K.shape)}")
    if Kb.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"LDL factor supports float32 and float64, got {Kb.dtype}")
    variant = _resolve_variant(variant, N)
    eps, delta = _regularization(settings)
    # expected inertia signs: +1 for the first n entries, -1 for the m cone
    # rows (directldlkktsolver.rs:392-405)
    sign = torch.ones(N, dtype=Kb.dtype, device=Kb.device)
    sign[n:] = -1.0

    if Kb.device.type == "cpu":
        if variant == "blocked":
            packed = ldl_blocked_plain(Kb, sign, eps, delta)
        else:
            packed = ldl_unblocked_plain(Kb, sign, eps, delta)
    elif Kb.device.type == "cuda":
        packed = _launch(variant, Kb, sign, eps, delta)
        ldl_factor.launches[variant] += 1
    else:
        raise RuntimeError(f"no LDL kernel for device {Kb.device}")

    ok = torch.isfinite(packed).flatten(1).all(dim=1)
    if not batched:
        packed, ok = packed[0], ok[0]
    kind = "pldl_lower" if variant == "blocked" else "pldl"
    return (kind, (packed, N)), ok


ldl_factor.launches = {v: 0 for v in VARIANTS}


def make_ldl_factor(n: int, m: int, settings, dtype=None, variant: str = "auto"):
    """The factor function for (n + m)-dimensional KKT matrices, as
    ``clarabel_tpu.kkt.pallas_ldl.make_ldl_factor`` returns it:
    ``factor(K_reg) -> ((kind, (packed, N)), ok)``.  ``dtype`` is taken for
    signature parity; the kernels follow the tensor's own dtype."""
    del dtype
    return lambda K_reg: ldl_factor(K_reg, n, m, settings, variant)


# -----------------------------------------------------------------
# solves with the packed factors
# -----------------------------------------------------------------


def _solve(packed, N, rhs, lower_layout):
    del N  # the factors are not padded: packed is [..., N, N]
    vec = rhs.dim() == packed.dim() - 1
    b = rhs.unsqueeze(-1) if vec else rhs
    d = torch.diagonal(packed, dim1=-2, dim2=-1).unsqueeze(-1)
    # unitriangular solves read one strict triangle of ``packed`` and
    # neither its diagonal (D) nor the other triangle
    L = packed if lower_layout else packed.mT
    y = torch.linalg.solve_triangular(L, b, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(L.mT, y / d, upper=True, unitriangular=True)
    return x.squeeze(-1) if vec else x


def ldl_solve_lower(packed, N, rhs):
    """Solve K x = rhs from the blocked layout: L strictly below the
    diagonal, D on it (pallas_ldl.py:257-271)."""
    return _solve(packed, N, rhs, lower_layout=True)


def ldl_solve(packed, N, rhs):
    """Solve K x = rhs from the unblocked layout: Lᵀ strictly above the
    diagonal, D on it (pallas_ldl.py:274-295)."""
    return _solve(packed, N, rhs, lower_layout=False)

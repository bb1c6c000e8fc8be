"""The card's published peaks and the work of a dense KKT factorization.

Peaks: NVIDIA's H100 SXM data sheet (FP64 through the tensor cores, FP32
outside them; HBM3 bandwidth), the figures a roofline share is stated
against.  The work formula is frozen here from the port's ``chip_smoke.py``
(``bound_ms``), so that a later change to the program cannot move the
yardstick.
"""

#: operations per second by element size in bytes (8: FP64 tensor cores,
#: 4: FP32 without TF32)
PEAK_FLOPS = {8: 67e12, 4: 67e12}
#: HBM3 bytes per second
PEAK_BYTES = 3.35e12


def factor_flops(B: int, N: int) -> float:
    """Operations of B factorizations of N x N: N³/3 each (N³/6
    multiply-adds, as a Cholesky factorization counts them)."""
    return B * N**3 / 3.0


def factor_bytes(B: int, N: int, itemsize: int = 8) -> float:
    """Bytes of B factorizations of N x N: K read once and the factor
    written once."""
    return B * 2.0 * N * N * itemsize


def factor_bound_s(B: int, N: int, itemsize: int = 8) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of B factorizations of
    N x N on the card: the larger of the two bounds."""
    t_ops = factor_flops(B, N) / PEAK_FLOPS[itemsize]
    t_bytes = factor_bytes(B, N, itemsize) / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

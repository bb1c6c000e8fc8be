"""The dense KKT factorizations' share of their roofline in the traced
calls.

The least time of one factorization of B matrices N x N is the larger of
B·N³/3 operations at the card's peak and B·2·N² elements moved at its
bandwidth (``benchmark/work.py``), whatever implements it, so the LDLᵀ
kernels and the LU read on one scale.  The share is that least time times
the factorizations counted in the trace, over the device time of the
factorizations' kernels:

- the hand-written LDLᵀ (``kkt/csrc/ldl.cu``): every kernel named
  ``ldl_*_kernel``; one factorization per ``ldl_unblocked_kernel`` (K2)
  or ``ldl_finalize_kernel`` (K1's last launch);
- the LU (``torch.linalg.lu_factor_ex`` in ``kkt/dense.py``): every device
  operation launched inside a host operator ``aten::linalg_lu_factor_ex``,
  one factorization per such operator.
"""

from benchmark import work

UNIT = "%"
SOURCE = "device_trace"
LAYER = "KKT factor: kkt/pallas_ldl.py and kkt/csrc/ldl.cu, or the LU of kkt/dense.py"
MOVES = "solves_per_s"

LDL_KERNELS = r"\bldl_\w+_kernel\b"
LDL_ONE_PER_FACTOR = r"\bldl_(unblocked|finalize)_kernel\b"
LU_OP = "aten::linalg_lu_factor_ex"


def factor_time(tr) -> tuple[int, float]:
    """(factorizations, device seconds of their kernels) in trace ``tr``."""
    ldl = tr.kernels(LDL_KERNELS)
    if ldl:
        return len(tr.kernels(LDL_ONE_PER_FACTOR)), sum(k.dur for k in ldl)
    lu = tr.outermost_ops(LU_OP)
    if lu:
        return len(lu), sum(k.dur for k in tr.launched_within(lu))
    return 0, 0.0


def read(run):
    if run.trace is None:
        return None
    count, seconds = factor_time(run.trace)
    if not count or seconds <= 0:
        return None
    bound, _ = work.factor_bound_s(run.lanes, run.kkt_dim, run.itemsize)
    return 100.0 * count * bound / seconds

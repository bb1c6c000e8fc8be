"""The factor's work formula against hand counts, and the trace readers on
traces written by hand."""

import types

import pytest

from benchmark import trace, work
from benchmark.metrics import device_idle_pct, factor_roofline_pct


def test_factor_work_by_hand():
    # one 3 x 3 factor: 27/3 = 9 operations; K read and the factor written,
    # 2 * 9 elements of 8 bytes
    assert work.factor_flops(1, 3) == 9.0
    assert work.factor_bytes(1, 3) == 144.0
    # the portfolio cells: 4096 x 201², bound by bytes
    t, kind = work.factor_bound_s(4096, 201)
    assert kind == "bytes"
    assert t == pytest.approx(4096 * 2 * 201**2 * 8 / 3.35e12)
    assert t * 1e3 == pytest.approx(0.7908, rel=1e-3)
    # the max-cut cells: one 10200², bound by operations (PERF.md: 5.28 ms)
    t, kind = work.factor_bound_s(1, 10200)
    assert kind == "operations"
    assert t * 1e3 == pytest.approx(10200**3 / 3 / 67e12 * 1e3)
    assert t * 1e3 == pytest.approx(5.28, rel=1e-3)
    # f32 elements are 4 bytes
    assert work.factor_bytes(2, 10, 4) == 2 * 2 * 100 * 4


def _ev(cat, name, ts, dur, tid=1, corr=None):
    ev = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=0)
    if corr is not None:
        ev["args"] = dict(correlation=corr)
    return ev


def test_union_and_gaps():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]
    tr = trace.Trace([
        _ev("user_annotation", "bench.construct", 0, 10),
        _ev("user_annotation", "bench.solve", 10, 90),
        _ev("kernel", "a", 20, 10, corr=1), _ev("kernel", "b", 25, 10, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 5, corr=3),
        _ev("kernel", "late", 150, 10, corr=4),  # outside the traced window
        _ev("gpu_user_annotation", "bench.solve", 10, 90),  # a range, not work
    ])
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(20e-6)  # [20, 35) and [60, 65)
    assert tr.gaps() == [pytest.approx((0, 20e-6)), pytest.approx((35e-6, 60e-6)),
                         pytest.approx((65e-6, 100e-6))]
    run = types.SimpleNamespace(trace=tr)
    assert device_idle_pct.read(run) == pytest.approx(80.0)


def test_breakdown_names_ops_and_labels_idle_time():
    tr = trace.Trace([
        _ev("user_annotation", "bench.solve", 0, 100),
        _ev("cpu_op", "aten::linalg_eigh", 10, 50),
        _ev("cpu_op", "aten::copy_", 20, 5),
        _ev("kernel", "void ldl_unblocked_kernel<double, 8>(double*, int)", 0, 10, corr=1),
        _ev("kernel", "void ldl_unblocked_kernel<double, 8>(double*, int)", 60, 10, corr=2),
    ])
    out = tr.breakdown()
    assert out["device_ops"] == [["ldl_unblocked_kernel<double, 8>", pytest.approx(20e-6)]]
    labels = dict((k, v) for k, v in out["idle_gaps"])
    # the gap [10, 60) is labelled at its middle, 35: inside linalg_eigh only
    assert labels["bench.solve / aten::linalg_eigh"] == pytest.approx(50e-6)
    assert labels["bench.solve / no operator"] == pytest.approx(30e-6)


def _run(tr, lanes, N):
    return types.SimpleNamespace(trace=tr, lanes=lanes, kkt_dim=N, itemsize=8)


def test_roofline_of_the_ldl_kernels():
    # two K1 factors: each a diag, a trailing and a finalize kernel
    events = [_ev("user_annotation", "bench.solve", 0, 1e6)]
    for f in range(2):
        t = f * 1e5
        events += [_ev("kernel", "void ldl_diag_kernel<double>(double*)", t, 1e3),
                   _ev("kernel", "void ldl_trailing_kernel<double>(double*)", t + 1e3, 8e3),
                   _ev("kernel", "void ldl_finalize_kernel<double>(double*, int)", t + 9e3, 1e3),
                   _ev("kernel", "void trsv_kernel<double>(double*)", t + 2e4, 5e3)]
    tr = trace.Trace(events)
    count, seconds = factor_roofline_pct.factor_time(tr)
    assert count == 2 and seconds == pytest.approx(0.02)
    bound, _ = work.factor_bound_s(1, 10200)
    assert factor_roofline_pct.read(_run(tr, 1, 10200)) == pytest.approx(100 * 2 * bound / 0.02)


def test_roofline_of_the_lu_by_the_operator_that_launched_it():
    events = [_ev("user_annotation", "bench.solve", 0, 1000)]
    for f, t in enumerate((100, 500)):
        events += [_ev("cpu_op", "aten::linalg_lu_factor_ex", t, 50),
                   _ev("cpu_op", "aten::linalg_lu_factor_ex", t + 5, 40),  # nested: one factor
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 10, 2, corr=10 * f + 1),
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 20, 2, corr=10 * f + 2),
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 60, 2, corr=10 * f + 3),
                   _ev("kernel", "getrf", t + 15, 30, corr=10 * f + 1),
                   _ev("kernel", "gemm", t + 50, 20, corr=10 * f + 2),
                   _ev("kernel", "lu_solve", t + 80, 40, corr=10 * f + 3)]  # launched outside
    tr = trace.Trace(events)
    count, seconds = factor_roofline_pct.factor_time(tr)
    assert count == 2 and seconds == pytest.approx(100e-6)
    bound, _ = work.factor_bound_s(4, 20)
    assert factor_roofline_pct.read(_run(tr, 4, 20)) == pytest.approx(100 * 2 * bound / 100e-6)


def test_readers_read_nothing_without_a_trace():
    empty = trace.Trace([_ev("user_annotation", "bench.solve", 0, 10)])
    for tr in (None, empty):
        assert factor_roofline_pct.read(_run(tr, 1, 10)) is None
        assert device_idle_pct.read(types.SimpleNamespace(trace=tr)) is None

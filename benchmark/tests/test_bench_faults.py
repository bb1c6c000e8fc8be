"""The whole of a run, on the CPU at a small size, with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have, and true without one.  (These cells run on one card and exchange
nothing between cards, so no fault of an exchange applies.)"""

import contextlib
import time

import numpy as np
import pytest

import clarabel_tpu_torch as tt
from benchmark import harness
from clarabel_tpu_torch import loop, solver
from clarabel_tpu_torch.parallel import batch

SMALL = {
    "portfolio_b4096_pallas": {"config": {"assets_per_factor": 4, "factors": 2},
                               "traffic": {"lanes": 6, "trace_calls": 1}},
    "maxcut100_auto": {"config": {"vertices": 6, "edges": 8},
                       "traffic": {"pool": 3, "trace_calls": 1}},
}


def _run(name, trace=False):
    cell = harness.load_cell(name, overrides=SMALL[name])
    return harness.run(cell, 2**31 + 41, 0.3, trace, time.perf_counter(), device="cpu")


@contextlib.contextmanager
def state_unchanged(monkeypatch):
    """Every IPM step returns the iterate it was given (its counters and
    statuses move on)."""
    real = loop._select_state

    def select(mask, new, old):
        return real(mask, new._replace(x=old.x, s=old.s, z=old.z, tau=old.tau,
                                       kappa=old.kappa), old)

    monkeypatch.setattr(loop, "_select_state", select)
    yield


@contextlib.contextmanager
def answer_altered(monkeypatch):
    """One entry of x altered where the solve produces it."""
    real = solver.build_solve_core

    def build(*args, **kwargs):
        core = real(*args, **kwargs)

        def altered(*a, **k):
            out = core(*a, **k)
            x = out["x"].clone()
            x.view(-1)[0] += 1e-3
            return dict(out, x=x)
        return altered

    monkeypatch.setattr(solver, "build_solve_core", build)
    monkeypatch.setattr(batch, "build_solve_core", build)
    yield


@contextlib.contextmanager
def half_batch_left_out(monkeypatch):
    """The batch solves its first half of lanes and hands their answers to
    the second half too."""
    real_init, real_solve = batch.BatchSolver.__init__, batch.BatchSolver.solve

    def init(self, P, q, A, b, cones, settings=None, **kw):
        half = len(q) // 2
        real_init(self, P[:half], q[:half], A[:half], b[:half], cones, settings, **kw)

    def solve(self, *a, **k):
        sol = real_solve(self, *a, **k)
        for f in ("x", "z", "s", "status", "obj_val", "iterations"):
            v = getattr(sol, f)
            setattr(sol, f, np.concatenate([v, v]))
        return sol

    monkeypatch.setattr(batch.BatchSolver, "__init__", init)
    monkeypatch.setattr(batch.BatchSolver, "solve", solve)
    monkeypatch.setattr(tt, "BatchSolver", batch.BatchSolver)
    yield


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_runs_are_correct(name):
    for trace in (False, True):
        result = _run(name, trace)
        assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
        assert list(result)[-1] == "checks"
        want = {"solves_per_s", "setup_s"} if not trace else {
            "construct_ms", "ms_per_iteration", "iterations_per_solve"}
        assert want <= set(result["metrics"])


@pytest.mark.parametrize("name,fault", [
    ("portfolio_b4096_pallas", state_unchanged),
    ("portfolio_b4096_pallas", answer_altered),
    ("portfolio_b4096_pallas", half_batch_left_out),
    ("maxcut100_auto", state_unchanged),
    ("maxcut100_auto", answer_altered),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    with fault(monkeypatch):
        result = _run(name)
    assert not result["correct"] and result["failed"] > 0

"""The reference accepts a solution the port solved to its tolerances and
refuses a perturbed one and the control's: the same program at float32
(``DefaultSettings.for_float32``), at sizes a test run holds, on the CPU."""

import numpy as np
import pytest

from benchmark import control, harness
from benchmark.reference import kkt

SMALL = {
    "portfolio_b4096_pallas": {"config": {"assets_per_factor": 5, "factors": 2}, "traffic": {"lanes": 6}},
    "portfolio_b4096_auto": {"config": {"assets_per_factor": 5, "factors": 2}, "traffic": {"lanes": 6}},
    "maxcut100_auto": {"config": {"vertices": 7, "edges": 10}},
    "maxcut100_pallas": {"config": {"vertices": 7, "edges": 10}},
}


def _solve(name, seed=3, dtype=None):
    cell = harness.load_cell(name, overrides=SMALL[name])
    program = harness.Program(cell, "cpu", dtype)
    inst = harness.make_pool(cell, seed)[0]
    return cell, inst, program.call(inst, 0)


@pytest.mark.parametrize("name", list(SMALL))
def test_accepts_the_solution_and_refuses_a_perturbed_one(name):
    cell, inst, call = _solve(name)
    limits = cell.config["limits"]
    assert kkt.judge([(inst, call.out)], limits)["correct"]
    for key, bump in (("x", 1e-4), ("z", 1e-4), ("obj_val", 1e-6)):
        out = {k: np.array(v, copy=True) for k, v in call.out.items()}
        out[key].flat[0] += bump
        verdict = kkt.judge([(inst, out)], limits)
        assert not verdict["correct"] and verdict["failed"] == 1, key
    out = dict(call.out, status=np.array(["AlmostSolved"] + list(call.out["status"][1:])))
    assert kkt.judge([(inst, out)], limits)["worst"]["not_solved"] == 1


@pytest.mark.parametrize("name", list(SMALL))
def test_the_float32_control_is_refused(name):
    cell = harness.load_cell(name, overrides=SMALL[name])
    for seed in (5, 6, 7):
        reading = control.readings(cell, seed, device="cpu")
        assert not reading["correct"], reading
        assert reading["worst"]["gap"] > cell.config["limits"]["gap"] or \
            reading["worst"]["res"] > cell.config["limits"]["res"]


def test_cone_distance_by_hand():
    cones = [["ZeroConeT", [1]], ["NonnegativeConeT", [2]], ["PSDTriangleConeT", [2]]]
    # s: zero row 0.5, nonneg (-3, 1), PSD diag(-4, 1) as svec (x11, √2·x12, x22)
    s = np.array([[0.5, -3.0, 1.0, -4.0, 0.0, 1.0]])
    assert kkt.cone_distance(s, cones, dual=False) == pytest.approx([np.sqrt(0.25 + 9 + 16)])
    # the dual of the zero cone is everything
    assert kkt.cone_distance(s, cones, dual=True) == pytest.approx([5.0])
    with pytest.raises(ValueError):
        kkt.cone_distance(s, [["SecondOrderConeT", [6]]], dual=False)
    with pytest.raises(ValueError):
        kkt.cone_distance(s, [["NonnegativeConeT", [5]]], dual=False)

"""BENCHMARK.json against the benchmark's contract, and every configuration,
traffic mix and metric found by its name."""

import json
import re

import pytest

from benchmark import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128
    assert len(json.dumps(MANIFEST).encode()) <= 64 * 1024


def test_names_units_and_keys():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["traffic"] for w in MANIFEST["workloads"]])
    assert all(NAME.match(n) for n in names), names
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for text in [c["why"] for c in MANIFEST["configs"]] + [c["source"] for c in MANIFEST["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(harness.call_module(cell.traffic["call"]).make)
    assert cell.traffic["pool"] >= 2 and cell.traffic["trace_calls"] >= 1
    assert set(cell.config["limits"]) == {"not_solved", "res", "gap", "obj"}
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    assert {"setup_s", "solves_per_s"} <= {m["name"] for m in cell.metrics("end_to_end")}
    assert cell.metrics("per_layer")


@pytest.mark.parametrize("entry", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_reader_matches_its_entry(entry):
    mod = harness.metric_module(entry["name"])
    assert mod.UNIT == entry["unit"] and mod.SOURCE == entry["source"]
    if "layer" in entry:
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
    assert callable(mod.read)


def test_metrics_of_one_layer_name_it_alike():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("name", CELLS)
def test_entry_and_cones_are_the_ports_and_the_reference_has_each(name):
    """The traffic's entry names a class of the port, each cone of the cell's
    instances a cone constructor of the port, and the reference has a module
    for each cone, covering the rows the port's cone covers."""
    import clarabel_tpu_torch as tt

    from benchmark.reference import kkt

    cell = harness.load_cell(name)
    assert isinstance(getattr(tt, cell.traffic["entry"]), type)
    small = {"lanes": 2} if cell.lanes else {}
    inst = harness.make_pool(harness.load_cell(name, overrides={"traffic": small}), 1)[0]
    for kind, args in inst["cones"]:
        assert kkt.cone_module(kind).rows(*args) == getattr(tt, kind)(*args).nvars

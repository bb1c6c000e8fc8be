"""The command's refusals: no result without a card, in a directory that
holds only the benchmark, or once JAX or the JAX package was loaded."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "clarabel_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "clarabel_tpu.kkt", types.ModuleType("x"))
    assert run.forbidden_modules() == ["clarabel_tpu.kkt", "jaxlib.xla_client"]


def test_no_result_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "maxcut100_auto", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "CUDA" in out.err


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "maxcut100_auto",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "not in this checkout" in proc.stderr


@pytest.mark.card
def test_every_cell_runs_on_the_card(card):
    """Each cell for two seconds on the card: correct, and every metric of
    its kind reported."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for work in manifest["workloads"]:
        for trace in (0, 1):
            proc = subprocess.run(
                [sys.executable, "benchmark/run.py", "--workload", work["name"], "--seed",
                 str(2**31 + 5), "--seconds", "2", "--trace", str(trace)],
                cwd=ROOT, capture_output=True, text=True, timeout=360)
            assert proc.returncode == 0, proc.stderr[-2000:]
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            assert line["correct"] and line["device"]["kind"] == card
            kind = manifest["per_layer" if trace else "end_to_end"]
            want = {m["name"] for m in kind if work["name"] in m.get("workloads", [work["name"]])}
            assert set(line["metrics"]) == want

"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
``clarabel_tpu_torch`` is not ``clarabel_tpu``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "clarabel_tpu", "bench", "chip_smoke"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_walks_every_module():
    assert len(MODULES) >= 20
    assert BENCH / "run.py" in MODULES and BENCH / "reference" / "kkt.py" in MODULES


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "clarabel_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & {"torch", "benchmark"}


def test_the_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import jax.numpy\nfrom clarabel_tpu.kkt import dense\nimport clarabel_tpu_torch\n")
    assert top_level_imports(bad) == {"jax", "clarabel_tpu", "clarabel_tpu_torch"}
    assert top_level_imports(bad) & NEVER == {"jax", "clarabel_tpu"}

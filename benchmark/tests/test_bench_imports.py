"""What the benchmark may import: nothing under ``benchmark/`` loads JAX
or the JAX package, and the reference loads nothing of the program.
Top-level module names are compared whole: the program's name begins with
the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "motionbert_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "motionbert_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "math", "torch"}


def test_the_scan_sees_whole_names(tmp_path):
    tmp = tmp_path / "probe.py"
    tmp.write_text("import motionbert_tpu_torch.api\nfrom jaxlib import x\n"
                   "import importlib\nimportlib.import_module('flax.linen')\n")
    names = _top_level_imports(tmp)
    assert names & JAX_NAMES == {"jaxlib", "flax"}
    assert "motionbert_tpu_torch" in names

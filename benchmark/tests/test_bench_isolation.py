"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared
by whole top-level module names (``sml_tpu_torch`` is not
``sml_tpu``); the reference imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sml_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "sml_tpu_torch" not in set(top_level_imports(path))


def test_the_comparison_is_by_whole_names():
    import harness
    import sys
    sys.modules.setdefault("sml_tpu_torch_probe_name", sys)
    try:
        assert "sml_tpu_torch_probe_name" not in harness.forbidden_loaded()
    finally:
        del sys.modules["sml_tpu_torch_probe_name"]

"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: every import statement,
compared by its top-level name (the part before the first dot)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "joxsz_tpu"}


def top_level_imports(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_top_level_name_is_compared_whole():
    assert "joxsz_torch".split(".")[0] not in FORBIDDEN
    assert "joxsz_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert "joxsz_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)

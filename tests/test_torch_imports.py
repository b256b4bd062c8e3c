"""The port stands alone: no module of ``joxsz_torch`` (nor the chip check
``chip_smoke.py``) imports ``jax`` or anything of ``joxsz_tpu``.

Checked twice: statically, on every import statement of every source
file, and dynamically, by importing every module in a fresh interpreter
and reading ``sys.modules``.
"""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "joxsz_torch"
FORBIDDEN = ("jax", "jaxlib", "joxsz_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    out = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert '"kernels"' not in out.stdout


def test_chip_smoke_without_a_card_fails():
    """Here there is no CUDA device: the script stops before any phase
    and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    _no_result(_run_smoke(REPO))


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _no_result(_run_smoke(tmp_path))

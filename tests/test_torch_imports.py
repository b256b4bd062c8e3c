"""The port stands alone: no module of ``joxsz_torch`` (nor the chip check
``chip_smoke.py``, nor the port's scripts ``scripts/torch_*.py``) imports
``jax`` or anything of ``joxsz_tpu``, and none imports h5py or matplotlib
outside a function (the card may lack both).

Checked twice: statically, on every import statement of every source
file, and dynamically, by importing every module in a fresh interpreter
and reading ``sys.modules``.  Both walk the package's files, so a new
module is covered as soon as it exists; ``EXPECTED`` names the modules a
slice must not lose.  The entry points ask for the card unless ``--cpu``
is passed, and every CUDA source has a binding.
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
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("torch_*.py")))


def _modules():
    out = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


# modules of the slices so far that must stay importable without JAX
EXPECTED = ["joxsz_torch.run", "joxsz_torch.survey", "joxsz_torch.simulate",
            "joxsz_torch.models.multicluster", "joxsz_torch.ops.sz_core",
            "joxsz_torch.ops.consts_layout",
            "joxsz_torch.ops.multicluster_kernel",
            "joxsz_torch.ops.joint_kernel", "joxsz_torch.ops.step_kernel",
            "joxsz_torch.sampling.batched", "joxsz_torch.sampling.kernel",
            "joxsz_torch.sampling.driver", "joxsz_torch.ops.coupled_kernel",
            "joxsz_torch.parallel", "joxsz_torch.parallel.mesh",
            "joxsz_torch.parallel.sharded",
            "joxsz_torch.parallel.kernel_sharded",
            "joxsz_torch.sampling.mle", "joxsz_torch.io.checkpoint",
            "joxsz_torch.postproc", "joxsz_torch.postproc.summary",
            "joxsz_torch.postproc.profiles", "joxsz_torch.postproc.ppc",
            "joxsz_torch.postproc.pin", "joxsz_torch.plotting",
            "joxsz_torch.plotting.figures", "joxsz_torch.sampling.population",
            "joxsz_torch.io.ogip", "joxsz_torch.tablegen",
            "joxsz_torch.tablegen.spectrum", "joxsz_torch.tablegen.generate",
            "joxsz_torch.tablegen.import_xspec_cache"]
# optional packages the port imports only inside the functions that need
# them: the card may lack them, and importing the port must not
LAZY = ("h5py", "matplotlib")


@pytest.mark.parametrize("module", EXPECTED)
def test_expected_module_is_walked(module):
    assert module in _modules()


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


def _module_level_roots(tree: ast.Module):
    """Import roots of statements that run when the module is imported:
    everything outside function bodies (classes, if/try blocks count)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_h5py_and_matplotlib_only_inside_functions(path):
    roots = set(_module_level_roots(ast.parse(path.read_text())))
    assert not roots & set(LAZY), (path, roots & set(LAZY))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN + LAZY!r})\n"
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


@pytest.mark.parametrize("cpu", [False, True], ids=["card", "cpu"])
@pytest.mark.parametrize("entry", ["run", "survey", "tablegen.generate",
                                   "tablegen.import_xspec_cache"])
def test_entry_points_ask_for_the_card_unless_cpu(entry, cpu, monkeypatch):
    """``run.main``, ``survey.main`` and the table CLIs resolve their
    device first: ``None`` (the card, or an error without one) unless
    ``--cpu``."""
    import importlib

    import joxsz_torch.device

    class Asked(Exception):
        pass

    def spy(device=None):
        raise Asked(device)

    monkeypatch.setattr(joxsz_torch.device, "resolve_device", spy)
    table = ["--rmf", "none.rmf", "--arf", "none.arf", "--z", "0.5",
             "--nh", "0.01", "--out", "none.npz"]
    argv = {"run": ["--config", "none.json"],
            "survey": ["--mock", "2", "--config", "none.json"],
            "tablegen.generate": table,
            "tablegen.import_xspec_cache": table + ["--cache", "none.h5"],
            }[entry]
    main = importlib.import_module(f"joxsz_torch.{entry}").main
    with pytest.raises(Asked) as asked:
        main(argv + (["--cpu"] if cpu else []))
    assert asked.value.args == (("cpu" if cpu else None),)


def test_every_cuda_source_has_a_binding():
    from joxsz_torch.ops import _build

    assert set(_build.SIGNATURES) == {f.stem for f in
                                      _build.CSRC.glob("*.cu")}

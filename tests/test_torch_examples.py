"""The port's examples (``examples/torch_*.py``) run end to end at
``--cpu --smoke``, each in a subprocess, as ``tests/test_examples.py``
runs the JAX package's.  ``model_comparison`` is marked slow, as its JAX
twin is; ``chip_smoke.py`` (phase 25) runs all three on the card."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"


def _run(name, marker, *extra, timeout=300):
    # one intra-op thread: the tests run several workers side by side
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / name), "--cpu", "--smoke", *extra],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
        env=env)
    assert proc.returncode == 0, \
        f"{name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    assert marker in proc.stdout, \
        f"{name}: expected output marker {marker!r} missing:\n" \
        f"{proc.stdout[-2000:]}"
    return proc.stdout


def test_torch_custom_pressure_example():
    out = _run("torch_custom_pressure.py", "(plain samplers)")
    assert r"\beta_P" in out and "r_{c,P}" in out


def test_torch_multicluster_example():
    _run("torch_multicluster_fit.py", "acceptance per cluster")


@pytest.mark.slow
def test_torch_model_comparison_example(tmp_path):
    _run("torch_model_comparison.py", "log Bayes factors",
         "--out", str(tmp_path / "ev.json"), timeout=900)
    assert (tmp_path / "ev.json").exists()

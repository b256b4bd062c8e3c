"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``, through the manifest's ``file``), its traffic
mix (``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and
each metric's reader (``metrics/<metric>.py``), all found by name."""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, w: dict, root: pathlib.Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == w["config"]:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no configuration {w['config']!r} in BENCHMARK.json")


def traffic(w: dict, bench: pathlib.Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{w['traffic']}.json")
                      .read_text())


def limits(w: dict, bench: pathlib.Path = BENCH) -> dict:
    return json.loads((bench / "limits" / f"{w['name']}.json").read_text())


def metrics_of(manifest: dict, w: dict, trace: bool) -> list[dict]:
    """The metrics a run of cell ``w`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced; a metric without
    ``workloads`` belongs to every cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if w["name"] in m.get("workloads", [w["name"]])]


def reader(name: str, bench: pathlib.Path = BENCH):
    """The ``read(run) -> float | None`` of ``metrics/<name>.py``; a name
    with a group prefix (``survey.step_kernel_us``: the same quantity in
    another group of cells) falls back to the reader of the name without
    it (``metrics/step_kernel_us.py``)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench / "metrics" / f"{name.split('.', 1)[1]}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""Fixtures of the benchmark's tests: a dataset of each configuration,
made once per session by the benchmark's own forward model."""

import json
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ("cl1226_flagship", "cl1226_knots_vt")


@pytest.fixture(scope="session")
def datasets(tmp_path_factory):
    from benchmark.reference.data import write_dataset

    out = {}
    for name in CONFIGS:
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        out[name] = write_dataset(cfg, tmp_path_factory.mktemp(name))
    return out

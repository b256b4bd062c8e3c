"""``BENCHMARK.json`` against the benchmark's contract, every cell's
files found by name, a new metric or traffic file picked up without an
edit, and the shape of the result's last line on a stubbed run."""

import json
import re
import shutil

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import check, jobs, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(
        1, len(man["workloads"]) // 4)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_what_its_metrics_move(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(man, w, False)}
        layer = manifest.metrics_of(man, w, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def test_every_cell_resolves_its_files(man):
    for w in man["workloads"]:
        cfg = manifest.config(man, w)
        assert cfg["name"] == w["config"] and cfg["reduced"] == []
        kind = manifest.traffic(w)["kind"]
        assert jobs.kind(kind).kind == kind
        law = {"move_acc_z"} | ({"swap_acc_z"} if kind == "tempered"
                                else set())
        assert set(manifest.limits(w)) == {"lp_gap", "stuck_share"} | law
        for trace in (False, True):
            for m in manifest.metrics_of(man, w, trace):
                assert callable(manifest.reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path, man):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "metrics" / "swap_acc.py").write_text(
        "def read(run):\n    return 0.25\n")
    (bench / "traffic" / "tempered_w64.json").write_text(json.dumps(
        {"kind": "tempered", "init_spread": 0.01, "check_frames": 16,
         "schedule": {"walkers": 64}}))
    (bench / "limits" / "flagship.tempered_w64.json").write_text(
        json.dumps({"lp_gap": 0.05, "stuck_share": 0.05}))
    # a traffic kind of its own: a file under traffic/, no edit elsewhere
    (bench / "traffic" / "replay.py").write_text(
        "class Jobs:\n"
        "    kind = 'replay'\n\n"
        "    def __init__(self, config, traffic, seed, workdir, device):\n"
        "        self.args = (config['name'], traffic['rate'], seed)\n")
    (bench / "traffic" / "replay_r2.json").write_text(json.dumps(
        {"kind": "replay", "rate": 2.0}))
    man = json.loads(json.dumps(man))
    w = {"name": "flagship.tempered_w64", "config": "cl1226_flagship",
         "traffic": "tempered_w64", "chips": 1, "why": "a test"}
    man["workloads"].append(w)
    man["per_layer"].append({"name": "swap_acc", "unit": "%",
                             "better": "higher", "source": "program_counter",
                             "layer": "tempered sampler",
                             "moves": "evals_per_s"})
    assert manifest.reader("swap_acc", bench)(None) == 0.25
    # a group's copy of a metric reads with the metric's reader
    assert manifest.reader("mesh.swap_acc", bench)(None) == 0.25
    assert manifest.traffic(w, bench)["schedule"] == {"walkers": 64}
    assert manifest.limits(w, bench)["lp_gap"] == 0.05
    r = {"name": "flagship.replay_r2", "config": "cl1226_flagship",
         "traffic": "replay_r2", "chips": 1, "why": "a test"}
    tj = jobs.make(manifest.config(man, r), manifest.traffic(r, bench), 7,
                   tmp_path, "cpu", bench)
    assert tj.kind == "replay" and tj.args == ("cl1226_flagship", 2.0, 7)
    assert "swap_acc" in [m["name"] for m in manifest.metrics_of(man, w,
                                                                 True)]


class _StubJobs:
    kind = "tempered"
    launch_steps = [100]
    evals_per_step = 8
    thin = 25
    W = 4
    setup_parts = {}
    shapes = {"n_press": 313, "n_pix": 86, "n_data": 19, "sep": 85,
              "n_sh": 15, "n_ann": 15, "n_band": 10, "nT": 64, "n_conv": 41,
              "D": 13, "knots": 0, "t_vikh": False, "double": False,
              "mass_veto": True}

    def __init__(self, *a):
        import torch

        self.device = torch.device("cpu")
        self.devices = [self.device]
        self.cfg_path = None

    def setup(self):
        pass

    def job(self, run):
        run.count(evals=800, steps=100)

    def close(self):
        pass

    def chain(self):
        import numpy as np

        return np.random.default_rng(0).standard_normal((64, 4, 2))


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(monkeypatch, trace):
    monkeypatch.setattr(jobs, "make", lambda *a: _StubJobs())
    monkeypatch.setattr(check, "readings", lambda tj, dev, tf32=False: {
        "lp_gap": 0.001, "stuck_share": 0.0, "move_acc_z": 0.5,
        "swap_acc_z": 0.5, "move_acc": [[0.3, 0.3]], "rows": 8})
    out, compared = cell_mod.run_cell("flagship.tempered", 2 ** 31 + 5,
                                      0.0, trace, 0.0, device="cpu")
    line = json.loads(json.dumps(out))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "compared"
    assert ("breakdown" in line) is False     # no card, no trace recorded
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        # off the card the trace's readers find nothing and stay silent
        assert names == {"tau_steps", "neff_per_s", "sampler_mfu_pct"}
    else:
        assert names == {"evals_per_s", "setup_s"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert compared["lp_gap"] == {"value": 0.001, "limit":
                                  manifest.limits({"name":
                                                   "flagship.tempered"})
                                  ["lp_gap"]}

"""Port: the multi-process survey and the collectives across processes.

Two processes joined by a gloo group (``torch.multiprocessing`` spawn, a
``file://`` rendezvous in a temporary directory), one CPU shard each,
run what one process runs over a mesh of two CPU shards, and must give
the same numbers bit for bit (``parallel/multihost.py``: seeds follow the
global shard index, never the rank):

* a toy Gaussian on ``run_multihost_multi_cluster`` against
  ``parallel.run_multi_cluster``;
* the survey CLI's worker (``survey.main --multihost``) on a 2-cluster
  synthetic survey, the kernel route on its plain versions, against
  ``fit_survey`` over a 2-shard cluster mesh (``survey.main --mesh 2``),
  and its summary JSON in the JAX package's layout;
* the coupled and hybrid samplers over a walker mesh that spans the two
  processes against one process: each process returns its own walkers,
  and ``walker_indices`` covers every walker once.

Every spawned job has a hard deadline that kills its workers.  The CLI's
``--multihost-launch`` (subprocess workers) is marked slow, as the JAX
package's ``tests/test_multihost.py`` marks its launcher test.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from joxsz_torch.parallel import make_mesh, multihost
from joxsz_torch.parallel.multihost import GlobalArray, local_block

REPO = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 240            # the spawned job, all told
C_TOY, W_TOY, D_TOY, STEPS_TOY, THIN_TOY = 4, 8, 3, 6, 2
W_COUPLED, STEPS_COUPLED, SEED = 32, 3, 5
W_HYBRID, WINDOWS, SYNC = 64, 2, 3
SURVEY_ARGS = ["--mock", "2", "--cpu", "--walkers", "32", "--burn", "20",
               "--steps", "20", "--thin", "5", "--seed", "3"]
# joxsz_tpu/survey.py:595-609
JAX_SUMMARY_KEYS = {"param_names", "multihost", "clusters"}
JAX_MULTIHOST_KEYS = {"num_processes", "global_devices", "ranges"}
JAX_CLUSTER_KEYS = {"name", "acceptance", "median", "sd", "truth"}


def _toy_ll(th):
    return -0.5 * (th * th).sum(-1)


def _toy_start():
    return torch.tensor(np.random.default_rng(0).standard_normal(
        (C_TOY, W_TOY, D_TOY)), dtype=torch.float64)


def _toy_gen():
    return torch.Generator().manual_seed(11)


def _walker_start(sess, W):
    """(W, D) walkers 2% around the synthetic data's truth (no JAX here:
    the spawned workers import this module)."""
    from joxsz_torch.synth import TRUTH

    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    rng = np.random.default_rng(21)
    return torch.tensor(th0[None] * (1 + 0.02 * rng.standard_normal(
        (W, th0.size))), dtype=torch.float32)


def _samplers(sess, mesh):
    """The coupled and hybrid samplers over ``mesh`` (a walker axis)."""
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.parallel.kernel_sharded import (
        run_coupled_sharded_ensemble, run_hybrid_coupled_ensemble)

    c = pack_consts(sess)
    coupled = run_coupled_sharded_ensemble(
        c, _walker_start(sess, W_COUPLED), STEPS_COUPLED, SEED, mesh)
    hybrid = run_hybrid_coupled_ensemble(
        c, _walker_start(sess, W_HYBRID), WINDOWS, SYNC, SEED, mesh,
        allow_small=True)
    return coupled, hybrid


def _worker(rank: int, tmp: str, cfg_path: str):
    """One process of the job: the toy, the samplers, the survey CLI."""
    import warnings

    from joxsz_torch import survey
    from joxsz_torch.build import build_session
    from joxsz_torch.config import JoXSZConfig

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    multihost.initialize(f"file://{tmp}/rdv_a", 2, rank, cpu_devices=1)
    toy = multihost.run_multihost_multi_cluster(
        [_toy_ll] * 2, _toy_start(), STEPS_TOY, _toy_gen(),
        multihost.global_mesh(("cluster",)), thin=THIN_TOY, record=True)
    sess = build_session(JoXSZConfig.from_json(open(cfg_path).read()),
                         device="cpu")
    coupled, hybrid = _samplers(sess, multihost.global_mesh(("walker",)))
    multihost.finalize()
    out = {"toy": toy}
    for tag, r in (("coupled", coupled), ("hybrid", hybrid)):
        out[tag] = {"chain": r.chain, "log_prob": r.log_prob,
                    "acceptance": r.acceptance_fraction,
                    "x": r.final_state[0].numpy(),
                    "lp": r.final_state[1].numpy(),
                    "walker_indices": r.walker_indices}
    res = survey.main(SURVEY_ARGS + [
        "--config", cfg_path, "--out", f"{tmp}/mh.json", "--multihost",
        f"file://{tmp}/rdv_b", "--nprocs", "2", "--procid", str(rank)])
    out["survey"] = res
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _spawn_job(tmp: str, cfg_path: str):
    """Run ``_worker`` in two processes; kill both at the deadline."""
    ctx = mp.start_processes(_worker, args=(tmp, cfg_path), nprocs=2,
                             join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"the 2-process job passed its "
                                   f"{DEADLINE_S} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from joxsz_torch.synth import config_json, write_synthetic_dataset

    tmp = tmp_path_factory.mktemp("torch_multihost")
    cfg = write_synthetic_dataset(str(tmp / "data"), 3, n_annuli=6, n_sz=6,
                                  max_radius_arcsec=30.0, extent_kpc=800.0)
    cfg_path = config_json(cfg, str(tmp / "cfg.json"))
    _spawn_job(str(tmp), str(cfg_path))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    return tmp, str(cfg_path), cfg, ranks


def test_toy_is_the_single_process_mesh_run(job):
    from joxsz_torch.parallel import run_multi_cluster

    _, _, _, ranks = job
    one = run_multi_cluster([_toy_ll] * 2, _toy_start(), STEPS_TOY,
                            _toy_gen(), make_mesh(2, ("cluster",),
                                                  devices=["cpu"] * 2),
                            thin=THIN_TOY)
    covered = []
    for r, out in enumerate(ranks):
        toy = out["toy"]
        c0, c1 = toy["cluster_range"]
        assert (c0, c1) == (2 * r, 2 * r + 2)
        covered += list(range(c0, c1))
        for k in ("positions", "log_prob", "acceptance_fraction"):
            np.testing.assert_array_equal(toy[k], one[k][c0:c1])
        assert toy["chain"].shape == (STEPS_TOY // THIN_TOY, 2, W_TOY,
                                      D_TOY)
        np.testing.assert_array_equal(toy["chain"][-1], toy["positions"])
        assert 0 < toy["acceptance_fraction"].mean() < 1
    assert covered == list(range(C_TOY))


def test_survey_worker_is_fit_survey_on_a_two_shard_mesh(job):
    from joxsz_torch import survey

    tmp, cfg_path, _, ranks = job
    res = survey.main(SURVEY_ARGS + ["--config", cfg_path, "--mesh", "2",
                                     "--out", str(tmp / "mesh.json")])
    mh = json.loads((tmp / "mh.json").read_text())
    assert mh["clusters"] == res.to_dict()["clusters"]
    assert mh["param_names"] == res.param_names
    for r, out in enumerate(ranks):
        s = out["survey"]
        assert s["cluster_range"] == (r, r + 1)
        np.testing.assert_array_equal(s["medians"], res.medians)
        np.testing.assert_array_equal(s["sds"], res.sds)
    assert mh["multihost"] == {"num_processes": 2, "global_devices": 2,
                               "ranges": [[0, 1], [1, 2]]}


def test_summary_json_has_the_jax_layout(job):
    tmp = job[0]
    mh = json.loads((tmp / "mh.json").read_text())
    assert set(mh) == JAX_SUMMARY_KEYS
    assert set(mh["multihost"]) == JAX_MULTIHOST_KEYS
    assert len(mh["clusters"]) == 2
    for row in mh["clusters"]:
        assert set(row) == JAX_CLUSTER_KEYS
        assert list(row["median"]) == mh["param_names"]


@pytest.mark.parametrize("tag", ["coupled", "hybrid"])
def test_samplers_across_processes_are_the_single_process_run(job, tag):
    from joxsz_torch.build import build_session
    from joxsz_torch.config import JoXSZConfig

    _, cfg_path, _, ranks = job
    sess = build_session(JoXSZConfig.from_json(open(cfg_path).read()),
                         device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = dict(zip(("coupled", "hybrid"), _samplers(
            sess, make_mesh(2, ("walker",), devices=["cpu"] * 2))))[tag]
    finally:
        torch.set_num_threads(n)
    assert one.walker_indices is None
    W = one.chain.shape[1]
    seen = []
    for out in ranks:
        got = out[tag]
        idx = got["walker_indices"]
        seen += list(idx)
        np.testing.assert_array_equal(got["chain"], one.chain[:, idx])
        np.testing.assert_array_equal(got["log_prob"], one.log_prob[:, idx])
        np.testing.assert_array_equal(got["acceptance"],
                                      one.acceptance_fraction[idx])
        x1, lp1 = (t.numpy() for t in one.final_state)
        if tag == "coupled":        # this process's walkers
            x1, lp1 = x1[idx], lp1[idx]
        np.testing.assert_array_equal(got["x"], x1)
        np.testing.assert_array_equal(got["lp"], lp1)
    assert sorted(seen) == list(range(W))
    assert one.acceptance_fraction.mean() > 0


def test_survey_worker_falls_back_to_the_plain_sampler(job, tmp_path,
                                                        monkeypatch):
    """A stack outside the cluster-grid kernel's specialisation runs the
    plain batched ensembles across the job (``run_multihost_multi_
    cluster``), with a warning, as ``fit_survey`` falls back: here a job
    of one process with two CPU shards."""
    from joxsz_torch import survey
    from joxsz_torch.ops.joint_kernel import StackMismatch

    _, cfg_path, _, _ = job

    def decline(*a, **kw):
        raise StackMismatch("declined by the test")

    monkeypatch.setattr(survey, "_multihost_kernel_fit", decline)
    out = tmp_path / "plain.json"
    with pytest.warns(UserWarning, match="plain batched ensemble"):
        res = survey.main(SURVEY_ARGS + [
            "--config", cfg_path, "--out", str(out), "--multihost",
            f"file://{tmp_path}/rdv", "--nprocs", "1", "--procid", "0",
            "--cpu-devices", "2"])
    summary = json.loads(out.read_text())
    assert summary["multihost"] == {"num_processes": 1, "global_devices": 2,
                                    "ranges": [[0, 2]]}
    assert res["cluster_range"] == (0, 2)
    assert np.all(np.isfinite(res["medians"])) and np.all(res["sds"] > 0)
    assert np.all((res["acceptance"] > 0) & (res["acceptance"] < 1))


def test_local_block_raises_on_gaps_and_partial_cover():
    t = torch.arange(8.0)
    whole = GlobalArray((8,), [(0, (0,), t[:4]), (1, (4,), t[4:])])
    c0, c1, got = local_block(whole)
    assert (c0, c1) == (0, 8) and np.array_equal(got, t.numpy())
    gap = GlobalArray((12,), [(0, (0,), t[:4]), (1, (8,), t[4:])])
    with pytest.raises(ValueError, match="gap"):
        local_block(gap)
    m = torch.zeros((4, 6))
    part = GlobalArray((4, 6), [(0, (0, 0), m[:2, :3])])
    with pytest.raises(ValueError, match="partially"):
        local_block(part)


def test_replicated_to_global_keeps_this_process_blocks():
    mesh = make_mesh(2, ("cluster",), devices=["cpu"] * 2)
    x = np.arange(12.0).reshape(4, 3)
    g = multihost.replicated_to_global(x, mesh, ("cluster",))
    assert [(s, st) for s, st, _ in g.shards] == [(0, (0, 0)), (1, (2, 0))]
    c0, c1, back = local_block(g)
    assert (c0, c1) == (0, 4) and np.array_equal(back, x)
    rep = multihost.replicated_to_global(x, mesh)
    assert all(torch.equal(b, torch.as_tensor(x)) for _, _, b in rep.shards)
    assert np.array_equal(local_block(rep)[2], x)


def test_multihost_flags_are_checked(tmp_path):
    from joxsz_torch import survey

    with pytest.raises(SystemExit, match="--nprocs and --procid"):
        survey.main(["--mock", "2", "--cpu", "--multihost",
                     "127.0.0.1:1"])
    with pytest.raises(SystemExit, match="--population"):
        survey.main(["--mock", "2", "--cpu", "--multihost", "127.0.0.1:1",
                     "--nprocs", "2", "--procid", "0", "--population",
                     "P_0"])
    with pytest.raises(SystemExit, match="--population"):
        survey.main(["--mock", "2", "--cpu", "--multihost-launch", "2",
                     "--population", "P_0"])


@pytest.mark.slow
def test_survey_cli_multihost_launch(job, tmp_path):
    """``survey --multihost-launch 2 --cpu --mock 2``: two subprocess
    workers, the coordinator's table and summary."""
    _, cfg_path, _, _ = job
    out = tmp_path / "summary.json"
    proc = subprocess.run(
        [sys.executable, "-m", "joxsz_torch.survey", "--multihost-launch",
         "2", "--cpu", "--mock", "2", "--quick", "--config", cfg_path,
         "--out", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "process 0/2: global mesh of 2 devices" in proc.stdout
    assert "process 1: clusters [1, 2) sampled" in proc.stdout
    summary = json.loads(out.read_text())
    assert summary["multihost"]["ranges"] == [[0, 1], [1, 2]]

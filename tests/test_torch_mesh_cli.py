"""The mesh entry points on the CPU: ``python -m joxsz_torch.run --mesh``
and ``python -m joxsz_torch.survey --mesh`` end to end with ``--cpu
--quick`` on the small synthetic dataset.  With ``--cpu`` a mesh of N
shards is N blocks on the CPU, sampled through the kernels' plain
versions by the same runners the card uses."""

import numpy as np
import pytest

from joxsz_torch import run, survey
from joxsz_torch.synth import config_json

from test_torch_build import single_thread, small_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")
D = 13


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mesh_cli")
    cfg = small_config(root / "data")
    # the run fits assert nothing about the MLE: they share one cold MLE
    # through an MLE cache of this module's own (the second fit hits it)
    mp = pytest.MonkeyPatch()
    mp.setattr(run, "MLE_CACHE_DIR", root / "mle_cache")
    yield dict(cfg=cfg, root=root, path=config_json(cfg, root / "cfg.json"))
    mp.undo()


@pytest.mark.parametrize("temper", ["0", "2"])
def test_run_cli_mesh_end_to_end(base, temper):
    cfg = base["cfg"]
    cfg.save_dir = str(base["root"] / f"out{temper}")
    path = config_json(cfg, base["root"] / f"cfg{temper}.json")
    res = run.main(["--config", path, "--cpu", "--quick", "--walkers", "64",
                    "--mesh", "2", "--temper", temper, "--seed", "4",
                    "--no-plots"])
    assert res.chain.shape == (400 // 5, 64, D)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(res.log_prob))
    assert 0.05 < float(np.mean(res.acceptance_fraction)) < 0.9
    assert res.timings["frame_spacing"] == 5.0


def test_survey_cli_mesh_end_to_end(base):
    out = base["root"] / "survey.json"
    res = survey.main(["--mock", "4", "--config", base["path"], "--cpu",
                       "--quick", "--mesh", "2", "--seed", "1", "--out",
                       str(out)])
    assert res.chain.shape == (30, 4, 32, D)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(res.log_prob))
    acc = res.acceptance.mean(axis=1)
    assert np.all((acc > 0.05) & (acc < 0.9))
    assert set(res.timings) == {"setup_s", "pack_s", "init_s",
                                "sampling_s", "summary_s"}
    i = res.param_names.index("log(n_0)")
    assert np.all(np.abs(res.medians - res.truths)[:, i] / res.sds[:, i] < 5)
    # clusters that do not divide over the mesh run on one device
    res3 = survey.main(["--mock", "3", "--config", base["path"], "--cpu",
                        "--quick", "--mesh", "2", "--seed", "1", "--out",
                        str(out)])
    assert res3.chain.shape == (30, 3, 32, D)

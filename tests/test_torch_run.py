"""The port's slice end to end on the CPU: ``python -m joxsz_torch.run``
with ``--cpu --quick`` on a small synthetic dataset (16 walkers, two
tempering rungs), through MLE, prelim rounds, burn-in, tempered sampling
and the output files, on the kernels' plain versions."""

import json

import numpy as np
import pytest

from joxsz_torch import run
from joxsz_torch.synth import TRUTH, config_json

from test_torch_build import small_config


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_run")
    cfg = small_config(root / "data")
    cfg.save_dir = str(root / "out")
    path = config_json(cfg, root / "cfg.json")
    res = run.main(["--config", path, "--cpu", "--quick", "--walkers", "16",
                    "--temper", "2", "--seed", "4", "--no-plots",
                    "--fresh-mle"])
    return cfg, res, root / "out"


def test_run_outputs(fit):
    cfg, res, out = fit
    n_saved = 400 // 5
    assert res.chain.shape == (n_saved, 16, 13)
    assert res.log_prob.shape == (n_saved, 16)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(res.log_prob))
    assert 0.05 < float(np.mean(res.acceptance_fraction)) < 0.9
    swaps = res.timings["swap_acceptance"]
    assert len(swaps) == 1 and 0 < swaps[0] <= 1
    assert res.param_names == list(TRUTH)
    timings = json.loads((out / "joxsz_timings.json").read_text())
    assert timings["likelihood_evals"] > 0
    state = np.load(out / "joxsz_state.npz")
    assert state["positions"].shape == (16, 13)
    assert state["temper_state"].shape == (2, 16, 13)
    np.testing.assert_array_equal(state["positions"], res.final_state[0][0])


def test_run_mle_beats_the_start(fit):
    """The MLE ends at least as high as the chain's best draw less a few
    units, and near TRUTH in the well-constrained density normalisation."""
    _, res, _ = fit
    assert np.isfinite(res.mle_loglike)
    assert res.mle_loglike > float(res.log_prob.max()) - 5.0
    i = res.param_names.index("log(n_0)")
    assert abs(res.mle_theta[i] - TRUTH["log(n_0)"]) < 0.3

"""The model-family flags of ``python -m joxsz_torch.run`` on the CPU.

Each flag of the JAX CLI that selects a model family (``--pressure
knots``, ``--temperature vikhlinin``, ``--density double``,
``--line-systematic``, ``--sz-only``, ``--integ``) drives ``run.main``
end to end with ``--cpu --quick`` at 32 walkers on the small synthetic
dataset: the config the session is built from carries the flag, the
session line names the family, SZ-only / joint SZ+X and the thawed D,
the MLE runs in float64 on the CPU, and the chain is finite and of the
family's width.  ``--line-systematic`` with ``--sz-only`` is refused as
the JAX CLI refuses it.
"""

import numpy as np
import pytest

from joxsz_torch import build, run
from joxsz_torch.synth import config_json

from test_torch_build import single_thread, small_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

W = 32
FLAGSHIP = "gnfw pressure + upp T + single density"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_families_cli")
    cfg = small_config(root / "data")
    cfg.save_dir = str(root / "out")
    return config_json(cfg, root / "cfg.json")


@pytest.mark.parametrize("flags, D, family, kind, field", [
    (["--pressure", "knots"], 16, "knots pressure + upp T + single density",
     "joint SZ+X", ("pressure_model", "knots")),
    (["--temperature", "vikhlinin"], 18,
     "gnfw pressure + vikhlinin T + single density", "joint SZ+X",
     ("temperature_model", "vikhlinin")),
    (["--density", "double"], 16, "gnfw pressure + upp T + double density",
     "joint SZ+X", ("density_mode", "double")),
    (["--line-systematic"], 14, FLAGSHIP, "joint SZ+X", None),
    (["--sz-only"], 10, FLAGSHIP, "SZ-only", None),
    (["--integ"], 13, FLAGSHIP, "joint SZ+X", None),
], ids=["pressure", "temperature", "density", "line-systematic", "sz-only",
        "integ"])
def test_run_cli_family_flag(base, monkeypatch, capsys, flags, D, family,
                             kind, field):
    built = []
    real = build.build_session

    def spy(cfg, device=None, dtype=None, sz_only=False):
        built.append((cfg, sz_only))
        return real(cfg, device=device, sz_only=sz_only)

    monkeypatch.setattr(build, "build_session", spy)
    res = run.main(["--config", base, "--cpu", "--quick", "--walkers",
                    str(W), "--seed", "3", "--no-plots", "--fresh-mle",
                    *flags])
    out = capsys.readouterr().out
    (cfg, sz_only), = built
    if field is not None:
        assert getattr(cfg, field[0]) == field[1]
    assert sz_only == ("--sz-only" in flags)
    assert cfg.sz.calc_integ == ("--integ" in flags)
    assert (cfg.xray.line_systematic
            == ("--line-systematic" in flags))
    assert f", {kind}; {family}, D={D})" in out
    assert "MLE float64 on the host CPU" in out
    assert ("line_scale" in res.param_names) == ("--line-systematic" in flags)
    assert res.timings["mle_device"] == "cpu"
    assert res.chain.shape == (400 // 5, W, D)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(res.log_prob))
    assert 0.02 < float(np.mean(res.acceptance_fraction)) < 0.9


def test_run_cli_refuses_line_systematic_without_xray(base):
    with pytest.raises(SystemExit, match="needs the X-ray likelihood"):
        run.main(["--config", base, "--cpu", "--quick", "--sz-only",
                  "--line-systematic"])

"""The survey fit on the CPU: ``python -m joxsz_torch.survey``.

At a small size (two or three clusters of the small synthetic dataset,
16-32 walkers): the mock mode end to end through the cluster-grid loop on
the kernels' plain versions and through the plain batched ensembles, the
documented fallback for a stack outside the kernel's specialisation, a
``--spec`` whose clusters have different stack signatures (split into
groups, merged in spec order), and the batched initialiser and sampler on
a known Gaussian.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from joxsz_torch import survey
from joxsz_torch.build import build_session
from joxsz_torch.models.multicluster import stack_sz_data
from joxsz_torch.ops.multicluster_kernel import stretch_steps_multicluster
from joxsz_torch.sampling.batched import batched_init, run_batched_ensembles
from joxsz_torch.simulate import simulate_survey
from joxsz_torch.synth import config_json, write_synthetic_dataset

from test_torch_build import small_config


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_survey")
    cfg = small_config(root / "data")
    return cfg, config_json(cfg, root / "cfg.json"), root


@pytest.fixture(scope="module")
def mock_fit(base):
    _, path, root = base
    out = root / "summary.json"
    res = survey.main(["--mock", "2", "--config", path, "--cpu", "--quick",
                       "--seed", "1", "--out", str(out)])
    return res, out


def test_mock_survey_end_to_end(mock_fit):
    res, out = mock_fit
    assert res.chain.shape == (150 // 5, 2, 32, 13)
    assert res.log_prob.shape == (30, 2, 32)
    assert np.all(np.isfinite(res.chain)) and np.all(np.isfinite(res.log_prob))
    acc = res.acceptance.mean(axis=1)
    assert np.all((acc > 0.05) & (acc < 0.9))
    assert set(res.timings) == {"setup_s", "pack_s", "init_s",
                                "sampling_s", "summary_s"}
    assert res.cluster_names == ["mock0", "mock1"]
    # the truths spread P_0 and beta across the clusters
    i, j = res.param_names.index("P_0"), res.param_names.index(r"\beta")
    assert res.truths[1, i] / res.truths[0, i] == pytest.approx(1.3 / 0.7)
    assert res.truths[1, j] - res.truths[0, j] == pytest.approx(0.06)
    # well-constrained parameters come back near their truths
    pull = np.abs(res.medians - res.truths) / res.sds
    assert np.all(pull[:, [res.param_names.index("log(n_0)"), i]] < 5.0)
    assert res.flat_chain(1).shape == (30 * 32, 13)
    summary = json.loads(out.read_text())
    assert summary["param_names"] == res.param_names
    assert [c["name"] for c in summary["clusters"]] == ["mock0", "mock1"]
    for c in summary["clusters"]:
        assert np.isfinite(list(c["median"].values())).all()
        assert set(c) == {"name", "acceptance", "median", "sd", "truth"}


def test_survey_plain_route(base):
    """``step_kernel=False``: the plain batched ensembles on the stacked
    float64 likelihood; no kernel timings."""
    cfg, _, _ = base
    sess, sv, truths = _survey_inputs(cfg, 2, 2)
    res = survey.fit_survey(sess, sv.sz_stack, sv.xray_stack, truths,
                            n_walkers=16, n_burn=20, n_steps=20, thin=5,
                            seed=2, truths=truths, step_kernel=False)
    assert res.chain.shape == (4, 2, 16, 13) and res.timings is None
    assert res.chain.dtype == np.float64
    assert np.all(np.isfinite(res.log_prob))
    assert res.cluster_names == ["cluster0", "cluster1"]
    np.testing.assert_array_equal(res.truths, truths)


def test_survey_needs_a_card_unless_cpu(base, monkeypatch):
    _, path, root = base
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        survey.main(["--mock", "2", "--config", path, "--quick",
                     "--out", str(root / "never.json")])
    assert not (root / "never.json").exists()
    with pytest.raises(SystemExit, match="base configuration"):
        survey.main(["--mock", "2", "--cpu", "--quick"])


def _survey_inputs(cfg, n: int, seed: int):
    sess = build_session(cfg, device="cpu")
    truths = np.tile(sess.params.thawed_values(), (n, 1))
    sv = simulate_survey(sess.model, truths, np.random.default_rng(seed))
    return sess, sv, truths


def test_stack_mismatch_falls_back_with_the_warning(base):
    """A cluster with another conversion table is outside the kernel's
    specialisation: ``fit_survey`` warns and samples through the plain
    batched likelihood (which does honour the per-cluster table)."""
    import dataclasses

    cfg, _, _ = base
    sess, sv, truths = _survey_inputs(cfg, 2, 3)
    sz = [m.model.sz_data for m in sv.mocks]
    sz[1] = dataclasses.replace(sz[1], conv_val=sz[1].conv_val * 1.05)
    before = stretch_steps_multicluster.launches
    with pytest.warns(UserWarning, match="step-kernel specialisation"):
        res = survey.fit_survey(
            sess, stack_sz_data(sz), sv.xray_stack, truths, n_walkers=16,
            n_burn=10, n_steps=10, thin=5, seed=4)
    assert res.timings is None and res.chain.shape == (2, 2, 16, 13)
    assert np.all(np.isfinite(res.log_prob))
    assert stretch_steps_multicluster.launches == before
    # a homogeneous stack takes the kernel route and warns nothing
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = survey.fit_survey(sess, sv.sz_stack, sv.xray_stack, truths,
                                n_walkers=16, n_burn=4, n_steps=10, thin=5,
                                seed=4)
    assert res.timings is not None and res.chain.dtype == np.float32
    with pytest.raises(ValueError, match="centers have"):
        survey.fit_survey(sess, sv.sz_stack, sv.xray_stack, truths[:, :5])


# -- (h) --spec: grouping by stack signature, merging in spec order ------------

@pytest.fixture(scope="module")
def hetero_spec(tmp_path_factory):
    """Three clusters: 0 and 2 share the small dataset's shapes (other
    seeds, so other data), 1 has five annuli instead of six."""
    root = tmp_path_factory.mktemp("torch_spec")
    entries = []
    for i, (seed, n_ann) in enumerate([(3, 6), (4, 5), (5, 6)]):
        cfg = write_synthetic_dataset(
            str(root / f"cl{i}"), seed, n_annuli=n_ann, n_sz=6,
            max_radius_arcsec=30.0, extent_kpc=800.0)
        cfg.name = f"cl{i}"
        entries.append({"name": f"cl{i}",
                        "config": config_json(cfg, root / f"cl{i}.json")})
    spec = root / "survey.json"
    spec.write_text(json.dumps({"clusters": entries}))
    return spec, root


def test_spec_survey_groups_by_signature(hetero_spec):
    spec, _ = hetero_spec

    class Args:
        mle = False

    groups = survey._build_spec_survey(str(spec), Args(), "cpu")
    assert sorted(tuple(g[6]) for g in groups) == [(0, 2), (1,)]
    for sess, sz_stack, xr_stack, centers, names, truths, idxs in groups:
        n = len(idxs)
        assert sz_stack.flux.shape[0] == n == centers.shape[0]
        assert xr_stack.counts_mask.shape[2] == (6 if n == 2 else 5)
        assert names == [f"cl{i}" for i in idxs] and truths is None
    a, b = (g[0] for g in groups)
    assert survey._stack_signature(a) != survey._stack_signature(b)
    assert survey._model_fingerprint(a) == survey._model_fingerprint(a)


def test_model_fingerprint_sees_priors_and_frozen_values(base):
    cfg, _, _ = base
    s1 = build_session(cfg, device="cpu")
    s2 = build_session(cfg, device="cpu")
    assert survey._stack_signature(s1) == survey._stack_signature(s2)
    s2.params["Z"].maxval = 0.8
    s2.params._refresh()
    assert survey._model_fingerprint(s1) != survey._model_fingerprint(s2)
    s3 = build_session(cfg, device="cpu")
    s3.params["c"].val = 0.1
    assert survey._model_fingerprint(s1) != survey._model_fingerprint(s3)


def test_spec_survey_cli_merges_in_spec_order(hetero_spec):
    spec, root = hetero_spec
    out = root / "hetero_summary.json"
    res = survey.main(["--spec", str(spec), "--cpu", "--walkers", "16",
                       "--burn", "10", "--steps", "10", "--thin", "5",
                       "--seed", "4", "--out", str(out)])
    assert res.cluster_names == ["cl0", "cl1", "cl2"]
    assert res.chain.shape == (2, 3, 16, 13)
    assert len(res.timings["groups"]) == 2
    summary = json.loads(out.read_text())
    assert [c["name"] for c in summary["clusters"]] == ["cl0", "cl1", "cl2"]
    for c in summary["clusters"]:
        assert np.isfinite(list(c["median"].values())).all()
        assert 0.0 <= c["acceptance"] <= 1.0 and "truth" not in c


def test_merge_survey_results_keeps_spec_order():
    def result(names, fill):
        n = len(names)
        return survey.SurveyResult(
            cluster_names=names, param_names=["a", "b"],
            chain=np.full((3, n, 4, 2), fill), log_prob=np.full((3, n, 4),
                                                                fill),
            acceptance=np.full((n, 4), 0.25), medians=np.full((n, 2), fill),
            sds=np.ones((n, 2)), truths=None, timings={"setup_s": fill})

    merged = survey._merge_survey_results(
        [result(["x", "z"], 1.0), result(["y"], 2.0)], [[0, 2], [1]], 3)
    assert merged.cluster_names == ["x", "y", "z"]
    assert merged.medians[:, 0].tolist() == [1.0, 2.0, 1.0]
    assert merged.chain[0, :, 0, 0].tolist() == [1.0, 2.0, 1.0]
    assert merged.timings == {"groups": [{"setup_s": 1.0},
                                         {"setup_s": 2.0}]}
    short = result(["y"], 2.0)
    short.chain = short.chain[:2]
    with pytest.raises(ValueError, match="different schedules"):
        survey._merge_survey_results([result(["x"], 1.0), short],
                                     [[0], [1]], 2)


# -- the batched initialiser and sampler ------------------------------------------

def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def test_batched_init_shrinks_toward_a_boundary():
    """Cluster 1's centre sits 1e-3 inside a wall: a fixed 5% cloud puts
    half its walkers outside, halving the spread fills the ensemble."""
    def ll(x):
        ok = (x[..., 0] < 1.0) & (x[..., 1].abs() < 5)
        return torch.where(ok, -(x ** 2).sum(dim=-1),
                           torch.full_like(x[..., 0], -float("inf")))

    centers = np.array([[0.0, 0.0], [0.999, 0.0]])
    p0 = batched_init(ll, centers, 64, _gen(0), device="cpu",
                      dtype=torch.float64)
    assert p0.shape == (2, 64, 2) and bool(torch.isfinite(ll(p0)).all())
    assert float(p0[0, :, 0].std()) > 1e-4     # the zero coordinate spreads
    with pytest.raises(RuntimeError, match=r"cluster\(s\) \[1\]"):
        batched_init(lambda x: torch.where(
            x[..., 0] < 0.5, 0.0, -float("inf")) * torch.ones_like(x[..., 0]),
            centers, 8, _gen(0), device="cpu", dtype=torch.float64,
            max_tries=3)


def test_run_batched_ensembles_samples_two_gaussians():
    mu = torch.tensor([[0.0, 1.0], [5.0, -3.0]], dtype=torch.float64)
    sd = torch.tensor([[1.0, 0.5], [2.0, 1.0]], dtype=torch.float64)

    def ll(x):                                  # (C, W, D) -> (C, W)
        return -0.5 * (((x - mu[:, None]) / sd[:, None]) ** 2).sum(dim=-1)

    p0 = batched_init(ll, mu.numpy(), 48, _gen(1), device="cpu",
                      dtype=torch.float64, spread=0.3)
    chain, lp_chain, acc, x = run_batched_ensembles(ll, p0, 200, 800,
                                                    _gen(2), thin=4)
    assert chain.shape == (200, 2, 48, 2) and lp_chain.shape == (200, 2, 48)
    assert acc.shape == (2, 48) and x.shape == (2, 48, 2)
    flat = chain.transpose(1, 0, 2, 3).reshape(2, -1, 2)
    np.testing.assert_allclose(flat.mean(axis=1), mu.numpy(), atol=0.2)
    np.testing.assert_allclose(flat.std(axis=1), sd.numpy(), rtol=0.12)
    assert np.all((acc.mean(axis=1) > 0.4) & (acc.mean(axis=1) < 0.9))
    np.testing.assert_array_equal(chain[-1], x.numpy())
    with pytest.raises(ValueError, match="multiple of"):
        run_batched_ensembles(ll, p0, 0, 10, _gen(2), thin=4)

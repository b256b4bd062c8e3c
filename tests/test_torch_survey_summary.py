"""Port: the survey's posterior summary (``survey.posterior_summary``).

On CPU tensors: the medians are ``np.median``'s of the same values bit
for bit (odd and even sample counts, ties, a constant column, a NaN
column, one cluster or several, float32 and float64 chains), the
standard deviations ``np.std``'s of the float64 values within 1e-6, and
both keep the chain's dtype.  ``fit_survey`` on every route (the kernel
route, whose summary is taken before the chain is fetched; the plain
batched ensembles; the fallback from a stack outside the kernel's
specialisation) returns the summary of the chain it returns.  On a card
(``gpu``): the same at the survey's size, (80, 25600, 13).

The module imports no JAX: ``python -m pytest --noconftest
tests/test_torch_survey_summary.py -m gpu`` runs the card's test where
JAX is missing.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from joxsz_torch import survey
from joxsz_torch.build import build_session
from joxsz_torch.models.multicluster import stack_sz_data
from joxsz_torch.simulate import simulate_survey
from joxsz_torch.synth import write_synthetic_dataset


def _chain(case: str) -> np.ndarray:
    """A cluster-major chain (C, N, D) for ``case``."""
    rng = np.random.default_rng(5)
    C, N, D, dtype = {"odd": (3, 1001, 4, np.float32),
                      "even": (3, 1000, 4, np.float32),
                      "ties": (2, 998, 3, np.float32),
                      "constant": (3, 640, 4, np.float32),
                      "nan": (3, 640, 4, np.float32),
                      "one_cluster": (1, 777, 5, np.float32),
                      "float64": (2, 1000, 4, np.float64)}[case]
    x = (rng.standard_normal((C, N, D)) * 37.0 + 3.1).astype(dtype)
    if case == "ties":
        x = np.round(x / 40.0).astype(dtype)
    if case == "constant":
        x[1, :, 2] = np.float32(0.1)
        x[2, :, 0] = np.float32(-7.3e4)
    if case == "nan":
        x[0, 17, 1] = np.nan
        x[2, -1, 3] = np.nan
    return x


def _check(x: np.ndarray, med: np.ndarray, sds: np.ndarray):
    want = np.median(x, axis=1)
    assert med.dtype == want.dtype == x.dtype
    assert sds.dtype == np.std(x, axis=1).dtype == x.dtype
    np.testing.assert_array_equal(med, want)
    np.testing.assert_allclose(sds, np.std(x.astype(np.float64), axis=1),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["odd", "even", "ties", "constant", "nan",
                                  "one_cluster", "float64"])
def test_summary_is_numpys(case):
    x = _chain(case)
    med, sds = survey.posterior_summary(torch.from_numpy(x))
    _check(x, med.numpy(), sds.numpy())
    if case == "constant":
        assert sds[1, 2] == 0 and sds[2, 0] == 0
    if case == "nan":
        med = med.numpy()
        assert np.isnan(med[0, 1]) and np.isnan(med[2, 3])
        assert np.isfinite(med).sum() == med.size - 2


def test_summary_of_a_strided_chain():
    """A host chain (n_saved, C, W, D) read through a permuted view gives
    the contiguous chain's summary, bit for bit."""
    x = _chain("even").reshape(3, 40, 25, 4)
    host = np.ascontiguousarray(np.transpose(x, (1, 0, 2, 3)))
    med, sds = survey._host_summary(host)
    ref = survey.posterior_summary(torch.from_numpy(x.reshape(3, -1, 4)))
    np.testing.assert_array_equal(med, ref[0].numpy())
    np.testing.assert_array_equal(sds, ref[1].numpy())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    cfg = write_synthetic_dataset(
        str(tmp_path_factory.mktemp("summary") / "data"), 3, n_annuli=6,
        n_sz=6, max_radius_arcsec=30.0, extent_kpc=800.0)
    sess = build_session(cfg, device="cpu")
    truths = np.tile(sess.params.thawed_values(), (2, 1))
    sv = simulate_survey(sess.model, truths, np.random.default_rng(3))
    return sess, sv, truths


@pytest.mark.parametrize("route", ["kernel", "plain", "fallback"])
def test_fit_survey_summarises_its_own_chain(inputs, route):
    sess, sv, truths = inputs
    sz = sv.sz_stack
    if route == "fallback":
        parts = [m.model.sz_data for m in sv.mocks]
        parts[1] = dataclasses.replace(parts[1],
                                       conv_val=parts[1].conv_val * 1.05)
        sz = stack_sz_data(parts)
    with (pytest.warns(UserWarning, match="specialisation")
          if route == "fallback" else contextlib.nullcontext()):
        res = survey.fit_survey(sess, sz, sv.xray_stack, truths,
                                n_walkers=16, n_burn=4, n_steps=15, thin=5,
                                seed=4, step_kernel=route != "plain")
    assert (res.timings is not None) == (route == "kernel")
    n_saved, C, W, D = res.chain.shape
    flat = np.transpose(res.chain, (1, 0, 2, 3)).reshape(C, -1, D)
    med, sds = survey.posterior_summary(torch.from_numpy(flat))
    np.testing.assert_array_equal(res.medians, med.numpy())
    np.testing.assert_array_equal(res.sds, sds.numpy())
    assert res.medians.dtype == res.sds.dtype == res.chain.dtype
    _check(flat, res.medians, res.sds)


@pytest.mark.gpu
def test_summary_on_card_is_numpys():
    """The survey's chain on the card, (80, 100 x 256, 13), odd and even
    sample counts: the card's summary is numpy's of the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((80, 25600, 13)) * 2.0 + 1.5).astype(np.float32)
    x[3, 100, 4] = np.nan
    for n in (25600, 25599):
        part = np.ascontiguousarray(x[:, :n])
        med, sds = survey.posterior_summary(torch.from_numpy(part).cuda())
        assert med.is_cuda and sds.is_cuda
        _check(part, med.cpu().numpy(), sds.cpu().numpy())

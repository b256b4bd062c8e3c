"""Synthetic observations from known parameters.

Torch counterpart of ``joxsz_tpu/simulate.py``: draw a simulated dataset
from any parameter vector through the forward models the likelihood
itself uses, with each probe's own noise model —

* SZ: Gaussian noise with the dataset's per-point flux errors on the
  beam/transfer-convolved model profile (``models/sz.py``);
* X-ray: Poisson counts around the predicted per-band annular profile,
  source plus background (``models/xray.py``).

Used by the mock mode of ``joxsz_torch.survey`` and by recovery tests.
Noise comes from a numpy ``Generator`` on the host: simulation is set-up
work, not a hot path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MockObservation:
    """A simulated dataset bound to a fit-ready model."""

    model: object                       # JointModel with mock data bound
    theta_true: np.ndarray              # generating parameter vector
    sz_flux: np.ndarray                 # noisy mock flux (data radii)
    sz_flux_true: np.ndarray            # noiseless model flux
    xray_counts: np.ndarray | None      # noisy mock counts (band, annulus)
    xray_pred_true: np.ndarray | None   # noiseless predicted counts


def simulate_observation(model, theta, rng: np.random.Generator, *,
                         sz_noise: bool = True,
                         xray_noise: bool = True) -> MockObservation:
    """Draw one mock observation of ``model`` at parameter vector
    ``theta`` and return a copy of the model with the mock data bound
    (same shapes, masks and exposures as the originals).  Any model
    family simulates through its own forward model; an SZ-only model
    (``xray_data`` None) draws the SZ flux alone and its X-ray fields
    stay None (``joxsz_tpu/simulate.py:87-118``).

    ``sz_noise=False`` / ``xray_noise=False`` bind the noiseless model
    prediction instead.  The vector is not checked against the priors:
    simulating from outside the fitted support is a legitimate
    mis-specification test."""
    theta = np.asarray(theta, dtype=float)
    sz, xr = model.sz_data, model.xray_data
    th = torch.as_tensor(theta, dtype=sz.L.dtype, device=sz.L.device)[None]
    with torch.no_grad():
        prof = model.sz_profile(th)
        sz_true = (prof @ sz.G.T)[0].cpu().numpy()
        xr_true = (None if xr is None
                   else model.xray_profiles(th)[0].cpu().numpy())

    err = sz.flux_err.cpu().numpy()
    sz_flux = sz_true + (rng.normal(0.0, err) if sz_noise else 0.0)
    new_sz = dataclasses.replace(
        sz, flux=torch.as_tensor(sz_flux, dtype=sz.flux.dtype,
                                 device=sz.flux.device))
    if xr is None:
        return MockObservation(
            model=dataclasses.replace(model, sz_data=new_sz),
            theta_true=theta, sz_flux=sz_flux, sz_flux_true=sz_true,
            xray_counts=None, xray_pred_true=None)

    mask = xr.counts_mask.cpu().numpy() > 0
    # support guard over the valid cells: the prediction must be strictly
    # positive there or the generating theta is itself vetoed by the
    # X-ray likelihood (zero and NaN both fail `> 0`)
    if not np.all(xr_true[mask] > 0):
        raise ValueError(
            "non-positive (or NaN) predicted X-ray counts in valid cells "
            "at theta — the vector is outside the likelihood's support; "
            "pick parameters with a strictly positive predicted profile")
    lam = np.where(mask, xr_true, 0.0)
    xr_counts = rng.poisson(lam).astype(float) if xray_noise else lam
    # the original mask is kept: excluded annuli stay excluded
    new_xr = dataclasses.replace(
        xr, counts_filled=torch.as_tensor(
            xr_counts, dtype=xr.counts_filled.dtype,
            device=xr.counts_filled.device))

    return MockObservation(
        model=dataclasses.replace(model, sz_data=new_sz, xray_data=new_xr),
        theta_true=theta, sz_flux=sz_flux, sz_flux_true=sz_true,
        xray_counts=xr_counts, xray_pred_true=xr_true)


@dataclasses.dataclass
class MockSurvey:
    """C independent mock clusters stacked for the multicluster paths."""

    sz_stack: object                    # stacked SZData (leading C axis)
    xray_stack: object | None           # stacked XrayData; None: SZ-only
    mocks: list                         # per-cluster MockObservation
    thetas_true: np.ndarray             # (C, ndim) generating vectors


def simulate_survey(model, thetas, rng: np.random.Generator, *,
                    sz_noise: bool = True,
                    xray_noise: bool = True) -> MockSurvey:
    """One mock observation per row of ``thetas`` (C, ndim), all through
    ``model``'s instrument configuration, stacked for
    ``make_multicluster_log_like`` and ``pack_consts_stack``."""
    from .models.multicluster import stack_sz_data, stack_xray_data

    thetas = np.atleast_2d(np.asarray(thetas, dtype=float))
    mocks = [simulate_observation(model, t, rng, sz_noise=sz_noise,
                                  xray_noise=xray_noise) for t in thetas]
    return MockSurvey(
        sz_stack=stack_sz_data([m.model.sz_data for m in mocks]),
        xray_stack=(None if model.xray_data is None else stack_xray_data(
            [m.model.xray_data for m in mocks])),
        mocks=mocks, thetas_true=thetas)

"""The frozen tau estimator on AR(1) chains of known integrated
autocorrelation time (1 + phi) / (1 - phi)."""

import numpy as np
import pytest
import torch

from benchmark.harness.autocorr import integrated_time


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_ar1_tau(phi):
    rng = np.random.default_rng(3)
    n, W = 20000, 32
    e = rng.standard_normal((n, W, 2))
    x = np.empty_like(e)
    x[0] = e[0] / np.sqrt(1 - phi ** 2)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    tau = integrated_time(torch.as_tensor(x)).numpy()
    assert tau == pytest.approx(np.full(2, (1 + phi) / (1 - phi)), rel=0.06)


def test_float32_chain_and_walker_blocks_agree():
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.standard_normal((4000, 200, 1)), axis=0) * 0.05 \
        + rng.standard_normal((4000, 200, 1))
    a = integrated_time(torch.as_tensor(x))
    b = integrated_time(torch.as_tensor(x, dtype=torch.float32))
    assert float(a[0]) == pytest.approx(float(b[0]), rel=1e-4)


class _Chain:
    """A cold rung whose walkers share a slow AR(1) drift under fast
    noise of their own, as slots that a swap sweep refills: each slot's
    series decorrelates in a frame, the ensemble's mean does not."""

    device = torch.device("cpu")
    thin = 25

    def __init__(self, phi, n=20000, W=256, noise=10.0):
        rng = np.random.default_rng(5)
        m = np.empty((n, 1, 2))
        m[0] = rng.standard_normal((1, 2)) / np.sqrt(1 - phi ** 2)
        for t in range(1, n):
            m[t] = phi * m[t - 1] + rng.standard_normal((1, 2))
        self._x = m + noise * rng.standard_normal((n, W, 2))

    def chain(self):
        return self._x


def test_run_tau_reads_the_ensemble_mean():
    from benchmark.harness.cell import Run

    phi = 0.9
    run = Run({"chips": 1}, None, None, 1, 1.0, False)
    run.jobs = _Chain(phi)
    slots = float(integrated_time(torch.as_tensor(run.jobs.chain())).max())
    assert slots < 3.0
    assert run.tau_steps() == pytest.approx(
        25 * (1 + phi) / (1 - phi), rel=0.15)

"""Integrated autocorrelation time of an ensemble chain: emcee's
``integrated_time`` algorithm (Foreman-Mackey et al. 2013; emcee 3
``autocorr.py``), frozen here and written in torch so that it runs on the
card after the window: for each parameter, the FFT autocorrelation of
every walker's chain, normalised per walker and averaged over the
walkers, summed into tau(M) = 2 sum_{t<=M} rho(t) - 1 and cut at Sokal's
window, the first M >= c tau(M)."""

from __future__ import annotations

import torch


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def walker_mean_acf(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """(n,) autocorrelation of the chains x (n, W), each normalised to 1
    at lag 0 and averaged over the W walkers (float64); walkers are taken
    ``block`` at a time."""
    n, W = x.shape
    m = 2 * _next_pow_two(n)
    acc = torch.zeros(n, dtype=torch.float64, device=x.device)
    for w0 in range(0, W, block):
        y = x[:, w0:w0 + block].to(torch.float64)
        y = y - y.mean(dim=0)
        f = torch.fft.rfft(y, n=m, dim=0)
        acf = torch.fft.irfft(f * f.conj(), n=m, dim=0)[:n]
        acc += (acf / acf[0]).sum(dim=1)
    return acc / W


def auto_window(taus: torch.Tensor, c: float) -> int:
    m = torch.arange(taus.numel(), device=taus.device) < c * taus
    if bool(m.any()):
        return int(torch.argmin(m.to(torch.int8)))
    return taus.numel() - 1


def integrated_time(chain: torch.Tensor, c: float = 5.0) -> torch.Tensor:
    """(D,) integrated autocorrelation times, in frames, of the chain
    (n_frames, W, D)."""
    n, W, D = chain.shape
    out = torch.empty(D, dtype=torch.float64)
    for d in range(D):
        f = walker_mean_acf(chain[:, :, d])
        taus = 2.0 * torch.cumsum(f, dim=0) - 1.0
        out[d] = taus[auto_window(taus, c)].cpu()
    return out

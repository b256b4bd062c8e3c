"""The reference's log-posterior at the rows the program stored: the
frozen float64 model built from the dataset's own files, each row against
its own cluster's data where the rows carry it.  ``tf32=True`` is the
control: the same model in float32 with every product's inputs rounded
to TF32 (``model.precision``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import precision
from .model.build import build_model


def log_posterior(cfg_path, theta, *, flux=None, counts=None,
                  device="cpu", tf32: bool = False,
                  block: int = 2048) -> np.ndarray:
    """(B,) float64 log-posterior of the rows ``theta`` (B, D); ``flux``
    (B, n_sz) and ``counts`` (B, n_band, n_ann) replace the dataset's
    data row by row.  Computed ``block`` rows at a time."""
    dtype = torch.float32 if tf32 else torch.float64
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    precision.TF32 = tf32
    try:
        model = build_model(cfg_path, device=device, dtype=dtype)
        out = np.empty(len(theta))
        for b0 in range(0, len(theta), block):
            sl = slice(b0, b0 + block)
            sz, xr = model.sz_data, model.xray_data
            if flux is not None:
                sz = dataclasses.replace(sz, flux=torch.as_tensor(
                    flux[sl], dtype=dtype, device=device))
                xr = dataclasses.replace(xr, counts_filled=torch.as_tensor(
                    counts[sl], dtype=dtype, device=device))
            th = torch.as_tensor(np.asarray(theta[sl], np.float64),
                                 dtype=dtype, device=device)
            with torch.no_grad():
                lp = model.log_like_batch(th, sz_data=sz, xray_data=xr)
            out[sl] = lp.double().cpu().numpy()
        return out
    finally:
        precision.TF32 = False
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32

"""Sampler state checkpoint: final walker state + config metadata.

The reference persists chains through emcee's ``HDFBackend``
(reference joxsz_main.py:196-211); this slice of the port writes only
the resume point — final walker positions, their log-probs, the seed
the run drew its per-chunk generator seeds from, and (for tempered runs)
the whole replica ladder — as one ``.npz``.  HDF5 chains and resume
arrive in a later slice (ROADMAP.md).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np


def save_state(path: str, positions: np.ndarray, log_probs: np.ndarray,
               key_data: np.ndarray, meta: dict,
               temper_state: np.ndarray | None = None):
    """``temper_state``: the full (K, W, D) replica-ladder state of a
    tempered run."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    extra = {} if temper_state is None else {"temper_state": temper_state}
    np.savez_compressed(
        path, positions=positions, log_probs=log_probs, key=key_data,
        meta=np.bytes_(json.dumps(meta).encode()), **extra,
    )

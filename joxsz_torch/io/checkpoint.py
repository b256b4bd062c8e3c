"""Chain checkpointing: emcee-compatible HDF5 chains and the resume state.

Counterpart of ``joxsz_tpu/io/checkpoint.py``.  The reference persists
chains through emcee's ``HDFBackend`` and decorates the file with
``param_names``/``burn``/``thin`` attrs (reference joxsz_main.py:196-211,
joxsz_funcs.py:637-650).  Here:

  * ``save_chain_hdf5`` writes the JAX package's layout exactly — emcee
    v3's group 'mcmc' with the datasets chain/log_prob/accepted and the
    iteration attr, plus the reference's attrs and ``frame_spacing`` —
    so each package reads the other's file;
  * where h5py is not installed, ``save_chain`` writes the same datasets
    and attrs under the same names into an ``.npz`` twin instead, and
    ``load_chain`` reads either file by its suffix;
  * ``save_state`` / ``load_state`` keep the resume point as one
    ``.npz``: final walker positions and log-probs, an unconsumed seed
    for the resumed run's generator, metadata and (for tempered runs)
    the whole replica ladder;
  * ``save_best_fit`` writes the reference's ``fit.dat``.

h5py is imported inside the functions that need it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib

import numpy as np


def has_h5py() -> bool:
    """Whether the HDF5 chain writer can run here."""
    return importlib.util.find_spec("h5py") is not None


def _chain_records(chain, log_prob, acceptance, param_names, nburn, nthin,
                   frame_spacing):
    """The chain file's (datasets, attrs), as emcee v3 and the reference
    name them."""
    datasets = {"chain": chain, "log_prob": log_prob,
                "accepted": acceptance * chain.shape[0]}
    attrs = {
        "version": 3, "nwalkers": chain.shape[1], "ndim": chain.shape[2],
        "has_blobs": False, "iteration": chain.shape[0],
        # reference-compatible metadata (joxsz_funcs.py:637-650)
        "param_names": np.array([n.encode("utf-8") for n in param_names]),
        "burn": nburn, "thin": nthin,
        "frame_spacing": float(nthin if frame_spacing is None
                               else frame_spacing),
    }
    return datasets, attrs


def save_chain_hdf5(path: str, chain: np.ndarray, log_prob: np.ndarray,
                    acceptance: np.ndarray, param_names: list[str],
                    nburn: int, nthin: int,
                    frame_spacing: float | None = None):
    """emcee v3 layout: chain (n_saved, n_walkers, ndim), log_prob
    (n_saved, n_walkers), accepted (n_walkers,).  ``frame_spacing``: raw
    sampler steps per saved frame — ``nthin`` for every regular sampler,
    ``nthin * sync_every / (sync_every - 1)`` for the hybrid coupled
    sampler, whose frames come only from its local windows."""
    import h5py

    datasets, attrs = _chain_records(chain, log_prob, acceptance,
                                     param_names, nburn, nthin,
                                     frame_spacing)
    with h5py.File(path, "w") as f:
        g = f.create_group("mcmc")
        for k in ("version", "nwalkers", "ndim", "has_blobs", "iteration"):
            g.attrs[k] = attrs[k]
        g.create_dataset("chain", data=datasets["chain"],
                         compression="gzip", compression_opts=4)
        g.create_dataset("log_prob", data=datasets["log_prob"],
                         compression="gzip", compression_opts=4)
        g.create_dataset("accepted", data=datasets["accepted"])
        for k in ("param_names", "burn", "thin", "frame_spacing"):
            g.attrs[k] = attrs[k]


def _unpack(chain, log_prob, attrs) -> dict:
    return {
        "chain": np.asarray(chain),
        "log_prob": np.asarray(log_prob),
        "param_names": [bytes(n).decode() for n in attrs["param_names"]],
        "burn": int(attrs["burn"]),
        "thin": int(attrs["thin"]),
        # files without the attr have frames exactly 'thin' steps apart
        "frame_spacing": float(attrs.get("frame_spacing", attrs["thin"])),
    }


def load_chain_hdf5(path: str) -> dict:
    import h5py

    with h5py.File(path, "r") as f:
        g = f["mcmc"]
        return _unpack(g["chain"], g["log_prob"], dict(g.attrs))


def save_chain(path: str, chain: np.ndarray, log_prob: np.ndarray,
               acceptance: np.ndarray, param_names: list[str], nburn: int,
               nthin: int, frame_spacing: float | None = None):
    """The chain file by its suffix: ``.hdf5``/``.h5`` through h5py, else
    an ``.npz`` with the same datasets and attrs under the same names."""
    if pathlib.Path(path).suffix in (".hdf5", ".h5"):
        return save_chain_hdf5(path, chain, log_prob, acceptance,
                               param_names, nburn, nthin, frame_spacing)
    datasets, attrs = _chain_records(chain, log_prob, acceptance,
                                     param_names, nburn, nthin,
                                     frame_spacing)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    # uncompressed: float32 chains barely compress, and the whole chain is
    # rewritten at every flush; np.savez appends .npz to a name without
    # it, so write through a handle
    with open(path, "wb") as f:
        np.savez(f, **datasets, **attrs)


def load_chain(path: str) -> dict:
    """Read a chain file written by either package (HDF5) or by
    ``save_chain`` (``.npz``), by its suffix."""
    if pathlib.Path(path).suffix in (".hdf5", ".h5"):
        return load_chain_hdf5(path)
    with np.load(path) as d:
        return _unpack(d["chain"], d["log_prob"], {k: d[k] for k in d.files})


def save_state(path: str, positions: np.ndarray, log_probs: np.ndarray,
               key_data: np.ndarray, meta: dict,
               temper_state: np.ndarray | None = None):
    """``key_data``: an unconsumed seed for the resumed run's generator;
    ``temper_state``: the full (K, W, D) replica ladder of a tempered
    run, so a resume continues the equilibrated ladder."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    extra = {} if temper_state is None else {"temper_state": temper_state}
    np.savez_compressed(
        path, positions=positions, log_probs=log_probs, key=key_data,
        meta=np.bytes_(json.dumps(meta).encode()), **extra,
    )


def load_state(path: str) -> dict:
    d = np.load(path)
    out = {
        "positions": d["positions"],
        "log_probs": d["log_probs"],
        "key": d["key"],
        "meta": json.loads(bytes(d["meta"]).decode()),
    }
    if "temper_state" in d.files:
        out["temper_state"] = d["temper_state"]
    return out


def save_best_fit(path: str, chain: np.ndarray, log_prob: np.ndarray,
                  mle_theta: np.ndarray, mle_ll: float,
                  param_names: list[str]):
    """``fit.dat``: the better of the chain's best sample and the MLE,
    ``likelihood = <ll>`` then ``<name> = <value>`` lines with the names
    sorted, every number ``%g`` — the reference's best-fit side file
    (``AtomicWriteFile``, joxsz_funcs.py:540-545), one atomic write per
    run as ``joxsz_tpu/sampling/driver.py:637-654`` writes it."""
    flat_lp = np.asarray(log_prob).reshape(-1)
    flat_x = np.asarray(chain).reshape(-1, chain.shape[-1])
    i_best = int(np.argmax(flat_lp))
    best_ll = float(flat_lp[i_best])
    lines = [f"likelihood = {max(best_ll, mle_ll):g}"]
    best_vec = flat_x[i_best] if best_ll >= mle_ll else mle_theta
    for nm, v in sorted(zip(param_names, best_vec)):
        lines.append(f"{nm} = {float(v):g}")
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)

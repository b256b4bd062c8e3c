"""Import a reference-stack ``countrate_cache.hdf5`` into a table artifact.

The port's copy of ``joxsz_tpu/tablegen/import_xspec_cache.py``.  The
reference pipeline (via mbproj2) tabulates XSPEC ``phabs(apec)`` count
rates into an HDF5 cache (reference joxsz_funcs.py:652-681): one
dataset per band, keyed by

    textkey = '_'.join(str(x) for x in key).replace('/', '@')
    key     = (minenergy_keV, maxenergy_keV, z, NH_1022, rmf, arf)

holding a ``(2, nT)`` array of count rates per unit XSPEC norm over
mbproj2's ``Tlogvals`` log-temperature grid, for Z = 0 and Z = 1 solar,
floored at 1e-300 and consumed as logs.

This importer converts such a cache — produced on any machine with a
HEASOFT install, by the unmodified reference stack — into the versioned
npz artifact our runtime interpolates (``models.xray.CountRateTable``).
That makes exact APEC physics a pure data swap: no code to trust, no
XSPEC driver to run here.  Workflow:

    # on a HEASOFT box: run the reference (or mbproj2) once so it fills
    # countrate_cache.hdf5 for your bands, then copy that file over and
    python -m joxsz_torch.tablegen.import_xspec_cache \
        --cache countrate_cache.hdf5 \
        --rmf data/X/source.rmf --arf data/X/source.arf \
        --z 0.888 --nh 0.0183 --out data/tables/cl1226_ctrate_xspec.npz

Matching is tolerant of machine differences: the four numeric key fields
are compared numerically (XSPEC keys are stringified floats, so '0.7'
vs '0.70' must not matter) and the RMF/ARF are matched on basename (the
HEASOFT box's paths differ from ours).

The bolometric-flux tables (used only for cooling-time profiles, not the
likelihood) are not in the reference cache; they are filled from the
analytic spectral model (on the card unless ``device`` / ``--cpu`` says
otherwise) and flagged in the metadata.  Reading the cache needs h5py.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from . import spectrum as sp
from .generate import (DEFAULT_BANDS, DEFAULT_TMIN, DEFAULT_TMAX,
                       SPECTRAL_MODEL_VERSION, TableSpec, parse_bands)


class CacheKeyError(ValueError):
    """A band has no (or an ambiguous) match in the XSPEC cache."""


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    textkey: str
    emin_keV: float
    emax_keV: float
    z: float
    NH_1022: float
    resp_blob: str               # rmf + '_' + arf, with '/' -> '@'
    lograte: np.ndarray          # (2, nT): log count rates at Z=0, Z=1


def _parse_textkey(textkey: str) -> tuple | None:
    """Split a cache dataset name back into its key fields.

    The first four '_'-joined fields are floats; the remainder is
    rmf + '_' + arf (either may itself contain '_', so the rmf/arf
    boundary is not recoverable — we only ever match on basenames)."""
    parts = textkey.split("_", 4)
    if len(parts) != 5:
        return None
    try:
        emin, emax, z, nh = (float(p) for p in parts[:4])
    except ValueError:
        return None
    return emin, emax, z, nh, parts[4]


def read_cache(path: str) -> list[CacheEntry]:
    """Read every parseable band entry from a countrate_cache.hdf5."""
    import h5py

    entries = []
    with h5py.File(path, "r") as f:
        for textkey in f:
            parsed = _parse_textkey(textkey)
            if parsed is None:
                continue
            raw = np.asarray(f[textkey], dtype=float)
            if raw.ndim != 2 or raw.shape[0] != 2:
                raise CacheKeyError(
                    f"cache entry {textkey!r} has shape {raw.shape}, "
                    "expected (2, nT) — not a reference-stack count-rate "
                    "cache?")
            emin, emax, z, nh, blob = parsed
            entries.append(CacheEntry(
                textkey=textkey, emin_keV=emin, emax_keV=emax, z=z,
                NH_1022=nh, resp_blob=blob,
                lograte=np.log(np.clip(raw, 1e-300, None))))
    if not entries:
        raise CacheKeyError(
            f"{path}: no parseable count-rate entries found "
            "(expected datasets named minE_maxE_z_NH_rmf_arf)")
    return entries


def _resp_blob_matches(blob: str, rmf_b: str, arf_b: str) -> bool:
    """Exact-basename response match against ``rmf + '_' + arf`` (with
    '/' -> '@').  The rmf/arf boundary inside the blob is not recorded
    (either path may itself contain '_'), so try every underscore as
    the join point and require the '@'-path basenames on both sides to
    EQUAL the wanted basenames.  A bare substring test would let e.g.
    --rmf source.rmf silently match a cache built with xmm_source.rmf —
    the exact silent-substitution this module promises never to do."""
    for i, ch in enumerate(blob):
        if ch != "_":
            continue
        rmf_part, arf_part = blob[:i], blob[i + 1:]
        if (rmf_part.rsplit("@", 1)[-1] == rmf_b
                and arf_part.rsplit("@", 1)[-1] == arf_b):
            return True
    return False


def _match_band(entries: list[CacheEntry], lo_eV: float, hi_eV: float,
                z: float, NH_1022: float, rmf: str, arf: str,
                rtol: float = 1e-4) -> CacheEntry:
    rmf_b = os.path.basename(rmf).replace("/", "@")
    arf_b = os.path.basename(arf).replace("/", "@")
    want = np.array([lo_eV / 1000.0, hi_eV / 1000.0, z, NH_1022])

    def close(e: CacheEntry) -> bool:
        got = np.array([e.emin_keV, e.emax_keV, e.z, e.NH_1022])
        return bool(np.allclose(got, want, rtol=rtol, atol=1e-9))

    hits = [e for e in entries if close(e)
            and _resp_blob_matches(e.resp_blob, rmf_b, arf_b)]
    if len(hits) == 1:
        return hits[0]
    if not hits:
        near = [e.textkey for e in entries if close(e)]
        detail = (f" (numeric match but different responses: {near})"
                  if near else "")
        raise CacheKeyError(
            f"band {lo_eV:g}-{hi_eV:g} eV (z={z}, NH={NH_1022}, "
            f"rmf~{rmf_b}, arf~{arf_b}) not found in cache{detail}. "
            "The cache must be generated with the same bands, redshift, "
            "column density and responses as the fit config.")
    raise CacheKeyError(
        f"band {lo_eV:g}-{hi_eV:g} eV matches {len(hits)} cache entries "
        f"({[e.textkey for e in hits]}) — ambiguous cache")


def import_cache(cache_path: str, spec: TableSpec, device=None) -> dict:
    """Build an npz table dict (same layout as generate_table) from a
    reference-stack XSPEC cache, the analytic bolometric fluxes on
    ``device`` (default: the card).  Raises CacheKeyError on any missing,
    ambiguous, or inconsistent entry — never silently substitutes."""
    from ..device import resolve_device

    dev = resolve_device(device)
    entries = read_cache(cache_path)

    picked = [_match_band(entries, lo, hi, spec.z, spec.NH_1022pcm2,
                          spec.rmf, spec.arf)
              for lo, hi in spec.bands_eV]

    nTs = {e.lograte.shape[1] for e in picked}
    if len(nTs) != 1:
        raise CacheKeyError(f"inconsistent temperature-grid lengths across "
                            f"bands: {sorted(nTs)}")
    nT = nTs.pop()
    # mbproj2's Tlogvals convention: uniform in log T over [Tmin, Tmax].
    # The cache stores no grid — only its length — so the bounds must be
    # the mbproj2 defaults the reference stack used.
    Tlog = np.linspace(np.log(spec.Tmin), np.log(spec.Tmax), nT)

    lograte_Z0 = np.stack([e.lograte[0] for e in picked])   # (n_band, nT)
    lograte_Z1 = np.stack([e.lograte[1] for e in picked])

    # cooling-time flux tables are not in the cache: analytic fallback
    with torch.no_grad():
        bolo = sp.bolometric_flux_per_norm(
            torch.exp(torch.as_tensor(Tlog, device=dev))[:, None],
            torch.tensor([0.0, 1.0], dtype=torch.float64,
                         device=dev)[:, None, None],
            spec.z, device=dev).cpu().numpy()
    bolo = np.clip(bolo, 1e-300, None)

    return {
        "Tlog": Tlog,
        "lograte_Z0": lograte_Z0,
        "lograte_Z1": lograte_Z1,
        "logflux_Z0": np.log(bolo[0]),
        "logflux_Z1": np.log(bolo[1]),
        "bands_eV": np.asarray(spec.bands_eV, dtype=float),
        "meta": np.bytes_(json.dumps({
            "z": spec.z, "NH_1022pcm2": spec.NH_1022pcm2,
            "rmf": os.path.basename(spec.rmf),
            "arf": os.path.basename(spec.arf),
            # 'xspec-cache' is exact physics like 'xspec' and exempt from
            # the fallback-model version check (models.xray.from_npz)
            "backend": "xspec-cache",
            "model": "phabs(apec) via reference countrate_cache.hdf5",
            "model_version": spec.model_version,
            "source_cache": os.path.basename(cache_path),
            "source_keys": [e.textkey for e in picked],
            "flux_tables": "analytic fallback (cooling-time profiles "
                           "only; not in the reference cache)",
        }).encode()),
    }


def main(argv=None):
    import argparse

    from .generate import save_table

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache", required=True,
                    help="countrate_cache.hdf5 from the reference stack")
    ap.add_argument("--rmf", required=True)
    ap.add_argument("--arf", required=True)
    ap.add_argument("--z", type=float, required=True)
    ap.add_argument("--nh", type=float, required=True,
                    help="column density in 1e22 cm^-2")
    ap.add_argument("--bands", default=DEFAULT_BANDS,
                    help="comma-separated eV bands lo:hi")
    ap.add_argument("--tmin", type=float, default=DEFAULT_TMIN,
                    help="mbproj2 Tlogvals lower bound (keV)")
    ap.add_argument("--tmax", type=float, default=DEFAULT_TMAX,
                    help="mbproj2 Tlogvals upper bound (keV)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="compute the bolometric fluxes on the CPU "
                         "(default: the card)")
    args = ap.parse_args(argv)

    bands = parse_bands(args.bands)
    spec = TableSpec(rmf=args.rmf, arf=args.arf, bands_eV=bands, z=args.z,
                     NH_1022pcm2=args.nh, Tmin=args.tmin, Tmax=args.tmax,
                     model_version=SPECTRAL_MODEL_VERSION)
    table = import_cache(args.cache, spec,
                         device="cpu" if args.cpu else None)
    save_table(args.out, table)
    meta = json.loads(table["meta"].item())
    print(f"wrote {args.out}: {len(bands)} bands, "
          f"nT={len(table['Tlog'])}, backend={meta['backend']} "
          f"(from {meta['source_cache']})")


if __name__ == "__main__":
    main()

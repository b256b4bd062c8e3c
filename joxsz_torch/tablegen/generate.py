"""Count-rate table generation.

The port's counterpart of ``joxsz_tpu/tablegen/generate.py``: the
versioned artifact the X-ray model interpolates (``models.xray.
CountRateTable``) — per band, cts/s per unit XSPEC norm on a log-T grid at
Z = 0 and Z = 1 solar, plus the bolometric flux tables of the cooling-time
profile — from an RMF/ARF, a redshift and a column density.

Backends:
  * 'torch' — the analytic spectral model of ``tablegen/spectrum.py`` on
              the whole (Z, T, E) grid at once in float64, folded through
              the response and the band masks as two matrix products, on
              the card unless ``device`` says otherwise.  It stands where
              the JAX package has its numpy reference and its C++ core
              (``native/tablegen``), which the port does not load;
  * 'xspec' — drives a real HEASOFT XSPEC binary by subprocess where one
              is installed, for APEC-exact tables.

CLI:
    python -m joxsz_torch.tablegen.generate \\
        --rmf data/X/source.rmf --arf data/X/source.arf \\
        --z 0.888 --nh 0.0183 --out data/tables/cl1226_ctrate.npz [--cpu]
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

from ..io.ogip import Response, load_response
from . import spectrum as sp

# the default grid of mbproj2: log-spaced temperatures over the physical
# range of cluster plasmas
DEFAULT_TMIN = 0.06
DEFAULT_TMAX = 60.0
DEFAULT_NT = 64

# bump when the spectral model changes: the value is part of TableSpec's
# repr, which keys the generated tables' file names (build.find_table), so
# stale tables regenerate.  v2 = the calibrated 18-complex line model.
SPECTRAL_MODEL_VERSION = 2


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """What a generated count-rate table depends on: the fields, defaults
    and repr of ``joxsz_tpu/tablegen/generate.py::TableSpec``, whose
    repr keys the generated tables' file names."""

    rmf: str
    arf: str
    bands_eV: tuple
    z: float
    NH_1022pcm2: float
    Tmin: float = DEFAULT_TMIN
    Tmax: float = DEFAULT_TMAX
    nT: int = DEFAULT_NT
    model_version: int = SPECTRAL_MODEL_VERSION

    def key(self) -> str:
        return hashlib.sha256(repr(self).encode()).hexdigest()[:12]


def band_masks(resp: Response, bands_eV) -> np.ndarray:
    """(n_band, nC) 0/1 channel masks of the bands (eV); raises where a
    band selects no channel."""
    masks = np.stack([resp.channel_mask(lo / 1000.0, hi / 1000.0)
                      .astype(float) for lo, hi in bands_eV])
    if np.any(masks.sum(axis=1) == 0):
        raise ValueError("a band selects no channels")
    return masks


def rates_torch(resp: Response, masks: np.ndarray, Tlog, z: float,
                NH_1022: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """((2, nT, n_band) count rates per unit norm, (2, nT) bolometric
    fluxes) at Z = 0 and 1, float64 on ``device``: the photon fluxes of
    the whole grid in one evaluation, then ``(flux x width) @ folded @
    masks^T``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    T = torch.exp(t(Tlog))[:, None]                       # (nT, 1)
    Z = t([0.0, 1.0])[:, None, None]                      # (2, 1, 1)
    e_mid, e_wid = t(resp.energ_mid), t(resp.energ_width)
    f = sp.observed_photon_flux(e_mid, T, Z, z, NH_1022) * e_wid
    chan = f.reshape(-1, e_mid.numel()) @ t(resp.folded())
    rates = (chan @ t(masks).T).reshape(2, T.shape[0], -1)
    bolo = sp.bolometric_flux_per_norm(T, Z, z, device=device)
    return rates, bolo


def _table(spec: TableSpec, Tlog, rates, bolo, meta: dict) -> dict:
    rates = np.clip(rates, 1e-300, None)
    bolo = np.clip(bolo, 1e-300, None)
    return {
        "Tlog": Tlog,
        "lograte_Z0": np.log(rates[0]).T,   # (n_band, nT)
        "lograte_Z1": np.log(rates[1]).T,
        "logflux_Z0": np.log(bolo[0]),
        "logflux_Z1": np.log(bolo[1]),
        "bands_eV": np.asarray(spec.bands_eV, dtype=float),
        "meta": np.bytes_(json.dumps({
            "z": spec.z, "NH_1022pcm2": spec.NH_1022pcm2,
            "rmf": os.path.basename(spec.rmf),
            "arf": os.path.basename(spec.arf),
            **meta, "model_version": spec.model_version}).encode()),
    }


def generate_table(spec: TableSpec, backend: str = "torch",
                   device=None) -> dict:
    """Every table array of ``spec``, a dict ready for ``np.savez``; the
    torch backend runs on ``device`` (default: the card)."""
    from ..device import resolve_device

    if backend not in ("torch", "xspec"):
        raise ValueError(f"backend must be 'torch' or 'xspec', got "
                         f"{backend!r}")
    dev = resolve_device(device)
    resp = load_response(spec.rmf, spec.arf)
    masks = band_masks(resp, spec.bands_eV)
    Tlog = np.linspace(np.log(spec.Tmin), np.log(spec.Tmax), spec.nT)
    if backend == "xspec":
        return _generate_with_xspec(spec, Tlog, dev)
    with torch.no_grad():
        rates, bolo = rates_torch(resp, masks, Tlog, spec.z,
                                  spec.NH_1022pcm2, dev)
    return _table(spec, Tlog, rates.cpu().numpy(), bolo.cpu().numpy(), {
        "backend": "torch",
        "model": "ff+lines fallback (regenerate with --backend xspec for "
                 "APEC-exact rates)"})


def _generate_with_xspec(spec: TableSpec, Tlog, device) -> dict:
    """Drive a real XSPEC binary (HEASOFT) to tabulate phabs*apec count
    rates, as ``joxsz_tpu/tablegen/generate.py`` does: per band a fake
    spectrum bound to the RMF/ARF, noticed to the band, ``model
    phabs(apec)`` at norm 1 stepped over the grid at Z = 0 and 1, the
    predicted rate from ``tclout rate``.  The bolometric fluxes come from
    the analytic model on ``device``."""
    if shutil.which("xspec") is None:
        raise RuntimeError("xspec binary not found on PATH")
    import tempfile

    T_grid = np.exp(Tlog)
    Z_grid = (0.0, 1.0)
    rates = np.zeros((len(Z_grid), len(T_grid), len(spec.bands_eV)))
    with tempfile.TemporaryDirectory() as td:
        script = pathlib.Path(td) / "rates.xcm"
        out_path = pathlib.Path(td) / "rates.dat"
        lines = [
            "query yes",
            "abund angr",
            # fake 1-count spectrum so XSPEC accepts the responses
            f"fakeit none & {spec.rmf} & {spec.arf} & y & & "
            f"{td}/fake.pha & 1.0",
            f"set fp [open {out_path} w]",
        ]
        for ib, (lo, hi) in enumerate(spec.bands_eV):
            lines += ["ignore **-**",
                      f"notice {lo/1000.0:.6f}-{hi/1000.0:.6f}"]
            for iz, Z in enumerate(Z_grid):
                for it, T in enumerate(T_grid):
                    lines += [
                        f"model phabs(apec) & {spec.NH_1022pcm2} & "
                        f"{T:.6g} & {Z} & {spec.z} & 1.0 & /*",
                        "tclout rate 1",
                        # field 3 of tclout rate = predicted model rate
                        f'puts $fp "{iz} {it} {ib} [lindex $xspec_tclout 2]"',
                    ]
        lines += ["close $fp", "exit"]
        script.write_text("\n".join(lines) + "\n")
        subprocess.run(["xspec", "-"], input=script.read_text(),
                       capture_output=True, text=True, timeout=3600,
                       check=True)
        for row in out_path.read_text().split("\n"):
            if not row.strip():
                continue
            iz, it, ib, r = row.split()
            rates[int(iz), int(it), int(ib)] = float(r)
    with torch.no_grad():
        bolo = sp.bolometric_flux_per_norm(
            torch.as_tensor(T_grid, device=device)[:, None],
            torch.tensor([0.0, 1.0], dtype=torch.float64,
                         device=device)[:, None, None],
            spec.z, device=device).cpu().numpy()
    # model_version tracks the fallback spectral model; XSPEC tables are
    # exact physics and exempt from the version check
    return _table(spec, Tlog, rates, bolo,
                  {"backend": "xspec", "model": "phabs(apec)"})


def save_table(path: str, table: dict):
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **table)


def parse_bands(text: str) -> tuple:
    """'lo:hi,lo:hi,...' (eV) -> ((lo, hi), ...)."""
    return tuple(tuple(int(x) for x in b.split(":"))
                 for b in text.split(","))


DEFAULT_BANDS = ("700:1000,1000:1300,1300:1600,1600:2000,2000:2700,"
                 "2700:3400,3400:3800,3800:4300,4300:5000,5000:7000")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rmf", required=True)
    ap.add_argument("--arf", required=True)
    ap.add_argument("--z", type=float, required=True)
    ap.add_argument("--nh", type=float, required=True,
                    help="column density in 1e22 cm^-2")
    ap.add_argument("--bands", default=DEFAULT_BANDS,
                    help="comma-separated eV bands lo:hi")
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", default="torch", choices=["torch", "xspec"])
    ap.add_argument("--nT", type=int, default=DEFAULT_NT)
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU (default: the card)")
    args = ap.parse_args(argv)

    bands = parse_bands(args.bands)
    spec = TableSpec(rmf=args.rmf, arf=args.arf, bands_eV=bands, z=args.z,
                     NH_1022pcm2=args.nh, nT=args.nT)
    table = generate_table(spec, backend=args.backend,
                           device="cpu" if args.cpu else None)
    save_table(args.out, table)
    print(f"wrote {args.out}: {len(bands)} bands, nT={args.nT}, "
          f"backend={json.loads(table['meta'].item())['backend']}")


if __name__ == "__main__":
    main()

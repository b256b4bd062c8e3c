"""X-ray forward model + Cash likelihood (batched torch).

Torch counterpart of ``joxsz_tpu/models/xray.py`` (the mbproj2 pipeline
the reference drives through ``Fit.calcProfiles`` + ``mylikeFromProfs``,
joxsz_funcs.py:495-546):

    ne, T_X, Z at the shell midpoints
      -> per-band count rate per unit XSPEC norm (table lookup: linear in
         log T of the log-rate, linear in Z between the Z=0 and Z=1 grids)
      -> emissivity density = rate * ne^2 * norm-per-cm^3 (in vols_norm)
      -> shell-to-annulus projection: one (n_ann, n_shell) product per band
      -> x exposure x areascale + backscale * backrate * exposure * area
      -> Cash log-likelihood sum(d ln m - m) over valid counts.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..geometry.annuli import Annuli
from ..io.readers import BandData
from ..ops.splines import lerp_lookup
from ..precision import mm


def uniform_hat_weights(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense (..., n) hat-basis lerp weights on a UNIFORM grid:
    w[j] = (1-frac)[j==k] + frac[j==k+1] with the position clipped to
    [0, n-1-1e-6], so ``w @ table`` is the linear interpolation of
    ``table`` at ``x`` (a NaN position matches no hat: all weights 0).
    The JAX package's form of the lookup; ``uniform_hat_lerp`` computes
    the same value from its two non-zero taps.  ``grid`` may carry
    leading batch axes; only its first row's spacing is used."""
    g = grid.reshape(-1, grid.shape[-1])[0]
    n = g.shape[0]
    pos = torch.clamp((x - g[0]) / (g[1] - g[0]), 0.0, n - 1 - 1e-6)
    k = torch.floor(pos)[..., None]
    frac = (pos - torch.floor(pos))[..., None]
    j = torch.arange(n, dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return (torch.where(j == k, 1.0 - frac, zero)
            + torch.where(j == k + 1.0, frac, zero))


def uniform_hat_lerp(Tlog: torch.Tensor, table: torch.Tensor,
                     tl: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``table`` (n_band, nT) on the uniform grid
    ``Tlog`` at ``tl`` (...) -> (..., n_band), with the position clipped
    to [0, nT-1-1e-6] — the value the JAX package's dense hat-basis
    product (``uniform_hat_weights @ table``) gives, written as its two
    non-zero taps.  A NaN position matches no hat: both weights are 0."""
    n = Tlog.shape[0]
    dt = Tlog[1] - Tlog[0]
    pos = torch.clamp((tl - Tlog[0]) / dt, 0.0, n - 1 - 1e-6)
    nan = torch.isnan(pos)
    pos = torch.where(nan, torch.zeros_like(pos), pos)
    k = torch.floor(pos)
    frac = pos - k
    live = (~nan).to(pos.dtype)
    ki = k.long()
    t0 = table[:, ki].movedim(0, -1)
    t1 = table[:, torch.clamp(ki + 1, max=n - 1)].movedim(0, -1)
    return (((1.0 - frac) * live)[..., None] * t0
            + (frac * live)[..., None] * t1)


@dataclasses.dataclass(frozen=True)
class CountRateTable:
    """Per-band count rates (cts/s per unit XSPEC norm) on a uniform
    natural-log-T grid, tabulated at Z=0 and Z=1 solar."""

    Tlog: torch.Tensor          # (nT,)
    lograte_Z0: torch.Tensor    # (n_band, nT)
    lograte_Z1: torch.Tensor    # (n_band, nT)
    # bolometric log-flux per unit norm (nT,), which only the cooling
    # time of ``postproc.profiles`` reads; None where a table lacks it
    logflux_Z0: torch.Tensor | None = None
    logflux_Z1: torch.Tensor | None = None

    def rates(self, T_keV, Z_solar):
        """(..., n_shell) temperatures -> (..., n_band, n_shell) rates."""
        tl = torch.log(T_keV)
        r0 = torch.exp(uniform_hat_lerp(self.Tlog, self.lograte_Z0, tl))
        r1 = torch.exp(uniform_hat_lerp(self.Tlog, self.lograte_Z1, tl))
        rates = r0 * (1.0 - Z_solar[..., None]) + r1 * Z_solar[..., None]
        return rates.movedim(-1, -2)

    def flux(self, T_keV, Z_solar, ne_cm3, norm_per_cm3):
        """Observed bolometric flux per cm^3 of emitting plasma
        (erg/cm^2/s/cm^3), for cooling-time profiles (cf. reference
        joxsz_plots.py:243); the log-flux tables extrapolate linearly
        past the grid's ends."""
        tl = torch.log(T_keV)
        f0 = torch.exp(lerp_lookup(self.Tlog, self.logflux_Z0, tl))
        f1 = torch.exp(lerp_lookup(self.Tlog, self.logflux_Z1, tl))
        f = f0 * (1.0 - Z_solar) + f1 * Z_solar
        return f * ne_cm3 * ne_cm3 * norm_per_cm3

    @classmethod
    def from_npz(cls, path: str, *, dtype, device,
                 expect: dict | None = None) -> "CountRateTable":
        """Load a table artifact.  ``expect={'z', 'NH_1022pcm2',
        'bands_eV', 'model_version'}`` validates the stored generation
        metadata against the fit configuration — a table built for
        another redshift/column/band set silently gives wrong X-ray
        physics otherwise."""
        d = np.load(path)
        if expect is not None:
            meta = json.loads(bytes(d["meta"]).decode()) if "meta" in d \
                else {}
            errs = []
            for key, tol in (("z", 1e-6), ("NH_1022pcm2", 1e-9)):
                want, got = expect.get(key), meta.get(key)
                if want is not None and got is not None and \
                        abs(float(want) - float(got)) > tol:
                    errs.append(f"{key}: table {got} != config {want}")
            want_ver = expect.get("model_version")
            if want_ver is not None and \
                    not str(meta.get("backend", "")).startswith("xspec"):
                # fallback-model tables must carry the current spectral
                # model version; XSPEC-backend tables are exact physics
                got_ver = meta.get("model_version")
                if got_ver != want_ver:
                    errs.append(f"spectral model_version: table "
                                f"{got_ver} != current {want_ver}")
            want_bands = expect.get("bands_eV")
            if want_bands is not None and "bands_eV" in d:
                got_b = np.asarray(d["bands_eV"], dtype=float)
                want_b = np.asarray(want_bands, dtype=float)
                if got_b.shape != want_b.shape or not np.allclose(got_b,
                                                                  want_b):
                    errs.append("bands_eV differ between table and config")
            if errs:
                raise ValueError(
                    f"count-rate table {path} was generated for a "
                    f"different setup: {'; '.join(errs)}. Point "
                    "xray.table_path at the right artifact.")
        tl = np.asarray(d["Tlog"], dtype=float)
        if tl.size >= 2 and not np.allclose(np.diff(tl), tl[1] - tl[0],
                                            rtol=1e-6, atol=1e-12):
            raise ValueError(
                f"count-rate table {path} has a NON-UNIFORM Tlog grid; "
                "the runtime interpolation assumes uniform log-T spacing")
        flux = {k: d[k] for k in ("logflux_Z0", "logflux_Z1")
                if k in d.files}
        return cls.from_arrays(d["Tlog"], d["lograte_Z0"], d["lograte_Z1"],
                               dtype=dtype, device=device, **flux)

    @classmethod
    def from_arrays(cls, Tlog, lograte_Z0, lograte_Z1, *, dtype, device,
                    logflux_Z0=None, logflux_Z1=None):
        def asx(a):
            if a is None:
                return None
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   dtype=dtype, device=device)

        return cls(Tlog=asx(Tlog), lograte_Z0=asx(lograte_Z0),
                   lograte_Z1=asx(lograte_Z1), logflux_Z0=asx(logflux_Z0),
                   logflux_Z1=asx(logflux_Z1))


@dataclasses.dataclass(frozen=True)
class XrayData:
    """Device-resident constants for the X-ray likelihood of one cluster."""

    counts_mask: torch.Tensor    # (n_band, n_ann) 1.0 where counts valid
    counts_filled: torch.Tensor  # counts with NaN -> 0
    exposures: torch.Tensor      # (n_band, n_ann) s
    areascales: torch.Tensor     # (n_band, n_ann)
    areas: torch.Tensor          # (n_band, n_ann) arcmin^2 (pixelised)
    backrates: torch.Tensor      # (n_band, n_ann) cts/s/arcmin^2
    vols_norm: torch.Tensor      # (n_ann, n_shell): projection volumes x
    #                              the per-cm^3 XSPEC norm — O(0.1) values,
    #                              float32-safe
    midpt_kpc: torch.Tensor      # (n_shell,)
    norm_per_cm3: float
    table: CountRateTable

    @classmethod
    def build(cls, bands: list[BandData], annuli: Annuli,
              table: CountRateTable, *, dtype, device) -> "XrayData":
        cts = np.stack([b.counts for b in bands])
        norm = float(annuli.xspec_norm_per_cm3())
        return cls.from_arrays(
            counts=cts,
            exposures=np.stack([b.exposures_s for b in bands]),
            areascales=np.stack([b.areascales for b in bands]),
            areas=np.stack([b.areas_arcmin2 for b in bands]),
            backrates=np.stack([b.backrates for b in bands]),
            vols_norm=annuli.vols_cm3 * norm, midpt_kpc=annuli.midpt_kpc,
            norm_per_cm3=norm, table=table, dtype=dtype, device=device)

    @classmethod
    def from_arrays(cls, *, counts, exposures, areascales, areas, backrates,
                    vols_norm, midpt_kpc, norm_per_cm3, table, dtype,
                    device) -> "XrayData":
        def asx(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   dtype=dtype, device=device)

        cts = np.asarray(counts, dtype=np.float64)
        mask = ~np.isnan(cts)
        return cls(
            counts_mask=asx(mask.astype(float)),
            counts_filled=asx(np.where(mask, cts, 0.0)),
            exposures=asx(exposures), areascales=asx(areascales),
            areas=asx(areas), backrates=asx(backrates),
            vols_norm=asx(vols_norm), midpt_kpc=asx(midpt_kpc),
            norm_per_cm3=float(norm_per_cm3), table=table,
        )


def predicted_counts(pars: dict, x: XrayData, density, temperature,
                     Z_name: str = "Z"):
    """(B, n_band, n_ann) predicted counts."""
    ne = density(pars, x.midpt_kpc)                     # (B, n_shell)
    T = temperature.t_x(pars, x.midpt_kpc)              # (B, n_shell)
    # line_scale (frozen at 1 here) scales exactly the metal-line part
    Z = pars[Z_name] * pars.get("line_scale", 1.0) * torch.ones_like(T)
    rates = x.table.rates(T, Z)                         # (B, band, shell)
    emiss = rates * (ne * ne)[:, None, :]
    proj = mm(emiss, x.vols_norm.T)                       # (B, band, ann)
    signal = proj * x.exposures * x.areascales
    bs = pars["backscale"]
    bs = bs[:, :, None] if torch.is_tensor(bs) else bs
    return signal + bs * x.backrates * x.exposures * x.areas


def cash_log_like(counts_filled, mask, pred):
    """Poisson (Cash) log-likelihood sum(d ln m - m) over valid annuli,
    dropping the data-only constant terms (mbproj2 convention)."""
    return (mask * (counts_filled * torch.log(pred) - pred)).sum(dim=(1, 2))


def xray_log_like(pars: dict, x: XrayData, density, temperature,
                  Z_name: str = "Z"):
    """(B,) Cash log-likelihood with the reference's positivity veto
    (joxsz_funcs.py:529-532), evaluated over VALID cells only."""
    pred = predicted_counts(pars, x, density, temperature, Z_name)
    ones = torch.ones_like(pred)
    ok = torch.where(x.counts_mask > 0, pred, ones).amin(dim=(1, 2)) > 0.0
    safe = torch.where(pred > 0.0, pred, ones)
    ll = cash_log_like(x.counts_filled, x.counts_mask, safe)
    return torch.where(ok, ll, torch.full_like(ll, -float("inf")))

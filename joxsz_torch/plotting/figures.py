"""The six reference figure sets (PDF outputs, matplotlib only).

Counterpart of ``joxsz_tpu/plotting/figures.py``; the file names are the
JAX package's.  Parity targets (reference joxsz_plots.py; the `corner`
package is not used, so the corner plot is drawn natively):
  traceplot.pdf        walker traces, 4 params/page       (:12-48)
  cornerplot.pdf       marginals + 2D hists + CI lines    (:50-91)
  fit_on_data.pdf      10 X-ray band panels + SZ panel    (:134-192)
  radial_profiles.pdf  3x2 thermo panels                  (:275-314)
  mass_hse.pdf         HSE mass + overdensity annotations (:401-449)
  frac_gas.pdf         gas fraction profile               (:480-504)

matplotlib is imported inside the functions (Agg backend), so the port
imports without it; ``run`` checks for it before sampling.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.mass import mass_overdensity
from ..postproc.profiles import equal_tailed


def _mpl():
    """(pyplot, PdfPages) on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    return plt, PdfPages


def _out(plotdir: str, name: str) -> str:
    """Output path via os.path.join (a plotdir without a trailing slash
    must not mangle the name)."""
    return os.path.join(plotdir, name)


def _np(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _latex(names):
    return [f"${n}$" for n in names]


def traceplot(cube_chain: np.ndarray, param_names, plot_walkers: int = 20,
              per_page: int = 4, seed=None, plotdir: str = "./"):
    """Walker traces, multi-page PDF (nw, nsteps, ndim input layout)."""
    plt, PdfPages = _mpl()
    nw, nsteps, ndim = cube_chain.shape
    rng = np.random.default_rng(seed)
    idx = rng.choice(nw, min(plot_walkers, nw), replace=False)
    labels = _latex(param_names)
    with PdfPages(_out(plotdir, "traceplot.pdf")) as pdf:
        for start in range(0, ndim, per_page):
            fig, axes = plt.subplots(per_page, 1, figsize=(8, 10),
                                     sharex=True, squeeze=False)
            for k in range(per_page):
                ax = axes[k, 0]
                i = start + k
                if i >= ndim:
                    ax.axis("off")
                    continue
                for j in idx:
                    ax.plot(np.arange(nsteps) + 1, cube_chain[j, :, i],
                            lw=0.2)
                ax.set_ylabel(labels[i])
            axes[-1, 0].set_xlabel("Iteration number")
            pdf.savefig(fig, bbox_inches="tight")
            plt.close(fig)


def cornerplot(flat_chain: np.ndarray, param_names, ci: float = 95.0,
               bins: int = 40, plotdir: str = "./"):
    """Native corner plot: diagonal histograms with median/CI lines and
    titles, lower-triangle 2D histograms with median cross-hairs."""
    plt, PdfPages = _mpl()
    n = flat_chain.shape[1]
    labels = _latex(param_names)
    lo, med, up = equal_tailed(flat_chain, ci)
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n),
                         squeeze=False)
    for i in range(n):
        for j in range(n):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(flat_chain[:, i], bins=bins, histtype="step",
                        color="k", density=True)
                ax.axvline(med[i], color="r", ls="--")
                ax.axvline(lo[i], color="r", ls=":")
                ax.axvline(up[i], color="r", ls=":")
                ax.set_title(
                    f"{labels[i]} = ${med[i]:.2f}_{{-{med[i]-lo[i]:.2f}}}"
                    f"^{{+{up[i]-med[i]:.2f}}}$", fontsize=9)
                ax.set_yticks([])
            else:
                # rasterized: each panel's QuadMesh is bins^2 quads, and
                # vector output would write every one as a PDF path
                ax.hist2d(flat_chain[:, j], flat_chain[:, i], bins=bins,
                          cmap="Greys", rasterized=True)
                ax.axvline(med[j], color="r", ls="--", lw=0.8)
                ax.axhline(med[i], color="r", ls="--", lw=0.8)
            if i < n - 1:
                ax.set_xticklabels([])
            else:
                ax.set_xlabel(labels[j], fontsize=9)
            if j > 0 or i == 0:
                ax.set_yticklabels([])
            elif i > 0:
                ax.set_ylabel(labels[i], fontsize=9)
    fig.subplots_adjust(hspace=0.08, wspace=0.08)
    with PdfPages(_out(plotdir, "cornerplot.pdf")) as pdf:
        pdf.savefig(fig, bbox_inches="tight")
    plt.close(fig)


def fit_on_data(bands, annuli, sz_data, perc_x, perc_sz, ci: float = 95.0,
                step_arcsec: float = 2.0, plotdir: str = "./"):
    """X-ray surface-brightness panels per band + the SZ profile panel.

    Either probe may be absent (SZ-only fits have ``perc_x=None``,
    X-ray-only fits have ``perc_sz=None``/``sz_data=None``): each
    panel block is drawn only when its data exists, so the figure is
    produced in every supported mode instead of crashing (X-ray-only)
    or silently never appearing (SZ-only)."""
    plt, PdfPages = _mpl()
    has_x = perc_x is not None and bands
    has_sz = perc_sz is not None and sz_data is not None
    n_bands = len(bands) if has_x else 0
    npan = n_bands + (1 if has_sz else 0)
    if npan == 0:
        return
    ncol = min(3, npan)
    nrow = int(np.ceil(npan / ncol))
    fig, axes = plt.subplots(nrow, ncol, figsize=(8 * ncol, 6 * nrow),
                             squeeze=False)
    if has_x:
        edges = annuli.edges_arcmin
        xmid = 0.5 * (edges[1:] + edges[:-1])
        xerr = 0.5 * (edges[1:] - edges[:-1])
        geom = np.pi * (edges[1:] ** 2 - edges[:-1] ** 2)
        lx, mx, ux = perc_x
        for i, band in enumerate(bands):
            ax = axes[i // ncol, i % ncol]
            scale = geom * band.areascales
            ax.set_xscale("log")
            ax.set_yscale("log")
            ax.plot(xmid, mx[i] / scale, color="r")
            ax.fill_between(xmid, lx[i] / scale, ux[i] / scale,
                            color="gold")
            ax.errorbar(xmid, band.counts / scale, xerr=xerr,
                        yerr=np.sqrt(band.counts) / scale, fmt="o",
                        markersize=3, color="black")
            ax.text(0.1, 0.1,
                    f"[{band.emin_keV:g}-{band.emax_keV:g}] keV",
                    transform=ax.transAxes)
            ax.set_xlabel("Radius (arcmin)")
            ax.set_ylabel(r"$S_X$ (counts arcmin$^{-2}$)")
    if has_sz:
        lsz, msz, usz = perc_sz
        ax = axes[(npan - 1) // ncol, (npan - 1) % ncol]
        r_am = _np(sz_data.flux_r) / 60.0
        r_model = np.arange(msz.size) * step_arcsec / 60.0  # arcmin
        ax.errorbar(r_am, _np(sz_data.flux),
                    yerr=_np(sz_data.flux_err), fmt="o",
                    markersize=2, color="black", label="SZ data")
        ax.plot(r_model, msz, color="r", label="Best-fit")
        ax.fill_between(r_model, lsz, usz, color="gold",
                        label=f"{ci:g}% CI")
        ax.set_xlim(0, np.ceil(r_am[-1]))
        ax.set_xlabel("Radius (arcmin)")
        ax.set_ylabel(r"$S_{SZ}$ (mJy beam$^{-1}$)")
        ax.legend()
    for k in range(npan, nrow * ncol):
        axes[k // ncol, k % ncol].axis("off")
    fig.tight_layout()
    with PdfPages(_out(plotdir, "fit_on_data.pdf")) as pdf:
        pdf.savefig(fig, bbox_inches="tight")
    plt.close(fig)


def radial_profiles(profset, tempx_differs: bool = True,
                    xmin: float = 100.0, xmax: float = 1000.0,
                    ci: float = 95.0, plotdir: str = "./"):
    """3x2 log-log thermodynamic panels."""
    plt, PdfPages = _mpl()
    r = profset.r_kpc
    panels = [
        (profset.density, "Density (cm$^{-3}$)", "log"),
        (profset.temp_sz, "Temperature (keV)", "linear"),
        (profset.pressure, "Pressure (keV cm$^{-3}$)", "log"),
        (profset.entropy, "Entropy (keV cm$^2$)", "log"),
        (profset.cooling_time / 1e9, "Cooling time (Gyr)", "log"),
        (profset.gas_mass / 1e12, r"Gas mass ($10^{12} M_\odot$)", "log"),
    ]
    sel = (r > xmin) & (r < xmax)
    fig, axes = plt.subplots(3, 2, figsize=(10, 12), sharex=True)
    for k, (band, label, yscale) in enumerate(panels):
        ax = axes[k // 2, k % 2]
        med = np.asarray(band[1][sel], dtype=float)
        # a quantity can be undefined for the model (cooling time is
        # NaN without a count-rate table — SZ-only fits): annotate the
        # panel instead of crashing matplotlib's log locator on a
        # positive-value-free axis
        drawable = np.isfinite(med).any() and (
            yscale != "log" or np.nanmax(med) > 0)
        if not drawable:
            ax.text(0.5, 0.5, f"{label}\n(not available for this "
                    "model)", ha="center", va="center",
                    transform=ax.transAxes, fontsize=9)
            ax.set_xscale("log")
            ax.set_ylabel(label)
            ax.set_xlim(xmin, xmax)
            continue
        ax.plot(r[sel], band[1][sel])
        ax.fill_between(r[sel], band[0][sel], band[2][sel],
                        color="powderblue")
        ax.set_xscale("log")
        ax.set_yscale(yscale)
        ax.set_ylabel(label)
        ax.set_xlim(xmin, xmax)
    if tempx_differs:
        ax = axes[0, 1]
        ax.plot(r[sel], profset.temp_x[1][sel])
        ax.fill_between(r[sel], profset.temp_x[0][sel],
                        profset.temp_x[2][sel], color="lightgreen",
                        alpha=0.25)
        ax.legend([f"$T_{{SZ}}$ ({ci:g}% CI)", f"$T_X$ ({ci:g}% CI)"],
                  fontsize=9)
    axes[2, 0].set_xlabel("Radius (kpc)")
    axes[2, 1].set_xlabel("Radius (kpc)")
    with PdfPages(_out(plotdir, "radial_profiles.pdf")) as pdf:
        pdf.savefig(fig, bbox_inches="tight")
    plt.close(fig)


def mass_plot(r_kpc, mass_bands, cosmo, r_delta=None, m_delta=None,
              delta: float = 500.0, xmin: float = 100.0,
              xmax: float = 1500.0, plotdir: str = "./"):
    plt, PdfPages = _mpl()

    sel = (r_kpc > xmin) & (r_kpc < xmax)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(r_kpc[sel], mass_bands[1][sel])
    ax.fill_between(r_kpc[sel], mass_bands[0][sel], mass_bands[2][sel],
                    color="powderblue")
    ax.plot(r_kpc[sel], _np(mass_overdensity(r_kpc[sel], cosmo,
                                                    delta)), color="g")
    if r_delta is not None:
        for q, ls in zip(range(3), (":", "--", ":")):
            ax.axvline(r_delta[q], color="k", ls=ls, lw=0.8)
        mag = int(np.log10(m_delta[1]))
        ax.set_title(
            rf"$M_{{{delta:g}}} = {m_delta[1]/10**mag:.2f}"
            rf"^{{+{(m_delta[2]-m_delta[1])/10**mag:.2f}}}"
            rf"_{{-{(m_delta[1]-m_delta[0])/10**mag:.2f}}}"
            rf"\times 10^{{{mag}}} M_\odot$;  "
            rf"$r_{{{delta:g}}} = {r_delta[1]:.0f}"
            rf"^{{+{r_delta[2]-r_delta[1]:.0f}}}"
            rf"_{{-{r_delta[1]-r_delta[0]:.0f}}}$ kpc", fontsize=12)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(xmin, xmax)
    ax.set_xlabel("Radius (kpc)")
    ax.set_ylabel(r"Total mass ($M_\odot$)")
    with PdfPages(_out(plotdir, "mass_hse.pdf")) as pdf:
        pdf.savefig(fig, bbox_inches="tight")
    plt.close(fig)


def gas_fraction_plot(r_kpc, fgas_bands, ci: float = 95.0,
                      xmin: float = 100.0, xmax: float = 1000.0,
                      plotdir: str = "./"):
    plt, PdfPages = _mpl()
    sel = (r_kpc > xmin) & (r_kpc < xmax)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.set_title(f"Gas fraction profile (median + {ci:g}% error)")
    ax.plot(r_kpc[sel], fgas_bands[1][sel])
    ax.fill_between(r_kpc[sel], fgas_bands[0][sel], fgas_bands[2][sel],
                    color="powderblue")
    ax.set_xscale("log")
    ax.set_xlim(xmin, xmax)
    ax.set_xlabel("Radius (kpc)")
    ax.set_ylabel("Gas fraction")
    with PdfPages(_out(plotdir, "frac_gas.pdf")) as pdf:
        pdf.savefig(fig, bbox_inches="tight")
    plt.close(fig)

"""Posterior regression pin: compare a posterior summary with the frozen
converged CL J1226 posterior.

Counterpart of ``joxsz_tpu/postproc/pin.py`` (numpy only).  The pin
fixture ``tests/fixtures/cl1226_posterior_pin.json`` is the JAX
package's converged production posterior of the real CL J1226.9+3332
data, frozen as an internal regression anchor (the reference's accuracy
north star is "posterior on the bundled CL J1226.9+3332 within MC
error", README.md:8-14); this module reads the same file.

Two comparison modes:

* ``mode="exact"`` — the summary was recomputed from the *same stored
  chain* (the --postprocess path): medians/stds must reproduce to float
  tolerance.
* ``mode="fresh"`` — an independent converged fit: medians must agree
  within ``n_sigma`` x the combined MC errors of the two medians (MC
  error of a median ~= sqrt(pi/2) * sd / sqrt(n_eff)), floored at
  ``median_floor_std`` x the pinned posterior sd because the
  ensemble-internal n_eff estimate is optimistic; posterior widths must
  agree within ``width_ratio_band`` (or a parameter's own measured
  ``width_band``).  The 0.20-sd floor is the JAX package's measured
  worst cross-pair scatter of four independent converged fits plus ~50%
  headroom (``joxsz_tpu/postproc/pin.py``).
"""

from __future__ import annotations

import json
import math
import pathlib

DEFAULT_PIN = (pathlib.Path(__file__).resolve().parents[2]
               / "tests" / "fixtures" / "cl1226_posterior_pin.json")


def load_pin(path: str | pathlib.Path | None = None) -> dict:
    return json.loads(pathlib.Path(path or DEFAULT_PIN).read_text())


def _median_mc_error(std: float, n_eff: float) -> float:
    # asymptotic sd of a sample median from n_eff effective draws of an
    # approximately normal marginal: sqrt(pi/2) * sd / sqrt(n_eff)
    return math.sqrt(math.pi / 2.0) * std / math.sqrt(max(n_eff, 1.0))


def check_pin(summary: dict, pin: dict | None = None, *,
              mode: str = "fresh", n_sigma: float = 6.0,
              median_floor_std: float = 0.20,
              width_ratio_band: tuple[float, float] = (0.8, 1.25),
              exact_rtol: float = 1e-5) -> tuple[bool, list[str]]:
    """Compare a posterior ``summary`` dict (the ``parameters`` layout of
    postproc.summary.summary_dict) against the pinned fixture.

    Returns ``(ok, report_lines)``; every violated parameter produces a
    report line, and a parameter missing from either side is a failure
    (a renamed/dropped parameter is exactly the kind of silent change
    the pin exists to catch)."""
    if mode not in ("exact", "fresh"):
        # an unknown mode must not silently fall through to the LOOSER
        # fresh gates (module contract: never substitute a weaker check)
        raise ValueError(f"mode must be 'exact' or 'fresh', got {mode!r}")
    if pin is None:
        # `pin or load_pin()` would silently swap an explicitly passed
        # empty/truncated pin for the bundled default
        pin = load_pin()
    pp = pin["parameters"]
    sp = summary["parameters"] if "parameters" in summary else summary
    report: list[str] = []

    missing = sorted(set(pp) ^ set(sp))
    if missing:
        report.append(f"parameter set differs from pin: {missing}")

    for name in sorted(set(pp) & set(sp)):
        p, s = pp[name], sp[name]
        med_p, med_s = float(p["median"]), float(s["median"])
        std_p, std_s = float(p["std"]), float(s["std"])
        if mode == "exact":
            scale = max(abs(med_p), std_p)
            if abs(med_s - med_p) > exact_rtol * scale:
                report.append(
                    f"{name}: median {med_s:.6g} != pinned {med_p:.6g} "
                    f"(exact mode, rtol {exact_rtol})")
            if abs(std_s - std_p) > exact_rtol * max(std_p, 1e-30):
                report.append(
                    f"{name}: std {std_s:.6g} != pinned {std_p:.6g} "
                    f"(exact mode)")
            continue
        # fresh mode.  A missing n_eff must TIGHTEN, never loosen: an
        # infinite n_eff zeroes the MC term so the measured 0.20-sd floor
        # governs (a default of 1.0 would make the gate vacuous).
        mc = math.hypot(
            _median_mc_error(std_p, float(p.get("n_eff", math.inf))),
            _median_mc_error(std_s, float(s.get("n_eff", math.inf))))
        tol = max(n_sigma * mc, median_floor_std * std_p)
        if abs(med_s - med_p) > tol:
            report.append(
                f"{name}: median {med_s:.4g} vs pinned {med_p:.4g} — "
                f"|diff| {abs(med_s - med_p):.4g} > tol {tol:.4g} "
                f"({n_sigma} sigma MC, floor {median_floor_std} sd)")
        ratio = std_s / std_p if std_p > 0 else float("inf")
        # a pinned parameter may carry its own measured band: the width
        # of a heavy-tailed marginal (P_0 against the curved gNFW
        # degeneracy) varies 0.66-1.17x across CONVERGED runs — the
        # sample std converges far more slowly than the median there,
        # and a one-size band would flake (fixture _provenance notes
        # the measured per-run spread the overrides derive from)
        band = tuple(p.get("width_band", width_ratio_band))
        if not (band[0] <= ratio <= band[1]):
            report.append(
                f"{name}: posterior width ratio {ratio:.3f} outside "
                f"{band} (std {std_s:.4g} vs pinned "
                f"{std_p:.4g})")
    return (not report), report

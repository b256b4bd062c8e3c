"""The six reference figure sets as PDFs (matplotlib, imported only when
a figure is drawn)."""

from .figures import (
    traceplot, cornerplot, fit_on_data, radial_profiles, mass_plot,
    gas_fraction_plot,
)

__all__ = [
    "traceplot", "cornerplot", "fit_on_data", "radial_profiles",
    "mass_plot", "gas_fraction_plot",
]

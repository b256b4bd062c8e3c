from .fitsio import read_fits, find_hdu
from .readers import (
    read_xy,
    read_beam_profile,
    read_transfer_function,
    read_conversion_table,
    load_band,
    annuli_edges_arcmin,
    BandData,
)

__all__ = [
    "read_fits", "find_hdu", "read_xy", "read_beam_profile",
    "read_transfer_function", "read_conversion_table", "load_band",
    "annuli_edges_arcmin", "BandData",
]

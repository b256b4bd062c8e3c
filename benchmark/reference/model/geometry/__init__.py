from .grids import (
    centered_distance_matrix,
    radial_freq_matrix,
    signed_radius_axis,
    MapGeometry,
    build_map_geometry,
)
from .beam import build_beam
from .transfer import build_filter_image
from .annuli import Annuli, projection_volume_matrix

__all__ = [
    "centered_distance_matrix", "radial_freq_matrix", "signed_radius_axis",
    "MapGeometry", "build_map_geometry", "build_beam", "build_filter_image",
    "Annuli", "projection_volume_matrix",
]

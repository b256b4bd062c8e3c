"""Host-side operator builders and the CUDA kernels with their plain
torch versions (``joint_kernel``, ``step_kernel``).

The package exports the host builders only: the kernel modules import
``sampling``, whose modules import ``models``, which import these
builders, so exporting a kernel module here would close that cycle."""

from .abel import forward_abel_matrix, forward_abel
from .splines import interp_matrix, mirrored_interp_matrix, lerp_lookup
from .szkernel import (
    sz_map_pipeline,
    build_sz_operator,
    SZOperator,
    compton_y_prefactor,
)

__all__ = [
    "forward_abel_matrix", "forward_abel", "interp_matrix",
    "mirrored_interp_matrix", "lerp_lookup", "sz_map_pipeline",
    "build_sz_operator", "SZOperator", "compton_y_prefactor",
]

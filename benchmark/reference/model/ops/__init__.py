from .abel import forward_abel_matrix, forward_abel
from .splines import interp_matrix, mirrored_interp_matrix, lerp_lookup
from .szkernel import build_sz_operator, SZOperator

__all__ = ["forward_abel_matrix", "forward_abel", "interp_matrix",
           "mirrored_interp_matrix", "lerp_lookup", "build_sz_operator",
           "SZOperator"]

"""The reference's products, in float64 or, for the control, as a float32
GEMM with TF32 inputs (10 explicit mantissa bits, rounded to nearest
even), the precision a later change would be tempted to give the
projections on the tensor cores."""

from __future__ import annotations

import torch

# set by ``reference.control``: every product of the model takes TF32
# inputs (the operands are float32 then)
TF32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, with TF32 inputs where ``TF32`` is set."""
    if TF32:
        return tf32(a) @ tf32(b)
    return a @ b

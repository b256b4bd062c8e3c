"""Device choice for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises when no GPU is visible —
there is no quiet fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without a
    GPU); ``"cpu"`` -> the CPU, only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--cpu on the "
            "command line) to run the plain-torch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

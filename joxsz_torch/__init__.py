"""JoXSZ on PyTorch and CUDA: joint SZ + X-ray galaxy-cluster profile fits.

The port of ``joxsz_tpu`` to an NVIDIA H100.  Host setup is numpy/scipy,
the reference likelihood is plain torch (``models``), and the sampling hot
path runs through hand-written CUDA kernels (``ops``, sources in
``csrc/``).  Entry point: ``python -m joxsz_torch.run``.
"""

__version__ = "0.1.0"

from . import constants
from .cosmology import Cosmology

__all__ = ["constants", "Cosmology", "__version__"]

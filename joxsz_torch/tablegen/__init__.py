"""Count-rate table generation (``joxsz_tpu/tablegen``): the analytic
spectral model on the device, the XSPEC driver and the importer of a
reference-stack XSPEC cache."""

from .generate import (SPECTRAL_MODEL_VERSION, TableSpec, generate_table,
                       save_table)

__all__ = ["SPECTRAL_MODEL_VERSION", "TableSpec", "generate_table",
           "save_table"]

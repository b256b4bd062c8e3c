from .mesh import Mesh, make_mesh, on_device, scatter, gather, all_gather
from .sharded import run_sharded_ensemble, run_multi_cluster
from .kernel_sharded import (
    run_sharded_kernel_ensembles, run_sharded_tempered_ensembles,
    run_coupled_sharded_ensemble, run_hybrid_coupled_ensemble,
    make_sharded_multicluster_step,
)

__all__ = [
    "Mesh", "make_mesh", "on_device", "scatter", "gather", "all_gather",
    "run_sharded_ensemble", "run_multi_cluster",
    "run_sharded_kernel_ensembles", "run_sharded_tempered_ensembles",
    "run_coupled_sharded_ensemble", "run_hybrid_coupled_ensemble",
    "make_sharded_multicluster_step",
]

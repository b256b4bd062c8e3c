from .mesh import (Mesh, RemoteShard, make_mesh, on_device, scatter, gather,
                   all_gather, local_blocks)
from .sharded import run_sharded_ensemble, run_multi_cluster
from .kernel_sharded import (
    run_sharded_kernel_ensembles, run_sharded_tempered_ensembles,
    run_coupled_sharded_ensemble, run_hybrid_coupled_ensemble,
    make_sharded_multicluster_step,
)
from .multihost import (
    initialize as initialize_multihost, global_mesh, replicated_to_global,
    local_block, run_multihost_multi_cluster,
    make_multihost_multicluster_step,
)

__all__ = [
    "Mesh", "RemoteShard", "make_mesh", "on_device", "scatter", "gather",
    "all_gather", "local_blocks",
    "run_sharded_ensemble", "run_multi_cluster",
    "run_sharded_kernel_ensembles", "run_sharded_tempered_ensembles",
    "run_coupled_sharded_ensemble", "run_hybrid_coupled_ensemble",
    "make_sharded_multicluster_step",
    "initialize_multihost", "global_mesh", "replicated_to_global",
    "local_block", "run_multihost_multi_cluster",
    "make_multihost_multicluster_step",
]

"""Worker pools, job meshes, placement rules, the activation-sharding
context and lockstep SPMD over a mesh's workers, of the port."""
from repro_torch.parallel import spmd
from repro_torch.parallel.context import (ACT_RULES, bind, constrain,
                                          get_context, sharding_context,
                                          suspend_sharding_context)
from repro_torch.parallel.mesh import (JobMesh, Placement, factor_mesh,
                                       logical_workers, make_job_mesh)
from repro_torch.parallel.spmd import (all_gather, all_to_all, axis_index,
                                       axis_size, each, gather_split, pmean,
                                       psum, shard_map)

__all__ = ["spmd", "ACT_RULES", "bind", "constrain", "get_context",
           "sharding_context", "suspend_sharding_context", "JobMesh",
           "Placement", "factor_mesh", "logical_workers", "make_job_mesh",
           "all_gather", "all_to_all", "axis_index", "axis_size", "each",
           "gather_split", "pmean", "psum", "shard_map"]

from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              constrain, current_mesh,
                                              logical_to_spec, mesh_context,
                                              named_sharding, spec_for_axes)
from repro_torch.distributed import compression

__all__ = ["DEFAULT_RULES", "ShardingRules", "constrain", "current_mesh",
           "logical_to_spec", "mesh_context", "named_sharding",
           "spec_for_axes", "compression"]

"""Sharding rules and DTensor annotations, compressed all-reduce and GPipe
over ``torch.distributed``. Port of ``src/repro/distributed/``."""
from repro_torch.distributed.compression import (EFState, compressed_all_reduce,
                                                 compression_ratio,
                                                 init_ef_state)
from repro_torch.distributed.pipeline_parallel import (gpipe_apply,
                                                       make_pipelined_fn,
                                                       pipeline_bubble_fraction)
from repro_torch.distributed.sharding import (PartitionSpec, axis_rules,
                                              axis_size, current_mesh, lshard,
                                              make_rules, named_sharding,
                                              rules_for_config, serving_rules,
                                              shard_map, shard_params,
                                              spec_placements, to_placements,
                                              to_pspec, tree_pspecs,
                                              tree_shardings)

__all__ = [
    "axis_rules", "lshard", "make_rules", "named_sharding",
    "rules_for_config", "to_pspec", "tree_pspecs", "tree_shardings",
    "PartitionSpec", "axis_size", "current_mesh", "serving_rules",
    "shard_map", "shard_params", "spec_placements", "to_placements",
    "EFState", "compressed_all_reduce", "compression_ratio", "init_ef_state",
    "gpipe_apply", "make_pipelined_fn", "pipeline_bubble_fraction",
]

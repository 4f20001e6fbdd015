"""Device groups, meshes and sharding rules (``sharding``), the
single-process collectives and the activation-sharding context (``ctx``):
the sharded and replicated ANN serving paths and the ZeRO-3 data-parallel
training path."""
from .ctx import (activation_sharding, all_gather, gathered, psum,
                  shard_act, whole)
from .sharding import (Mesh, NamedSharding, Sharded, batch_axes,
                       cache_shardings, census, data_mesh, data_positions,
                       fsdp_rule, generic_param_shardings, host_mesh,
                       lm_param_shardings, lti_lane_specs, place_batch,
                       place_lti_lane, place_tree, replica_groups,
                       replica_mesh, shard, shard_tree, shardings_of,
                       spec_for, table_sharding, to_full)

__all__ = ["Mesh", "NamedSharding", "Sharded", "activation_sharding",
           "all_gather", "batch_axes", "cache_shardings", "census",
           "data_mesh", "data_positions", "fsdp_rule", "gathered",
           "generic_param_shardings", "host_mesh", "lm_param_shardings",
           "lti_lane_specs", "place_batch", "place_lti_lane", "place_tree",
           "psum", "replica_groups", "replica_mesh", "shard", "shard_act",
           "shard_tree", "shardings_of", "spec_for", "table_sharding",
           "to_full", "whole"]

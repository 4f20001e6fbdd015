"""Device groups (``sharding``) and the single-process collectives
(``ctx``) of the sharded and replicated ANN serving paths."""
from .ctx import all_gather, psum
from .sharding import (census, data_mesh, lti_lane_specs, place_lti_lane,
                       replica_groups, replica_mesh)

__all__ = ["all_gather", "census", "data_mesh", "lti_lane_specs",
           "place_lti_lane", "psum", "replica_groups", "replica_mesh"]

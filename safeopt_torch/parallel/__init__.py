"""Several cards and campaign fleets: device meshes, grid and state
placement (``sharding.py``; a ``DTensor`` grid runs the step, the safe
maximum, the full expander sets and the certified functions of
``sharded_step.py``) and campaign fleets on one card or split over a
mesh axis (``campaigns.py``)."""

from .campaigns import (run_safeopt_campaigns, run_swarmopt_campaigns,
                        shard_campaigns, stack_campaign_states)
from .sharding import (DCN_AXIS, GRID_AXIS, MODEL_AXIS, make_hier_mesh,
                       make_mesh, replicate, shard_grid, shard_state)

__all__ = ["make_mesh", "make_hier_mesh", "shard_grid", "shard_state",
           "replicate", "GRID_AXIS", "MODEL_AXIS", "DCN_AXIS",
           "stack_campaign_states", "shard_campaigns",
           "run_safeopt_campaigns", "run_swarmopt_campaigns"]

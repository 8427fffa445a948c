"""Campaign fleets on one card (``campaigns.py``); grid and state
sharding over several cards is still to come (ROADMAP Queue 1 [16b])."""

from .campaigns import (run_safeopt_campaigns, run_swarmopt_campaigns,
                        shard_campaigns, stack_campaign_states)

__all__ = ["stack_campaign_states", "shard_campaigns",
           "run_safeopt_campaigns", "run_swarmopt_campaigns"]

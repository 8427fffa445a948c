"""Optimization algorithms of the PyTorch port: the exact-grid SafeOpt
and the swarm-based SafeOptSwarm, their asynchronous steps and lag-1
campaigns. The device-side loops (``run_safeopt_loop``,
``run_swarmopt_loop``, which also run the campaign fleets of
``safeopt_torch.parallel``) live in ``algorithms.runner``."""

from .base import GaussianProcessOptimization
from .pipeline import run_lagged_campaign
from .safe_opt import PendingSafeOptStep, SafeOpt
from .swarm import SwarmOptimization
from .swarm_opt import PendingSwarmIteration, SafeOptSwarm

__all__ = ["GaussianProcessOptimization", "SafeOpt", "PendingSafeOptStep",
           "SafeOptSwarm", "PendingSwarmIteration", "SwarmOptimization",
           "run_lagged_campaign"]

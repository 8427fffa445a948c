"""Optimization algorithms of the PyTorch port: the exact-grid SafeOpt,
its asynchronous steps and lag-1 campaigns. The device-side loop
(``run_safeopt_loop``) lives in ``algorithms.runner``."""

from .base import GaussianProcessOptimization
from .pipeline import run_lagged_campaign
from .safe_opt import PendingSafeOptStep, SafeOpt

__all__ = ["GaussianProcessOptimization", "SafeOpt", "PendingSafeOptStep",
           "run_lagged_campaign"]

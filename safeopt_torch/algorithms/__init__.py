"""Optimization algorithms of the PyTorch port (exact-grid SafeOpt)."""

from .base import GaussianProcessOptimization
from .safe_opt import SafeOpt

__all__ = ["GaussianProcessOptimization", "SafeOpt"]

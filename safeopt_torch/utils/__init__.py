"""Utilities of the PyTorch port."""

from .grids import linearly_spaced_combinations
from .observability import IterationStats, StatsRecorder

__all__ = ["linearly_spaced_combinations", "IterationStats",
           "StatsRecorder"]

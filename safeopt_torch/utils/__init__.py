"""Utilities of the PyTorch port: grid construction, GP-prior sampling,
plotting, checkpointing (``checkpoint``), deployment through
``torch.export`` and observability."""

from .deployment import (export_campaign, export_step,
                         export_swarm_campaign, load_step)
from .grids import linearly_spaced_combinations
from .observability import IterationStats, StatsRecorder, profile_trace
from .plotting import plot_2d_gp, plot_3d_gp, plot_contour_gp
from .sampling import sample_gp_function

__all__ = ["linearly_spaced_combinations", "sample_gp_function",
           "plot_2d_gp", "plot_3d_gp", "plot_contour_gp",
           "export_step", "load_step", "export_campaign",
           "export_swarm_campaign", "IterationStats", "StatsRecorder",
           "profile_trace"]

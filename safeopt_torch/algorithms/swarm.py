"""Generic constrained swarm optimization (public API component).

Counterpart of ``safeopt_tpu/algorithms/swarm.py:29-124``: the
reference's ``SwarmOptimization`` surface (swarm.py:17-146) — ``c1``/
``c2``, ``velocity_scale``, ``max_velocity``, ``init_swarm(positions)``,
``run_swarm(max_iter)`` and the ``positions``/``velocities``/
``best_positions``/``best_values``/``global_best`` attributes — over
``swarm_core.swarm_scan``. The fitness is any torch callable
``(S, d) -> (values, safe)``; the randomness comes from an explicit
``torch.Generator`` instead of the reference's global NumPy RNG.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import default_dtype
from .swarm_core import make_uniform_stream, swarm_scan

__all__ = ["SwarmOptimization"]


class SwarmOptimization:
    """Constrained particle swarm optimization.

    Parameters
    ----------
    swarm_size : int
        Number of particles.
    velocity : array (d,)
        Base velocity per dimension (sets both the initial velocity
        scale and the max velocity = 10x).
    fitness : callable
        ``positions (S, d) -> (values (S,), safe (S,) bool)`` on torch
        tensors of the swarm's device and dtype.
    bounds : list of (min, max), optional
        Exploration box per dimension.
    generator : torch.Generator, optional
        Randomness source; ``seed`` seeds a new one on ``device`` when
        it is None (seed 0 by default).
    device : str or torch.device
        Where the particles live: the card (``'cuda'``, the default)
        unless the caller asks for ``'cpu'``.
    dtype : torch.dtype, optional
        Defaults to ``config.default_dtype(device)``.
    """

    def __init__(self, swarm_size: int, velocity, fitness: Callable,
                 bounds=None, generator: Optional[torch.Generator] = None,
                 seed: int = 0, device="cuda", dtype=None):
        self.c1 = self.c2 = 1.0
        self.fitness = fitness

        self.bounds = None
        if bounds is not None:
            self.bounds = np.asarray(bounds, dtype=float)

        self.initial_inertia = 1.0
        self.final_inertia = 0.1
        self.velocity_scale = np.asarray(velocity, dtype=float)

        self.ndim = len(self.velocity_scale)
        self.swarm_size = swarm_size
        self.device = torch.device(device)
        self.dtype = dtype if dtype is not None else default_dtype(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self._generator = generator

        self.positions = torch.zeros((swarm_size, self.ndim),
                                     dtype=self.dtype, device=self.device)
        self.velocities = torch.zeros_like(self.positions)
        self.best_positions = torch.zeros_like(self.positions)
        self.best_values = torch.zeros((swarm_size,), dtype=self.dtype,
                                       device=self.device)
        self.global_best = None

    @property
    def max_velocity(self) -> np.ndarray:
        """Maximum allowed particle velocity (10x the base velocity)."""
        return 10.0 * self.velocity_scale

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def init_swarm(self, positions, velocities=None) -> None:
        """Set initial positions; draw velocities ~ U[0,1)*scale.

        Matches reference swarm.py:66-84 (initial bests are seeded from
        the first fitness evaluation regardless of safety).
        """
        self.positions = self._tensor(positions)
        if velocities is None:
            u = torch.rand((self.swarm_size, self.ndim),
                           generator=self._generator, dtype=self.dtype,
                           device=self._generator.device)
            velocities = u.to(self.device) * self._tensor(
                self.velocity_scale)
        self.velocities = self._tensor(velocities)

        values, _ = self.fitness(self.positions)
        self.best_positions = self.positions
        self.best_values = self._tensor(values)
        self.global_best = self.best_positions[torch.argmax(values)]

    def run_swarm(self, max_iter: int, r_stream=None) -> None:
        """Explore for ``max_iter`` iterations.

        ``r_stream`` overrides the uniform randomness (parity testing).
        """
        if r_stream is None:
            r_stream = make_uniform_stream(self._generator, max_iter,
                                           self.swarm_size, self.ndim,
                                           self.dtype, self.device)
        else:
            r_stream = self._tensor(r_stream)

        result = swarm_scan(
            self.fitness, self.positions, self.velocities, r_stream,
            self._tensor(self.velocity_scale),
            None if self.bounds is None else self._tensor(self.bounds),
            c1=self.c1, c2=self.c2,
            initial_inertia=self.initial_inertia,
            final_inertia=self.final_inertia)

        self.positions = result.positions
        self.velocities = result.velocities
        self.best_positions = result.best_positions
        self.best_values = result.best_values
        self.global_best = result.global_best

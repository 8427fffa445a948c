"""Constrained particle-swarm optimization over a uniform stream.

Counterpart of ``safeopt_tpu/algorithms/swarm_core.py:36-110``. The JAX
package runs a swarm as one ``lax.scan``; here ``swarm_scan`` is a Python
loop over the ``(max_iter, 2, swarm_size, d)`` stream of fixed-shape
tensor operations with no host read, so that the fused SafeOptSwarm
iteration around it can be captured as one CUDA graph
(``swarm_opt_fused.FusedSwarmGraph``). Traced (``torch.export``, an
exported swarm campaign), the same iteration runs under one ``scan``,
so that the program holds it once, not ``max_iter`` times.

The reference's order is kept exactly (reference swarm.py:61-143):

- ``v <- inertia * v + (c1 r1 (best_self - x) + c2 r2 (global - x)) /
  velocity_scale``, r1, r2 ~ U[0, 1); the inertia is annealed linearly
  from 1.0 to 0.1 *after* the velocity update;
- the velocity is clipped to +-10 velocity_scale, then the positions to
  the bounds;
- a particle's best moves only when its new value improves AND it is
  safe; the initial bests are seeded from the first fitness regardless
  of safety;
- ``global_best = best_positions[argmax(best_values)]``, the first
  maximum (``torch.argmax`` returns the first).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["SwarmRunResult", "swarm_scan", "make_uniform_stream"]


class SwarmRunResult(NamedTuple):
    """Device-side outputs of one full constrained-PSO run."""

    positions: torch.Tensor        # (S, d) final particle positions
    velocities: torch.Tensor       # (S, d) final velocities
    best_positions: torch.Tensor   # (S, d) per-particle best positions
    best_values: torch.Tensor      # (S,) per-particle best values
    global_best: torch.Tensor      # (d,) best position overall


def make_uniform_stream(generator: torch.Generator, max_iter: int,
                        swarm_size: int, ndim: int, dtype,
                        device=None) -> torch.Tensor:
    """U[0,1) stream shaped (max_iter, 2, swarm_size, ndim) for one run,
    drawn from ``generator`` on its own device and moved to ``device``
    (the generator's when None)."""
    r = torch.rand((max_iter, 2, swarm_size, ndim), generator=generator,
                   dtype=dtype, device=generator.device)
    return r if device is None else r.to(device)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a device scalar) of ``x`` without a host read."""
    return x.index_select(0, i.reshape(1))[0]


def swarm_scan(fitness: Callable, positions: torch.Tensor,
               velocities: torch.Tensor, r_stream: torch.Tensor,
               velocity_scale: torch.Tensor,
               bounds: Optional[torch.Tensor] = None,
               c1: float = 1.0, c2: float = 1.0,
               initial_inertia: float = 1.0,
               final_inertia: float = 0.1) -> SwarmRunResult:
    """Run a full constrained-PSO exploration.

    Parameters
    ----------
    fitness : callable (S, d) -> (values (S,), safe (S,) bool)
        Fixed-shape torch code: it runs once per iteration.
    positions, velocities : (S, d)
        Initial particle state (velocities are the caller's draw of
        U[0,1) * velocity_scale, reference swarm.py:75-76).
    r_stream : (max_iter, 2, S, d)
        Per-iteration uniform randomness (r1 = [, 0], r2 = [, 1]).
    velocity_scale : (d,)
        Base per-dimension velocity; the max velocity is 10x this.
    bounds : (d, 2) or None
        Position clip box.
    """
    max_iter = r_stream.shape[0]
    max_velocity = 10.0 * velocity_scale
    inertia_step = (final_inertia - initial_inertia) / max_iter
    inertias, inertia = [], initial_inertia
    for _ in range(max_iter):
        inertias.append(inertia)
        inertia = inertia + inertia_step

    def one(carry, step):
        x, v, bp, bv, gb = carry
        r, inertia = step
        v = inertia * v + (c1 * r[0] * (bp - x) + c2 * r[1] * (gb - x)) \
            / velocity_scale
        v = torch.clamp(v, -max_velocity, max_velocity)

        x = x + v
        if bounds is not None:
            x = torch.clamp(x, bounds[:, 0], bounds[:, 1])

        values, safe = fitness(x)
        improved = (values > bv) & safe
        bv = torch.where(improved, values, bv)
        bp = torch.where(improved[:, None], x, bp)
        return (x, v, bp, bv, _row(bp, torch.argmax(bv))), ()

    values0, _ = fitness(positions)
    carry = (positions, velocities, positions.clone(), values0,
             _row(positions, torch.argmax(values0)))
    if torch.compiler.is_compiling():
        # traced (an exported swarm campaign): one scan, not max_iter
        # copies of the iteration; the same arithmetic, the inertia a
        # tensor of the values the loop below multiplies by
        from torch._higher_order_ops.scan import scan

        carry, _ = scan(one, carry, (r_stream, torch.tensor(
            inertias, dtype=r_stream.dtype, device=r_stream.device)))
    else:
        for it in range(max_iter):
            carry, _ = one(carry, (r_stream[it], inertias[it]))
    x, v, bp, bv, gb = carry
    return SwarmRunResult(positions=x, velocities=v, best_positions=bp,
                          best_values=bv, global_best=gb)

"""Campaign fleets: K independent SafeOpt or SafeOptSwarm campaigns as
one batched program on one card.

Counterpart of ``safeopt_tpu/parallel/campaigns.py``. Multi-seed
ensembles, hyperparameter sweeps and per-robot tuning fleets run K
campaigns of one problem: their states stack along a leading campaign
axis (``stack_campaign_states``), and the loops of
``algorithms/runner.py`` run such batched states together, as the JAX
package runs ``jax.vmap`` of its loops. A SafeOpt fleet step launches K1 once per family-and-capacity
group for all K G GPs and K3 once per walk round for every campaign still
walking (``algorithms/fleet_core.py``); a swarm fleet step is the fused
iteration under ``torch.func.vmap``, on the card one replay of one CUDA
graph. The fleets run on the states' device: the card, unless the
caller built the states on the CPU.

Torch cannot reproduce threefry: in place of the JAX package's ``keys``
and ``it_keys`` the fleets take the noise, (K, n_iter, G) normals, and
the swarm's uniform streams, (K, n_iter, U), or a ``torch.Generator``
drawn once in that shape. Placing campaigns on several cards
(``shard_campaigns``, ``mesh=``) waits for the sharding slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..algorithms.runner import run_safeopt_loop, run_swarmopt_loop

__all__ = ["stack_campaign_states", "shard_campaigns",
           "run_safeopt_campaigns", "run_swarmopt_campaigns"]

_SHARDING = ("placing campaigns on several cards waits for grid and state "
             "sharding (ROADMAP Queue 1 item [16b])")


def _stack(leaves):
    first = leaves[0]
    if isinstance(first, torch.Tensor):
        shapes = sorted({tuple(t.shape) for t in leaves})
        if len(shapes) != 1:
            raise ValueError(f"campaigns differ in shape {shapes}: every "
                             "campaign must share capacities (pad them to "
                             "a common capacity first)")
        return torch.stack(leaves)
    if isinstance(first, tuple):
        parts = [_stack(items) for items in zip(*leaves)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    raise TypeError(f"cannot stack {type(first).__name__} leaves")


def stack_campaign_states(per_campaign: Sequence):
    """Stack per-campaign state tuples into batched states.

    ``per_campaign`` is a sequence (length K) of per-GP state tuples as
    the loops take them (or of ``SwarmIterState``); returns one such
    structure whose every tensor has a leading campaign axis of size K.
    All campaigns must share capacities."""
    per_campaign = list(per_campaign)
    if not per_campaign:
        raise ValueError("a fleet needs at least one campaign")
    return _stack(per_campaign)


def _check_batched(states, what: str):
    """Raise unless every GP's state has a leading campaign axis."""
    if any(st.X.dim() != 3 for st in states):
        raise ValueError(f"{what} takes batched states (a leading campaign "
                         "axis: stack_campaign_states)")


def shard_campaigns(tree, mesh, axis: str = "data"):
    """Not yet: see ``_SHARDING``."""
    raise NotImplementedError(_SHARDING)


def run_safeopt_campaigns(kernels, states_batch, grid, fmin, beta, scaling,
                          threshold, noise=None, *, objectives, n_iter: int,
                          mesh=None, objective_args_batch=None,
                          **loop_kwargs):
    """Run K independent on-device SafeOpt campaigns as one program.

    ``states_batch`` carries a leading campaign axis
    (``stack_campaign_states`` of float64 ``factor_state()`` tuples);
    ``noise`` is (K, n_iter, G) standard normals or a generator. The
    grid, kernels and scalar settings are shared.
    ``objective_args_batch`` (leading axis K) makes the fleet
    heterogeneous: campaign k's objectives are ``f_i(x, args[k])``.
    ``loop_kwargs`` are ``runner.run_safeopt_loop``'s (``dtype``,
    ``noise_std``, ``chunk``, ``ucb``, ``contexts``, ``betas``, ...).

    Returns a ``BOLoopResult`` whose tensors have the leading campaign
    axis (``host_syncs``: per fleet step).
    """
    if mesh is not None:
        raise NotImplementedError(_SHARDING)
    _check_batched(states_batch, "run_safeopt_campaigns")
    return run_safeopt_loop(kernels, states_batch, grid, fmin, beta,
                            scaling, threshold, noise, objectives=objectives,
                            n_iter=n_iter,
                            objective_args=objective_args_batch,
                            **loop_kwargs)


def run_swarmopt_campaigns(kernels, states_batch, iter_states,
                           velocity_scale, bounds, fmin, scaling, threshold,
                           betas, greedy0s, blb0s, streams, noise=None, *,
                           objectives, n_iter: int, swarm_size: int,
                           max_iters: int, mesh=None,
                           objective_args_batch=None, **loop_kwargs):
    """Run K independent on-device SafeOptSwarm campaigns as one program.

    The swarm analog of ``run_safeopt_campaigns``: ``states_batch``,
    ``iter_states`` (the device safe-set buffers), ``greedy0s`` (K, d),
    ``blb0s`` (K,), ``streams`` (K, n_iter, U) and ``noise`` (K, n_iter,
    G) carry the campaign axis (each stream may be a generator);
    ``betas`` (n_iter,) and the remaining constants are shared.
    ``loop_kwargs`` are ``runner.run_swarmopt_loop``'s (``noise_std``,
    ``ucb``, ``graph``, ``graph_cache``).

    Returns a ``SwarmLoopResult`` with the leading campaign axis.
    """
    if mesh is not None:
        raise NotImplementedError(_SHARDING)
    _check_batched(states_batch, "run_swarmopt_campaigns")
    return run_swarmopt_loop(kernels, states_batch, iter_states,
                             velocity_scale, bounds, fmin, scaling,
                             threshold, betas, greedy0s, blb0s, streams,
                             noise, objectives=objectives, n_iter=n_iter,
                             swarm_size=swarm_size, max_iters=max_iters,
                             objective_args=objective_args_batch,
                             **loop_kwargs)

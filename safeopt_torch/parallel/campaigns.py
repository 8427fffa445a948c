"""Campaign fleets: K independent SafeOpt or SafeOptSwarm campaigns as
one batched program on one card.

Counterpart of ``safeopt_tpu/parallel/campaigns.py``. Multi-seed
ensembles, hyperparameter sweeps and per-robot tuning fleets run K
campaigns of one problem: their states stack along a leading campaign
axis (``stack_campaign_states``), and the loops of
``algorithms/runner.py`` run such batched states together, as the JAX
package runs ``jax.vmap`` of its loops. A SafeOpt fleet step launches K1
once per family-and-capacity group for all K G GPs and K3 once per walk
round for every campaign still walking (``algorithms/fleet_core.py``); a
swarm fleet step is the fused iteration under ``torch.func.vmap``, on the
card one replay of one CUDA graph. The fleets run on the states' device:
the card, unless the caller built the states on the CPU.

Torch cannot reproduce threefry: in place of the JAX package's ``keys``
and ``it_keys`` the fleets take the noise, (K, n_iter, G) normals, and
the swarm's uniform streams, (K, n_iter, U), or a ``torch.Generator``
drawn once in that shape.

Over a device mesh (``sharding.make_mesh``, ``make_hier_mesh``) the
campaign axis splits over one mesh axis (``mesh=``, ``axis=``): each rank
runs its own campaigns with the one-card fleet code above (one K1 launch
and one K3 launch a walk round for its campaigns, the swarm's one graph
a step), and no rank talks to another inside the loop. Every rank is
given the whole fleet's inputs (the generators drawn whole, then
sliced, so that each campaign sees the draws it sees on one card) and
returns the whole fleet as ``DTensor``s split over the campaign axis.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..algorithms.runner import (_noise, _per_iteration, run_safeopt_loop,
                                 run_swarmopt_loop)
from .sharding import (GRID_AXIS, _place, _placements, _shard_index,
                       map_tensors)

__all__ = ["stack_campaign_states", "shard_campaigns",
           "run_safeopt_campaigns", "run_swarmopt_campaigns"]


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


def _check_axis(mesh, axis: str) -> None:
    names = getattr(mesh, "mesh_dim_names", None)
    if not names or axis not in names:
        raise ValueError(f"campaigns shard over a named axis of a device "
                         f"mesh; {axis!r} is not one of {names}")


def _split(mesh, axis: str, K: int):
    """``(index, rows)``: this rank's block of the K campaigns over
    ``mesh[axis]``; ``ValueError`` unless the axis size divides K."""
    _check_axis(mesh, axis)
    index, size = _shard_index(mesh, (axis,))
    if K % size:
        raise ValueError(f"{K} campaigns do not split evenly over the "
                         f"{size} ranks of mesh axis {axis!r}")
    return index, K // size


def shard_campaigns(tree, mesh, axis: str = GRID_AXIS):
    """Every tensor leaf of a batched campaign tree (leading axis K, the
    same on every rank) as a ``DTensor`` whose campaign axis is split over
    ``mesh[axis]`` and replicated over the other axes (JAX
    ``campaigns.py:45-70``). ``ValueError`` unless the axis size divides
    K."""
    _check_axis(mesh, axis)

    def place(leaf):
        _split(mesh, axis, leaf.shape[0])
        return _place(leaf, mesh, (axis,))
    return map_tensors(tree, place)


def _mine(tree, mesh, axis: str, K: int):
    """This rank's campaigns of every tensor leaf: a ``DTensor`` placed by
    ``shard_campaigns`` gives its local block, a whole tensor its slice."""
    from torch.distributed.tensor import DTensor

    index, rows = _split(mesh, axis, K)

    def take(leaf):
        if isinstance(leaf, DTensor):
            return leaf.to_local()
        return leaf[index * rows:(index + 1) * rows]
    return map_tensors(tree, take)


def _whole(tree, mesh, axis: str, fields):
    """The named campaign-axis ``fields`` of a result as ``DTensor``s split
    over ``mesh[axis]`` (this rank's campaigns local), on the device of
    its queries: a field the loop keeps on the host (``walk_chunks``)
    moves there, so that a collective over the mesh can gather it."""
    from torch.distributed.tensor import DTensor

    placements = _placements(mesh, (axis,))
    device = tree.xs.device

    def wrap(leaf):
        return DTensor.from_local(leaf.to(device).contiguous(), mesh,
                                  placements, run_check=False)
    return tree._replace(**{f: map_tensors(getattr(tree, f), wrap)
                            for f in fields})


def _args(tree):
    """``objective_args_batch`` with NumPy leaves as tensors, so that they
    slice and place as the states do."""
    if isinstance(tree, dict):
        return {k: _args(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_args(v) for v in tree)
    return torch.as_tensor(tree) if tree is not None else None


def run_safeopt_campaigns(kernels, states_batch, grid, fmin, beta, scaling,
                          threshold, noise=None, *, objectives, n_iter: int,
                          mesh=None, axis: str = GRID_AXIS,
                          objective_args_batch=None, **loop_kwargs):
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

    With ``mesh`` given, the campaigns split over ``mesh[axis]`` (its
    size must divide K): this rank runs its block of them, and the
    result's campaign-axis tensors are ``DTensor``s over that axis on the
    queries' device (``walk_chunks`` too; ``host_syncs`` this rank's, on
    the host).
    """
    _check_batched(states_batch, "run_safeopt_campaigns")
    if mesh is None:
        return run_safeopt_loop(kernels, states_batch, grid, fmin, beta,
                                scaling, threshold, noise,
                                objectives=objectives, n_iter=n_iter,
                                objective_args=objective_args_batch,
                                **loop_kwargs)
    K = states_batch[0].X.shape[0]
    if noise is not None:
        noise = _noise(noise, (K, int(n_iter), len(kernels)),
                       loop_kwargs.get("noise_std", 0.0), grid.device)
    res = run_safeopt_loop(
        kernels, _mine(tuple(states_batch), mesh, axis, K), grid, fmin, beta,
        scaling, threshold, _mine(noise, mesh, axis, K),
        objectives=objectives, n_iter=n_iter,
        objective_args=_mine(_args(objective_args_batch), mesh, axis, K),
        **loop_kwargs)
    return _whole(res, mesh, axis, ("states", "xs", "ys", "next_idx",
                                    "safe_counts", "has_safe",
                                    "walk_chunks"))


def run_swarmopt_campaigns(kernels, states_batch, iter_states,
                           velocity_scale, bounds, fmin, scaling, threshold,
                           betas, greedy0s, blb0s, streams, noise=None, *,
                           objectives, n_iter: int, swarm_size: int,
                           max_iters: int, mesh=None, axis: str = GRID_AXIS,
                           objective_args_batch=None, **loop_kwargs):
    """Run K independent on-device SafeOptSwarm campaigns as one program.

    The swarm analog of ``run_safeopt_campaigns``: ``states_batch``,
    ``iter_states`` (the device safe-set buffers), ``greedy0s`` (K, d),
    ``blb0s`` (K,), ``streams`` (K, n_iter, U) and ``noise`` (K, n_iter,
    G) carry the campaign axis (each stream may be a generator);
    ``betas`` (n_iter,) and the remaining constants are shared.
    ``loop_kwargs`` are ``runner.run_swarmopt_loop``'s (``noise_std``,
    ``ucb``, ``graph``, ``graph_cache``).

    Returns a ``SwarmLoopResult`` with the leading campaign axis; with
    ``mesh`` given, split over ``mesh[axis]`` as in
    ``run_safeopt_campaigns``.
    """
    _check_batched(states_batch, "run_swarmopt_campaigns")
    kw = dict(objectives=objectives, n_iter=n_iter, swarm_size=swarm_size,
              max_iters=max_iters, **loop_kwargs)
    if mesh is None:
        return run_swarmopt_loop(kernels, states_batch, iter_states,
                                 velocity_scale, bounds, fmin, scaling,
                                 threshold, betas, greedy0s, blb0s, streams,
                                 noise, objective_args=objective_args_batch,
                                 **kw)
    from ..algorithms.swarm_opt_fused import stream_layout

    K, S = states_batch[0].X.shape[0], iter_states.S
    layout = stream_layout(swarm_size, max_iters, S.shape[-1],
                           loop_kwargs.get("ucb", False))
    n_u = sum(int(np.prod(shape)) for _, shape in layout)
    streams = _per_iteration(streams, (K, int(n_iter), n_u), S.dtype,
                             S.device, "streams")
    if noise is not None:
        noise = _noise(noise, (K, int(n_iter), len(kernels)),
                       loop_kwargs.get("noise_std", 0.0), S.device)
    mine = lambda tree: _mine(tree, mesh, axis, K)  # noqa: E731
    res = run_swarmopt_loop(
        kernels, mine(tuple(states_batch)), mine(iter_states),
        velocity_scale, bounds, fmin, scaling, threshold, betas,
        mine(torch.as_tensor(greedy0s)), mine(torch.as_tensor(blb0s)),
        mine(streams), mine(noise),
        objective_args=mine(_args(objective_args_batch)), **kw)
    return _whole(res, mesh, axis, ("states", "iter_state", "xs", "ys",
                                    "best_lower_bounds", "safe_counts",
                                    "num_safe_min"))

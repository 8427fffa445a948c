"""SafeOpt and SafeOptSwarm loops whose objective runs on the device.

Counterpart of ``safeopt_tpu/algorithms/runner.py:43-242``
(``run_safeopt_loop``, ``run_swarmopt_loop``). Where the objective can be
computed on the card (a simulation, a surrogate, a benchmark function),
the whole loop stays there: every SafeOpt iteration writes the context
columns into the grid, runs ``safeopt_step``, gathers the query,
evaluates the objectives, adds the noise and appends the observation to
each GP's float64 factor with
``gp_append``, writing the one changed row into the step's mirror — no
NumPy and no host factor between iterations.

What differs from the JAX package's single compiled ``lax.scan``: the
step's expander walk reads its candidate count and each chunk's flag on
the host (a walk on the device is still to come), so an iteration is not
free of host syncs; ``BOLoopResult.host_syncs`` counts them per
iteration. Torch cannot reproduce threefry, so the noise is an explicit
``(n_iter, G)`` tensor of standard normals, or drawn once before the
loop from a ``torch.Generator``: a prefix of the stream resumes a run
exactly, as the JAX package's ``it_keys`` do. The device decides the
kernels (there is no ``use_pallas``).

``run_swarmopt_loop`` has no such walk: each iteration is the fused swarm
iteration (on the card one replay of its CUDA graph), the objectives,
the noise and ``gp_append``, and no iteration reads the device from the
host. Its uniforms come as a per-iteration tensor or a generator, as the
SafeOpt loop's noise does.

Both loops also run K independent campaigns at once
(``parallel/campaigns.py``, the JAX package's ``jax.vmap`` of these
loops): states with a leading campaign axis make the iteration one fleet
step (``fleet_core.fleet_step``: one K1 launch per group for every
campaign, one K3 launch per walk round; for the swarm the fused iteration
under ``torch.func.vmap``, on the card one replay of one CUDA graph), the
objectives evaluated per campaign and ``gp_append`` under
``torch.func.vmap`` over the campaigns.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..gp.regression import GPState, gp_append
from ..utils.observability import host_syncs
from .fleet_core import fleet_step
from .safe_opt_core import safeopt_step, traced_safeopt_step

__all__ = ["BOLoopResult", "run_safeopt_loop", "SwarmLoopResult",
           "run_swarmopt_loop"]


class BOLoopResult(NamedTuple):
    """Trajectory of a device-side SafeOpt run (tensors on the grid's
    device, ``host_syncs`` and ``walk_chunks`` on the host)."""

    states: Tuple            # final per-GP float64 states (count grown)
    xs: torch.Tensor         # (T, d) queried points, float64
    ys: torch.Tensor         # (T, G) observations fed to the GPs, float64
    next_idx: torch.Tensor   # (T,) chosen grid indices
    safe_counts: torch.Tensor  # (T,) |S| per iteration
    has_safe: torch.Tensor   # (T,) bool: all True on a healthy run
    host_syncs: torch.Tensor  # (T,) host reads of device values per step
    walk_chunks: torch.Tensor  # (T,) candidate chunks the walk tested


def _mirror(state: GPState, dtype) -> GPState:
    """The step's copy of a float64 state in ``dtype`` (a cast, as
    ``GPRegression`` casts its host factor). It never aliases ``state``:
    the loop writes each appended row into it in place."""
    return GPState(*(t.to(dtype, copy=True) if t.is_floating_point()
                     else t.clone() for t in state))


def _write_row(mirror: GPState, state: GPState, pos: torch.Tensor) -> None:
    """Write row ``pos`` (a device index) of the float64 ``state`` into
    ``mirror`` in place, cast to its dtype, and its count: the rows that
    ``gp/regression._device_row_update`` writes from the host factor."""
    at = pos.reshape(1)
    for name in ("X", "Y", "L", "Linv", "w"):
        dst = getattr(mirror, name)
        dst.index_copy_(0, at, getattr(state, name).index_select(0, at)
                        .to(dst.dtype))
    mirror.count.copy_(state.count)


def _write_rows(mirror: GPState, state: GPState, pos: torch.Tensor) -> None:
    """``_write_row`` for batched states: row ``pos[k]`` (a device index
    per campaign) of campaign k of ``state`` into ``mirror``, in place."""
    at = (torch.arange(pos.shape[0], device=pos.device), pos)
    for name in ("X", "Y", "L", "Linv", "w"):
        dst = getattr(mirror, name)
        dst[at] = getattr(state, name)[at].to(dst.dtype)
    mirror.count.copy_(state.count)


def _append(kernels, states, mirrors, x, y):
    """Append the observation ``(x, y[i])`` to GP i with ``gp_append`` and
    write the new row into its mirror; returns the grown states. For a
    fleet (x (K, d), y (K, G)) campaign k's ``(x[k], y[k, i])``, with
    ``gp_append`` under ``torch.func.vmap`` over the campaigns."""
    fleet = x.dim() == 2
    append = (torch.func.vmap(gp_append, in_dims=(None, 0, 0, 0)) if fleet
              else gp_append)
    write = _write_rows if fleet else _write_row
    new = []
    for i, (kern, st) in enumerate(zip(kernels, states)):
        grown = append(kern, st, x, y[..., i])
        write(mirrors[i], grown, st.count)
        new.append(grown)
    return tuple(new)


def _campaign_args(args, k: int):
    """Campaign k's slice of a fleet's ``objective_args`` (a tensor or
    array with a leading campaign axis, or a tuple, list or dict of
    them)."""
    if isinstance(args, dict):
        return {name: _campaign_args(a, k) for name, a in args.items()}
    if isinstance(args, (tuple, list)):
        return type(args)(_campaign_args(a, k) for a in args)
    return args[k]


def _evaluate(objectives, x, args):
    """(G,) float64 measurements ``f_i(x)`` (or ``f_i(x, args)``); for a
    fleet's x (K, d) the (K, G) ``f_i(x[k], args_k)``, ``args_k`` campaign
    k's slice of ``args``."""
    if x.dim() == 2:
        return torch.stack([_evaluate(objectives, x[k], None if args is None
                                      else _campaign_args(args, k))
                            for k in range(x.shape[0])])
    extra = () if args is None else (args,)
    return torch.stack([f(x, *extra).to(torch.float64).reshape(())
                        for f in objectives])


def _check_float64(states, what: str):
    """Raise unless the states are float64 factor states."""
    if any(st.X.dtype != torch.float64 for st in states):
        raise TypeError(f"{what} takes float64 factor states "
                        "(GPRegression.factor_state()): the factor math "
                        "stays in float64")


def _noise(noise, shape, noise_std: float, device) -> torch.Tensor:
    """The measurement noise's standard normals of ``shape``, from a tensor
    or a generator (drawn once, before the loop); zeros for None, when
    ``noise_std`` must be 0."""
    if noise is None:
        if noise_std:
            raise ValueError("noise_std needs a noise tensor or generator")
        return torch.zeros(shape, dtype=torch.float64, device=device)
    return _per_iteration(noise, shape, torch.float64, device, "noise")


def run_safeopt_loop(kernels, states, grid, fmin, beta, scaling, threshold,
                     noise=None, *, objectives: Tuple[Callable, ...],
                     n_iter: int, dtype: Optional[torch.dtype] = None,
                     lipschitz=None, noise_std: float = 0.0,
                     ucb: bool = False, use_lipschitz: bool = False,
                     chunk: int = 64, objective_args=None, contexts=None,
                     betas=None) -> BOLoopResult:
    """Run ``n_iter`` complete SafeOpt iterations on the grid's device.

    Parameters
    ----------
    kernels : tuple of Kernel
    states : tuple of GPState
        Float64 factor states on the grid's device
        (``GPRegression.factor_state()``); their capacity must admit
        ``n_iter`` more rows. They are not modified: the loop returns
        the grown states. With a leading campaign axis K
        (``parallel.stack_campaign_states``) they are a fleet: see below.
    grid : tensor (N, d)
        Candidate inputs, context columns last. Queries and objectives
        take its values in float64.
    fmin, scaling, threshold : tensors (G,) on the grid's device
    beta : float
        Confidence scale; ``betas`` (n_iter,) overrides it per iteration
        (the reference's ``beta(t)``, computed by the caller).
    noise : tensor (n_iter, G) or torch.Generator, optional
        Standard normals scaled by ``noise_std`` and added to the
        measurements; with a generator they are drawn once, before the
        loop; None draws none (``noise_std`` must then be 0). A fleet's
        is (K, n_iter, G).
    objectives : tuple of callables, one per GP
        ``f_i(x)`` (or ``f_i(x, objective_args)``) of a float64 (d,)
        tensor on the device, returning a scalar tensor; the first is
        the objective, the rest the safety measurements. They receive
        the context columns too.
    dtype : torch.dtype, optional
        The step's dtype (default: the grid's): the grid and a mirror of
        each state are cast to it once; each append writes its one row
        into the mirror.
    contexts : (n_iter, num_contexts), optional
        Iteration t writes ``contexts[t]`` into the grid's trailing
        columns before its step.

    Every other argument is ``safeopt_step``'s. As in the JAX package, an
    emptied safe set does not stop the loop: ``has_safe`` records where
    certification was lost, and the caller must check it.

    A fleet's iteration is one ``fleet_step`` (campaign k's decisions are
    ``safeopt_step``'s on its own states; grid, kernels, thresholds,
    betas and contexts are shared, as the JAX package's vmapped loop
    shares them), the K queries gathered, the objectives evaluated per
    campaign (with a leading axis K, ``objective_args`` makes the fleet
    heterogeneous: campaign k's are ``f_i(x, args_k)``) and the
    observations appended with ``gp_append`` under ``torch.func.vmap``.
    Its result's tensors have the leading campaign axis, except
    ``host_syncs`` (T,), the host reads of each fleet step.
    """
    n_iter = int(n_iter)
    _check_float64(states, "run_safeopt_loop")
    check_capacity(states, n_iter)
    lead = tuple(states[0].X.shape[:-2])        # (K,) for a fleet, else ()
    beta_stream = ([float(beta)] * n_iter if betas is None
                   else [float(b) for b in betas])
    return safeopt_loop(
        fleet_step if lead else safeopt_step, kernels, states, grid, fmin,
        beta_stream, scaling, threshold, noise, objectives=objectives,
        n_iter=n_iter, dtype=dtype, lipschitz=lipschitz, noise_std=noise_std,
        ucb=ucb, use_lipschitz=use_lipschitz, chunk=chunk,
        objective_args=objective_args, contexts=contexts)


def check_capacity(states, n_iter: int) -> None:
    """Raise unless every state's capacity admits ``n_iter`` more rows
    (one host read of the counts)."""
    counts = torch.stack([st.count.reshape(-1).amax()
                          for st in states]).tolist()
    caps = [st.X.shape[-2] for st in states]
    if any(c + n_iter > cap for c, cap in zip(counts, caps)):
        raise ValueError(f"capacities {caps} do not admit {n_iter} more "
                         f"rows past {counts}")


def safeopt_loop(step, kernels, states, grid, fmin, beta_stream, scaling,
                 threshold, noise, *, objectives, n_iter: int, dtype=None,
                 lipschitz=None, noise_std: float = 0.0, ucb: bool = False,
                 use_lipschitz: bool = False, chunk: int = 64,
                 objective_args=None, contexts=None) -> BOLoopResult:
    """The body of ``run_safeopt_loop`` with its ``step`` and its list of
    per-iteration betas given: ``safeopt_step`` (``fleet_step`` for a
    fleet) and floats there; ``safe_opt_core.traced_safeopt_step`` and
    0-d tensors in the campaign that ``utils/deployment.export_campaign``
    traces, whose ``host_syncs`` are the walk's ``while_loop`` reads, as
    0-d tensors: PyTorch's eager ``while_loop`` reads its condition once
    before the loop, once before each round and once after the last."""
    G = len(kernels)
    dev = grid.device
    dtype = grid.dtype if dtype is None else dtype
    lead = tuple(states[0].X.shape[:-2])        # (K,) for a fleet, else ()
    traced = step is traced_safeopt_step
    noise = _noise(noise, lead + (n_iter, G), noise_std, dev)
    nc = 0 if contexts is None else int(
        torch.as_tensor(contexts).reshape(n_iter, -1).shape[1])

    grid64 = grid.to(torch.float64).clone()
    step_grid = grid.to(dtype).clone()
    if nc:
        contexts = torch.as_tensor(contexts, dtype=torch.float64,
                                   device=dev).reshape(n_iter, nc)
    states = tuple(states)
    mirrors = tuple(_mirror(st, dtype) for st in states)
    xs, ys, idxs, safe, has, syncs, chunks = ([] for _ in range(7))
    for t in range(n_iter):
        before = host_syncs.count
        if nc:
            grid64[:, -nc:] = contexts[t]
            step_grid[:, -nc:] = contexts[t].to(dtype)
        res = step(kernels, mirrors, step_grid, fmin, beta_stream[t],
                   scaling, threshold, lipschitz, ucb=ucb,
                   use_lipschitz=use_lipschitz, chunk=chunk)
        x = grid64.index_select(0, res.next_idx.reshape(-1))   # (K, d)
        x = x if lead else x[0]
        y = _evaluate(objectives, x, objective_args)
        y = y + noise_std * noise[..., t, :]
        states = _append(kernels, states, mirrors, x, y)
        xs.append(x)
        ys.append(y)
        idxs.append(res.next_idx)
        safe.append(res.safe_count)
        has.append(res.has_safe)
        syncs.append(res.walk_chunks + (0 if ucb else 2) if traced
                     else host_syncs.count - before)
        chunks.append(res.walk_chunks)
    at = len(lead)
    stack = torch.stack if traced else torch.tensor
    return BOLoopResult(
        states=states, xs=torch.stack(xs, dim=at),
        ys=torch.stack(ys, dim=at), next_idx=torch.stack(idxs, dim=at),
        safe_counts=torch.stack(safe, dim=at),
        has_safe=torch.stack(has, dim=at), host_syncs=stack(syncs),
        walk_chunks=stack(chunks).movedim(0, -1))


class SwarmLoopResult(NamedTuple):
    """Trajectory of a device-side SafeOptSwarm run (tensors on the
    device, ``host_syncs`` on the host)."""

    states: Tuple            # final per-GP float64 states (count grown)
    iter_state: object       # final SwarmIterState (device safe set)
    xs: torch.Tensor         # (T, d) queried points, float64
    ys: torch.Tensor         # (T, G) observations fed to the GPs, float64
    best_lower_bounds: torch.Tensor  # (T,)
    safe_counts: torch.Tensor  # (T,) |S| after each iteration
    num_safe_min: torch.Tensor  # (T,) min per-phase safe count (0 = lost)
    host_syncs: torch.Tensor   # (T,) host reads of device values per step


def _per_iteration(source, shape, dtype, device, what):
    """A (n_iter, ...) tensor of ``what`` from a tensor or, drawn once,
    from a ``torch.Generator`` (uniform for the streams, normal for the
    noise), on ``device`` without a blocking copy."""
    from .swarm_opt import _ship

    if isinstance(source, torch.Generator):
        draw = torch.rand if what == "streams" else torch.randn
        source = draw(shape, generator=source, dtype=dtype,
                      device=source.device)
    source = _ship(source, dtype, device)
    if tuple(source.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(source.shape)}, want "
                         f"{tuple(shape)}")
    return source


def _swarm_pack(st0: GPState, beta, blb, greedy, dtype) -> torch.Tensor:
    """The fused iteration's scalar pack: beta, the best lower bound, the
    greedy swarm's special particles (the most recent and the best
    observation, read from the first GP's float64 rows on the device) and
    the greedy point; (K, P) for batched states, else (P,)."""
    lead = st0.X.shape[:-2]
    X = st0.X.reshape(-1, *st0.X.shape[-2:])
    Y = st0.Y.reshape(-1, *st0.Y.shape[-2:])
    cnt = st0.count.reshape(-1)
    K, cap = X.shape[:2]
    ar = torch.arange(K, device=X.device)
    last_x = X[ar, cnt - 1]
    y_col = torch.where(torch.arange(cap, device=X.device) < cnt[:, None],
                        Y[:, :, 0], float("-inf"))
    best_x = X[ar, torch.argmax(y_col, dim=1)]
    head = torch.stack([beta.expand(K), blb.reshape(K)], dim=1)
    pack = torch.cat([head, last_x.to(dtype), best_x.to(dtype),
                      greedy.reshape(K, -1)], dim=1)
    return pack.reshape(*lead, -1)


def run_swarmopt_loop(kernels, states, iter_state, velocity_scale, bounds,
                      fmin, scaling, threshold, betas, greedy0, blb0,
                      streams, noise=None, *,
                      objectives: Tuple[Callable, ...], n_iter: int,
                      swarm_size: int, max_iters: int,
                      noise_std: float = 0.0, ucb: bool = False,
                      objective_args=None, graph: Optional[bool] = None,
                      graph_cache: Optional[dict] = None) -> SwarmLoopResult:
    """Run ``n_iter`` complete SafeOptSwarm iterations on the device.

    The swarm analog of ``run_safeopt_loop``: every iteration runs the
    fused swarm iteration (``swarm_opt_fused``; on the card one replay of
    its CUDA graph, captured at the first iteration unless
    ``graph_cache`` holds it), evaluates the
    objectives at its query, adds the noise and appends the observation
    to each GP's float64 factor with ``gp_append``, writing the one
    changed row into the step's mirror. No iteration reads the device
    from the host (``host_syncs`` records 0 for each).

    Parameters
    ----------
    kernels : tuple of Kernel
    states : tuple of GPState
        Float64 factor states on the device
        (``GPRegression.factor_state()``), with room for ``n_iter`` more
        rows. They are not modified: the loop returns the grown states.
    iter_state : SwarmIterState
        The device safe-set buffer, in the step's dtype; size it for the
        whole run (``count + 2 * swarm_size * n_iter`` rows is always
        enough: growth stops silently at the buffer's capacity).
    velocity_scale, bounds, fmin, scaling, threshold :
        The fused iteration's constants (``SafeOptSwarm``'s
        ``optimal_velocities``, its bounds, thresholds, scalings).
    betas : (n_iter,) array
        Per-iteration confidence scale (``beta(t)`` computed by the
        caller; t advances by one observation per iteration).
    greedy0, blb0 : (d,) array, scalar
        The initial greedy estimate and best lower bound.
    streams : tensor (n_iter, U) or torch.Generator
        Each iteration's uniforms, flat in ``stream_layout``'s order (U
        its total size); with a generator they are drawn once, before
        the loop.
    noise : tensor (n_iter, G) or torch.Generator, optional
        Standard normals scaled by ``noise_std`` and added to the
        measurements; None draws none (``noise_std`` must then be 0).
    objectives : tuple of callables, one per GP
        ``f_i(x)`` (or ``f_i(x, objective_args)``) of a float64 (d,)
        tensor on the device, returning a scalar tensor.
    graph : bool, optional
        Replay the fused iteration as a CUDA graph (the default on the
        card; the CPU runs it eagerly).
    graph_cache : dict, optional
        Keeps the captured graphs across calls (by ``graph_key``), so that
        a resumed or repeated loop replays its graph instead of capturing
        it again.

    A fleet of K campaigns: ``states`` (each GP's fields), ``iter_state``,
    ``greedy0`` (K, d) and ``blb0`` (K,) with a leading campaign axis,
    ``streams`` (K, n_iter, U) and ``noise`` (K, n_iter, G) (or
    generators drawn once in those shapes), ``objective_args`` per
    campaign as in ``run_safeopt_loop``; ``betas`` and the constants are
    shared. Each iteration then runs ``fleet_swarm_optimize`` (on the card
    one replay of one CUDA graph for the whole fleet; a capture that fails
    raises), and the result's tensors have the leading campaign axis,
    except ``host_syncs`` (T,).

    Exact GPs only: the greedy swarm's special particles (the most
    recent and the best observation) are read from the float64 states'
    padded X/Y rows, which hold inducing points for sparse models. As in
    the JAX package an emptied safe set does not stop the loop:
    ``num_safe_min`` records any certification loss, and the caller must
    check it.
    """
    from .swarm_opt import _ship, device_kernel
    from .swarm_opt_fused import (FusedSwarmGraph, SwarmIterState,
                                  fleet_swarm_optimize, fused_swarm_optimize,
                                  graph_key, split_streams, stream_layout)

    n_iter = int(n_iter)
    G = len(kernels)
    dev = iter_state.S.device
    dtype = iter_state.S.dtype
    lead = tuple(iter_state.S.shape[:-2])       # (K,) for a fleet, else ()
    d = iter_state.S.shape[-1]
    _check_float64(states, "run_swarmopt_loop")
    if tuple(states[0].X.shape[:-2]) != lead:
        raise ValueError(f"GP states of campaign axes "
                         f"{tuple(states[0].X.shape[:-2])}, safe-set buffers "
                         f"of {lead}")
    step = fleet_swarm_optimize if lead else fused_swarm_optimize
    if graph is None:
        graph = dev.type == "cuda"
    layout = stream_layout(swarm_size, max_iters, d, ucb)
    n_u = sum(int(np.prod(shape)) for _, shape in layout)
    streams = _per_iteration(streams, lead + (n_iter, n_u), dtype, dev,
                             "streams")
    noise = _noise(noise, lead + (n_iter, G), noise_std, dev)
    betas = _ship(betas if torch.is_tensor(betas)
                  else np.asarray(betas, dtype=float), dtype,
                  dev).reshape(n_iter)
    consts = [_ship(a, dtype, dev) for a in (velocity_scale, bounds, fmin,
                                              scaling, threshold)]
    step_kernels = tuple(device_kernel(k, dtype, dev) for k in kernels)
    kernels64 = tuple(device_kernel(k, torch.float64, dev) for k in kernels)
    states = tuple(states)
    mirrors = tuple(_mirror(st, dtype) for st in states)
    sstate = SwarmIterState(*iter_state)
    greedy = _ship(greedy0, dtype, dev).reshape(*lead, d)
    blb = _ship(blb0, dtype, dev).reshape(lead)
    kw = dict(swarm_size=swarm_size, max_iters=max_iters, ucb=ucb)
    graphs = {} if graph_cache is None else graph_cache
    xs, ys, blbs, counts, ns_min, syncs = ([] for _ in range(6))
    for t in range(n_iter):
        before = host_syncs.count
        pack = _swarm_pack(states[0], betas[t], blb, greedy, dtype)
        args = (step_kernels, mirrors, sstate,
                split_streams(streams[..., t, :], layout), *consts, pack)
        if not graph:
            out = step(*args, **kw)
        else:
            key = graph_key(*args[:3], **kw)
            if key not in graphs:
                graphs[key] = FusedSwarmGraph(*args, **kw)
            out = graphs[key].replay(*args)

        x = out.x_next.to(torch.float64)                   # (K, d) or (d,)
        y = _evaluate(objectives, x, objective_args)
        y = y + noise_std * noise[..., t, :]
        states = _append(kernels64, states, mirrors, x, y)
        sstate, greedy, blb = out.state, out.state.greedy, \
            out.best_lower_bound
        xs.append(x)
        ys.append(y)
        blbs.append(out.best_lower_bound)
        counts.append(out.state.count)
        ns_min.append(torch.amin(out.num_safe, dim=-1))
        syncs.append(host_syncs.count - before)
    at = len(lead)
    return SwarmLoopResult(
        states=states, iter_state=sstate, xs=torch.stack(xs, dim=at),
        ys=torch.stack(ys, dim=at),
        best_lower_bounds=torch.stack(blbs, dim=at),
        safe_counts=torch.stack(counts, dim=at),
        num_safe_min=torch.stack(ns_min, dim=at),
        host_syncs=torch.tensor(syncs))

"""SafeOpt loops whose objective runs on the device.

Counterpart of ``safeopt_tpu/algorithms/runner.py:43-136``
(``run_safeopt_loop``). Where the objective can be computed on the card
(a simulation, a surrogate, a benchmark function), the whole loop stays
there: every iteration writes the context columns into the grid, runs
``safeopt_step``, gathers the query, evaluates the objectives, adds the
noise and appends the observation to each GP's float64 factor with
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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..gp.regression import GPState, gp_append
from ..utils.observability import host_syncs
from .safe_opt_core import safeopt_step

__all__ = ["BOLoopResult", "run_safeopt_loop"]


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
    ``GPRegression`` casts its host factor)."""
    return GPState(*(t.to(dtype) if t.is_floating_point() else t.clone()
                     for t in state))


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
        the grown states.
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
        loop; None draws none (``noise_std`` must then be 0).
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
    """
    n_iter = int(n_iter)
    G = len(kernels)
    dev = grid.device
    dtype = grid.dtype if dtype is None else dtype
    if any(st.X.dtype != torch.float64 for st in states):
        raise TypeError("run_safeopt_loop takes float64 factor states "
                        "(GPRegression.factor_state()): the factor math "
                        "stays in float64")
    counts = torch.stack([st.count for st in states]).tolist()  # once
    if any(c + n_iter > st.capacity for c, st in zip(counts, states)):
        raise ValueError(f"capacities {[st.capacity for st in states]} do "
                         f"not admit {n_iter} more rows past {counts}")
    if isinstance(noise, torch.Generator):
        noise = torch.randn((n_iter, G), generator=noise,
                            dtype=torch.float64).to(dev)
    elif noise is None:
        if noise_std:
            raise ValueError("noise_std needs a noise tensor or generator")
        noise = torch.zeros((n_iter, G), dtype=torch.float64, device=dev)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float64, device=dev)
    beta_stream = ([float(beta)] * n_iter if betas is None
                   else [float(b) for b in betas])
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
        res = safeopt_step(kernels, mirrors, step_grid, fmin,
                           beta_stream[t], scaling, threshold, lipschitz,
                           ucb=ucb, use_lipschitz=use_lipschitz, chunk=chunk)
        x = grid64.index_select(0, res.next_idx.reshape(1))[0]    # (d,)
        y = torch.stack([(f(x) if objective_args is None
                          else f(x, objective_args)).to(torch.float64)
                         .reshape(()) for f in objectives])
        y = y + noise_std * noise[t]
        new = []
        for i, (kern, st) in enumerate(zip(kernels, states)):
            grown = gp_append(kern, st, x, y[i])
            _write_row(mirrors[i], grown, st.count)
            new.append(grown)
        states = tuple(new)
        xs.append(x)
        ys.append(y)
        idxs.append(res.next_idx)
        safe.append(res.safe_count)
        has.append(res.has_safe)
        syncs.append(host_syncs.count - before)
        chunks.append(res.walk_chunks)
    return BOLoopResult(
        states=states, xs=torch.stack(xs), ys=torch.stack(ys),
        next_idx=torch.stack(idxs), safe_counts=torch.stack(safe),
        has_safe=torch.stack(has), host_syncs=torch.tensor(syncs),
        walk_chunks=torch.tensor(chunks))

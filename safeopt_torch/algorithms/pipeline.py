"""Lag-1 (delayed-feedback) campaigns, blocking or pipelined.

Counterpart of ``safeopt_tpu/algorithms/pipeline.py``. Where the plant
allows pipelined queries — query t is evaluated while the optimizer
already computes query t+1 — the loop becomes the lag-1 variant in which
x[t+1] is chosen from the observations up to t-1. ``run_lagged_campaign``
runs it, for ``SafeOptSwarm`` and the grid ``SafeOpt``, either

* ``pipelined=False``: every ``optimize()`` finishes before the next
  dispatch (the semantic reference); or
* ``pipelined=True``: ``optimize_async`` dispatches iteration t+1 before
  iteration t's result is read, so that the diagnostics' copy to the host
  and the plant's evaluation overlap the next step. The swarm chains
  iteration t+1 on iteration t's in-flight device state
  (``SafeOptSwarm._fused_args_after``: its safe-set buffer, best lower
  bound and greedy point); the grid algorithm needs no chain (its only
  inter-iteration dependence is the GP data, entering on the host).

Both make the same calls in the same order and return bitwise-identical
queries and observations. The swarm's safe-set buffer is reserved for
the whole campaign in both modes (``SafeOptSwarm.reserve``), so that
both run the fused iteration, and its CUDA graph, at the same shapes;
the JAX package reserves it in the pipelined mode only. The plain
zero-lag loop cannot be pipelined without changing the algorithm
(x[t+1] depends on y[t]), so the lag is explicit here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["run_lagged_campaign"]


def run_lagged_campaign(opt, objective: Callable[[np.ndarray], float],
                        n_iter: int, pipelined: bool = True,
                        ucb: bool = False):
    """Run a lag-1 campaign; returns ``(xs, ys)``.

    Parameters
    ----------
    opt : SafeOptSwarm or SafeOpt
        The optimizer (its GPs accumulate the data).
    objective : callable
        The plant: ``y = objective(x)``, a scalar for one GP or a
        length-G vector (one column per model, NaN to skip one, as
        ``add_new_data_point`` takes it), called once per query in query
        order.
    n_iter : int
        Number of queries.
    pipelined : bool
        Dispatch iteration t+1 before reading iteration t's result (the
        same trajectory either way).
    """
    n_iter = int(n_iter)
    xs, ys = [], []
    if n_iter <= 0:
        return np.asarray(xs), np.asarray(ys)

    if hasattr(opt, "reserve"):          # the swarm's device buffer
        opt.reserve(n_iter)
    if pipelined:
        pending = opt.optimize_async(ucb=ucb)
        for t in range(n_iter):
            nxt = (opt.optimize_async(ucb=ucb, after=pending)
                   if t + 1 < n_iter else None)
            x = pending.result()
            y = np.asarray(objective(x), dtype=float)
            xs.append(x)
            ys.append(y)
            # y[t] enters the model now and reaches x[t+2]'s dispatch
            opt.add_new_data_point(x, y)
            pending = nxt
    else:
        x = opt.optimize(ucb=ucb)
        for t in range(n_iter):
            nxt = opt.optimize(ucb=ucb) if t + 1 < n_iter else None
            y = np.asarray(objective(x), dtype=float)
            xs.append(x)
            ys.append(y)
            opt.add_new_data_point(x, y)
            x = nxt
    return np.asarray(xs), np.asarray(ys)

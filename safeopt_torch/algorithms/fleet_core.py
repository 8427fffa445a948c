"""The campaign-batched SafeOpt step: K campaigns over one grid.

Counterpart of ``jax.vmap(safeopt_step)``, the step of
``safeopt_tpu/parallel/campaigns.py:74-119``. K independent campaigns
share the grid, the kernels and the scalar settings; each has its own
GP states (a leading campaign axis on every field, as
``parallel.stack_campaign_states`` builds them). ``fleet_step`` gives
every campaign exactly the decisions of ``safe_opt_core.safeopt_step`` on
its own states:

1. **Intervals.** The K G GPs fall into ``_gp_groups``'s groups (the
   kernels and the capacities are the campaigns' common ones), and one K1
   launch covers a family-and-capacity group for every campaign
   (``fused_posterior.fleet_interval_operands``: one stack per field). GPs
   on the ``'plan'`` (K2/K4) and ``'eager'`` routes run per campaign, as
   in the solo step.
2. **Classification and selection** are ``_classify`` and
   ``_select_query`` under ``torch.func.vmap`` over the campaign axis:
   strict ``l > fmin``, the first maximum.
3. **The walk, in lock step.** Each campaign keeps
   ``_find_first_expander``'s semantics: its own visit order (width
   descending, the larger index first on ties: one stable sort of the
   ``(K, N)`` flipped key, no host read), its own chunks, its own first
   hit. Round r tests, for every campaign still walking, its r-th chunk;
   one K3 launch per group tests them all, each against its own unsafe
   mask (``fused_expander``'s ``(R, N)`` mask), with the candidate terms
   built batched over those campaigns (``fleet_expander_operands``). The
   host reads the candidate counts once and the campaigns' hit flags once
   a round; a campaign that hits or runs out of candidates drops out.
   A round's chunk is as wide as its widest campaign's; the narrower
   campaigns' extra slots are invalid and never hit.

Host syncs per step: 1 + the walk's rounds (``host_syncs``).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..gp.regression import GPState
from ..ops.fused_expander import (fleet_expander_operands, fused_expander,
                                  fused_expander_predicate_single)
from ..ops.fused_posterior import (fleet_interval_operands, fused_intervals,
                                   fused_intervals_single)
from ..utils.observability import host_syncs
from .safe_opt_core import (_NINF, _classify, _eager_posterior,
                            _eager_predicate, _gp_groups, _select_query)

__all__ = ["FleetStepResult", "fleet_step", "campaign_states",
           "campaign_count"]


class FleetStepResult(NamedTuple):
    """Outputs of one fleet step (tensors on the grid's device with a
    leading campaign axis; ``walk_chunks`` and ``walk_rounds`` on the
    host)."""

    Q: torch.Tensor          # (K, N, 2G) confidence intervals
    S: torch.Tensor          # (K, N) safe sets
    M: torch.Tensor          # (K, N) maximizers
    G: torch.Tensor          # (K, N) expanders (<= 1 True per campaign)
    next_idx: torch.Tensor   # (K,) next query indices
    has_safe: torch.Tensor   # (K,) bool
    safe_count: torch.Tensor  # (K,)
    walk_chunks: List[int]   # per campaign: chunks its walk tested
    walk_rounds: int         # K3 rounds of the step (the longest walk)


def campaign_count(states) -> int:
    """K of batched states (a tuple of per-GP ``GPState`` with a leading
    campaign axis)."""
    return states[0].X.shape[0]


def campaign_states(states, k: int):
    """Campaign ``k``'s per-GP states: views of the batched states."""
    return tuple(GPState(*(t[k] for t in st)) for st in states)


def _rows(states, rows: torch.Tensor):
    """The batched states of the campaigns ``rows`` (a device index)."""
    return tuple(GPState(*(t.index_select(0, rows) for t in st))
                 for st in states)


def _index(values, device) -> torch.Tensor:
    """A host list of indices as an int64 tensor on ``device``, copied
    through pinned memory without blocking."""
    t = torch.tensor(values, dtype=torch.int64)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _fleet_posterior(kernels, states, grid, beta):
    """``(Q (K, N, 2G), mu, sigma (K, G, N), Vs)`` of every campaign, one
    K1 launch per family-and-capacity group for all of them; ``Vs[k][i]``
    the eager route's kept V of campaign k's GP i (else None)."""
    N, d = grid.shape
    K, G = campaign_count(states), len(kernels)
    rows, Vs, direct = [None] * G, [[None] * G for _ in range(K)], {}
    for idx, route in _gp_groups(kernels, campaign_states(states, 0), d):
        if route == "batched":
            out = fused_intervals(*fleet_interval_operands(
                [kernels[i] for i in idx], [states[i] for i in idx], grid,
                beta)).reshape(K, len(idx), 2, N)
            for j, i in enumerate(idx):
                rows[i] = out[:, j]
            continue
        i = idx[0]
        per = []
        for k in range(K):
            st = campaign_states(states, k)[i]
            if route == "plan":
                per.append(fused_intervals_single(kernels[i], st, grid,
                                                  beta))
                continue
            mu_k, var_k, Vs[k][i] = _eager_posterior(kernels[i], st, grid)
            sigma_k = torch.sqrt(var_k)
            per.append(torch.stack([mu_k - beta * sigma_k,
                                    mu_k + beta * sigma_k]))
            direct.setdefault(i, []).append((mu_k, sigma_k))
        rows[i] = torch.stack(per)
    out = torch.stack(rows, dim=1)                           # (K, G, 2, N)
    l, u = out[:, :, 0], out[:, :, 1]
    Q = out.permute(0, 3, 1, 2).reshape(K, N, -1)           # [l0,u0,l1,..]
    mu = (l + u) * 0.5
    sigma = (u - l) / (2.0 * beta)
    for i, per in direct.items():
        for k, (mu_k, sigma_k) in enumerate(per):
            mu[k, i], sigma[k, i] = mu_k, sigma_k
    return Q, mu, sigma, Vs


def _visit_orders(key: torch.Tensor) -> torch.Tensor:
    """(R, N) grid indices of each row in visit order: ``key`` descending,
    the larger index first on exact ties (K5's rule on the flipped key,
    as ``safe_opt_core._visit_order``), from one stable sort."""
    N = key.shape[1]
    _, ridx = torch.sort(torch.flip(key, (1,)), dim=1, descending=True,
                         stable=True)
    return N - 1 - ridx


def _round_predicate(kernels, states, grid, Q, unsafe, mu, sigma, Vs, fmin,
                     beta, lipschitz, ks, ks_dev, gidx, valid):
    """(R, C) expander predicates of one walk round: row r tests
    campaign ``ks[r]``'s candidates ``gidx[r]`` (``valid[r]`` False on the
    slots past its last candidate) against its own unsafe mask."""
    R, C = gidx.shape
    Xc = grid[gidx]                                         # (R, C, d)
    ucs = Q[ks_dev[:, None], gidx][:, :, 1::2].transpose(1, 2)  # (R, G, C)
    pred = torch.ones((R, C), dtype=torch.bool, device=grid.device)
    masks = unsafe.index_select(0, ks_dev)                  # (R, N)

    if lipschitz is None:
        for idx, route in _gp_groups(kernels, campaign_states(states, 0),
                                     grid.shape[1]):
            if route == "batched":
                preds = fused_expander(*fleet_expander_operands(
                    [kernels[i] for i in idx],
                    _rows([states[i] for i in idx], ks_dev), grid, masks,
                    mu[ks_dev][:, idx], sigma[ks_dev][:, idx], Xc,
                    ucs[:, idx], valid, beta, fmin[idx])
                ).reshape(R, len(idx), C)
            else:
                i = idx[0]
                per = []
                for r, k in enumerate(ks):
                    st = campaign_states(states, k)[i]
                    if route == "plan":
                        per.append(fused_expander_predicate_single(
                            kernels[i], st, grid, unsafe[k], mu[k, i],
                            sigma[k, i], Xc[r], ucs[r, i], valid[r], beta,
                            fmin[i]))
                    else:
                        per.append(_eager_predicate(
                            kernels[i], st, grid, unsafe[k], mu[k, i],
                            sigma[k, i], Vs[k][i], Xc[r], ucs[r, i],
                            fmin[i], beta))
                preds = torch.stack(per)[:, None]
            for j, i in enumerate(idx):
                pred &= preds[:, j] | (fmin[i] == _NINF)
    else:
        d2 = (torch.sum(Xc * Xc, dim=2)[:, :, None]
              + torch.sum(grid * grid, dim=1)[None, None, :]
              - 2.0 * (Xc @ grid.T))
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
        mindist = torch.amin(torch.where(masks[:, None, :], dist,
                                         float("inf")), dim=2)  # (R, C)
        any_unsafe = torch.any(masks, dim=1)[:, None]
        for i in range(len(kernels)):
            pred_i = any_unsafe & (ucs[:, i] - lipschitz[i] * mindist
                                   >= fmin[i])
            pred &= pred_i | (fmin[i] == _NINF)
    return pred & valid & torch.any(fmin > _NINF)


def _fleet_walk(kernels, states, grid, Q, unsafe, mu, sigma, Vs, fmin, beta,
                lipschitz, cand, width, chunk):
    """``(G (K, N), chunks per campaign, rounds)``: every campaign's first
    expander in its own visit order, the campaigns walking in lock step."""
    K, N = cand.shape
    dev = grid.device
    G = torch.zeros((K, N), dtype=torch.bool, device=dev)
    n_cand, any_unsafe = torch.stack(
        [torch.sum(cand, dim=1), torch.any(unsafe, dim=1).long()]).tolist()
    host_syncs.add()
    # with no unsafe point no candidate can lift one: the walk is void
    live = [k for k in range(K) if n_cand[k] and any_unsafe[k]]
    chunks = [0] * K
    if not live:
        return G, chunks, 0
    at = {k: r for r, k in enumerate(live)}       # row of k in `order`
    order = _visit_orders(torch.where(cand, width, _NINF)
                          .index_select(0, _index(live, dev)))
    n_dev = _index(n_cand, dev)
    pos = rounds = 0
    while live:
        C = min(chunk, max(n_cand[k] for k in live) - pos)
        ks_dev = _index(live, dev)
        gidx = order.index_select(0, _index([at[k] for k in live], dev))[
            :, pos:pos + C]
        valid = (pos + torch.arange(C, device=dev))[None, :] \
            < n_dev.index_select(0, ks_dev)[:, None]
        pred = _round_predicate(kernels, states, grid, Q, unsafe, mu, sigma,
                                Vs, fmin, beta, lipschitz, live, ks_dev,
                                gidx, valid)
        hit = torch.any(pred, dim=1)
        # the first True in visit order (argmax takes the first maximum);
        # a campaign without a hit writes False over its own all-False row
        first = torch.argmax(pred.to(torch.int32), dim=1)
        G[ks_dev, gidx[torch.arange(len(live), device=dev), first]] = hit
        hits = hit.tolist()                       # one host sync a round
        host_syncs.add()
        rounds += 1
        for k in live:
            chunks[k] += 1
        pos += chunk
        live = [k for k, h in zip(live, hits) if not h and pos < n_cand[k]]
    return G, chunks, rounds


def fleet_step(kernels, states, grid, fmin, beta: float, scaling, threshold,
               lipschitz=None, *, ucb: bool = False,
               use_lipschitz: bool = False,
               chunk: int = 64) -> FleetStepResult:
    """One SafeOpt iteration of K campaigns over one grid.

    ``states`` is a tuple of per-GP ``GPState`` whose every field has a
    leading campaign axis K (the step's mirrors, in the grid's dtype);
    ``grid`` (N, d), ``fmin``, ``scaling`` and ``threshold`` (G,) are
    shared, ``beta`` a float. Campaign k's decisions are
    ``safeopt_step``'s on ``campaign_states(states, k)``.
    """
    Q, mu, sigma, Vs = _fleet_posterior(kernels, states, grid, beta)
    S, M, cand, width, has_safe = torch.func.vmap(
        _classify, in_dims=(0, None, None, None, None))(
            Q, fmin, scaling, threshold, beta)
    K = Q.shape[0]
    if ucb:
        G = torch.zeros_like(S)
        M = torch.zeros_like(S)   # ucb never populates M/G (gp_opt.py:670)
        chunks, rounds = [0] * K, 0
    else:
        lip = lipschitz if use_lipschitz else None
        G, chunks, rounds = _fleet_walk(kernels, states, grid, Q, ~S, mu,
                                        sigma, Vs, fmin, beta, lip, cand,
                                        width, chunk)
    next_idx = torch.func.vmap(
        _select_query, in_dims=(0, 0, 0, 0, None, None))(
            Q, S, M, G, scaling, ucb)
    return FleetStepResult(Q=Q, S=S, M=M, G=G, next_idx=next_idx,
                           has_safe=has_safe, safe_count=torch.sum(S, dim=1),
                           walk_chunks=chunks, walk_rounds=rounds)

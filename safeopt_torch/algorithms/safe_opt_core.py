"""Core of the exact (grid) SafeOpt step, plain path.

Counterpart of ``safeopt_tpu/algorithms/safe_opt_core.py:68-592``. One
``safeopt_step`` runs the reference call stack optimize() ->
update_confidence_intervals -> compute_sets -> get_new_query_point:

1. **Intervals** (``ops/fused_posterior.py``): every GP's posterior
   over the grid and ``Q = mu -+ beta sigma``. GPs of one stationary
   family over every grid column share one K1 pass per capacity; every
   other GP (a Sum/Product algebra, Cosine or Bias leaves, an
   ``active_dims`` subset, as contextual SafeOpt uses) gets a K2 pass of
   its own, as the JAX package routes them (``safe_opt_core.py:189-198``).
2. **Classification**: safe set S (strict ``l > fmin`` over every GP),
   maximizers M and the expander candidates.
3. **Expander walk**: candidates are visited in the reference order —
   width descending, the larger grid index first on exact ties — a
   chunk at a time; K3 (``ops/fused_expander.py``) tests a whole chunk
   by rank-1 conditioning on a virtual observation, and the walk stops
   at the first chunk with a success (K4 for the GPs on K2). The order
   comes from the exact top-k (K5, ``ops/topk.py``) on a flipped key:
   the first chunk from a top-k of ``chunk``, and, only if the walk goes
   on, the whole order once. The JAX package's ``lax.while_loop``
   becomes a Python loop with one host sync per chunk.
4. **Selection**: masked argmax (first maximum) of the scaled width over
   M | G, or of the objective upper bound over S for safe-UCB.

Everything runs eagerly on the device of the grid; the host reads a few
scalars per step (the walk's syncs and the packed ``diag``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..ops.fused_expander import (fused_expander_predicate_batched,
                                  fused_expander_predicate_single)
from ..ops.fused_posterior import (check_kernel, fused_intervals_batched,
                                   fused_intervals_single, supports_kernel)
from ..ops.topk import top_k

__all__ = ["StepResult", "safeopt_step", "safe_maximum",
           "full_expander_sets"]

_NINF = float("-inf")


class StepResult(NamedTuple):
    """Outputs of one SafeOpt step (tensors on the grid's device)."""

    Q: torch.Tensor          # (N, 2G) confidence intervals [l0,u0,l1,u1,..]
    S: torch.Tensor          # (N,) safe set
    M: torch.Tensor          # (N,) maximizers
    G: torch.Tensor          # (N,) expanders (<=1 True unless full_sets)
    next_idx: torch.Tensor   # () index of the next query point
    has_safe: torch.Tensor   # () bool — host raises if False
    safe_count: torch.Tensor
    maximizer_count: torch.Tensor
    expander_found: torch.Tensor
    # the scalars above packed into ONE int32 buffer, so the host reads
    # them with a single device-to-host copy
    diag: torch.Tensor       # (5,) i32 [has_safe, next_idx, |S|, |M|, anyG]
    walk_chunks: int         # candidate chunks the expander walk tested


def _pack_result(Q, S, M, G, next_idx, has_safe, walk_chunks) -> StepResult:
    """Assemble a StepResult with its scalar stats and packed diag."""
    safe_count = torch.sum(S)
    maximizer_count = torch.sum(M)
    expander_found = torch.any(G)
    diag = torch.stack([has_safe.to(torch.int32),
                        next_idx.to(torch.int32),
                        safe_count.to(torch.int32),
                        maximizer_count.to(torch.int32),
                        expander_found.to(torch.int32)])
    return StepResult(Q=Q, S=S, M=M, G=G, next_idx=next_idx,
                      has_safe=has_safe, safe_count=safe_count,
                      maximizer_count=maximizer_count,
                      expander_found=expander_found, diag=diag,
                      walk_chunks=walk_chunks)


def _gp_groups(kernels, states, d: int) -> List[Tuple[List[int], bool]]:
    """``(indices, planned)`` per grid launch: the GPs K1/K3 take, one
    group per family and capacity, then every other GP alone on K2/K4
    (``planned``). Raises ``NotImplementedError`` for a kernel neither
    takes."""
    groups, batched = [], {}
    for i, (kern, st) in enumerate(zip(kernels, states)):
        check_kernel(kern, d)
        if supports_kernel(kern, d):
            key = (type(kern), st.capacity)
            if key not in batched:
                batched[key] = []
                groups.append((batched[key], False))
            batched[key].append(i)
        else:
            groups.append(([i], True))
    return groups


# ---------------------------------------------------------------------------
# confidence intervals
# ---------------------------------------------------------------------------

def _confidence_intervals(kernels, states, grid, beta):
    """``Q`` (N, 2G), plus the posterior ``mu`` and ``sigma`` (G, N)
    recovered from the interval rows for the expander pass."""
    N, d = grid.shape
    rows = [None] * len(kernels)
    for idx, planned in _gp_groups(kernels, states, d):
        if planned:
            rows[idx[0]] = fused_intervals_single(
                kernels[idx[0]], states[idx[0]], grid, beta)
            continue
        out = fused_intervals_batched([kernels[i] for i in idx],
                                      [states[i] for i in idx], grid, beta)
        for j, i in enumerate(idx):
            rows[i] = out[j]
    out = torch.stack(rows)                                  # (G, 2, N)
    l, u = out[:, 0], out[:, 1]
    Q = out.permute(2, 0, 1).reshape(N, -1)                  # [l0,u0,l1,..]
    mu = (l + u) * 0.5
    sigma = (u - l) / (2.0 * beta)
    return Q, mu, sigma


# ---------------------------------------------------------------------------
# set classification
# ---------------------------------------------------------------------------

def _classify(Q, fmin, scaling, threshold, beta):
    """S, M, the expander-candidate mask and the unscaled widths that
    order the walk (reference gp_opt.py:478-552)."""
    l = Q[:, 0::2]                                   # (N, G)
    u = Q[:, 1::2]
    widths = u - l

    S = torch.all(l > fmin, dim=1)                   # strict, like reference
    has_safe = torch.any(S)

    l0, u0 = l[:, 0], u[:, 0]
    best_l0 = torch.max(torch.where(S, l0, _NINF))
    M = S & (u0 >= best_l0)
    max_var = torch.max(torch.where(M, u0 - l0, _NINF)) / scaling[0]

    scaled_width = torch.amax(widths / scaling, dim=1)
    unscaled_width = torch.amax(widths, dim=1)
    cand = (S & ~M
            & (scaled_width > max_var)
            & torch.any(widths > threshold * beta, dim=1))

    # an empty safe set zeroes everything (gp_opt.py:504-507)
    M = M & has_safe
    cand = cand & has_safe
    return S, M, cand, unscaled_width, has_safe


# ---------------------------------------------------------------------------
# expander predicate and walk
# ---------------------------------------------------------------------------

def _chunk_expander_predicate(kernels, states, grid, Q, unsafe, mu, sigma,
                              fmin, beta, lipschitz, grid_idx):
    """(C,) expander predicate for candidate grid indices ``grid_idx``.

    GP variant (``lipschitz`` None): rank-1 conditioning on the virtual
    observation (x_cand, u_i) per constraint GP, checked against every
    unsafe grid point (gp_opt.py:577-606) — K3. Lipschitz variant:
    ``u_i - L_i * mindist(x_cand, unsafe) >= fmin_i`` (gp_opt.py:558-576).
    """
    C = grid_idx.shape[0]
    Xc = grid[grid_idx]                                     # (C, d)
    pred = torch.ones((C,), dtype=torch.bool, device=grid.device)

    if lipschitz is None:
        valid = torch.ones_like(pred)
        ucs = Q[grid_idx][:, 1::2].T                             # (G, C)
        for idx, planned in _gp_groups(kernels, states, grid.shape[1]):
            if planned:
                i = idx[0]
                preds = fused_expander_predicate_single(
                    kernels[i], states[i], grid, unsafe, mu[i], sigma[i],
                    Xc, ucs[i], valid, beta, fmin[i])[None]
            else:
                preds = fused_expander_predicate_batched(
                    [kernels[i] for i in idx], [states[i] for i in idx],
                    grid, unsafe, mu[idx], sigma[idx], Xc, ucs[idx], valid,
                    beta, fmin[idx])
            for j, i in enumerate(idx):
                pred &= preds[j] | (fmin[i] == _NINF)
    else:
        d2 = (torch.sum(Xc * Xc, dim=1)[:, None]
              + torch.sum(grid * grid, dim=1)[None, :]
              - 2.0 * (Xc @ grid.T))
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
        mindist = torch.amin(torch.where(unsafe[None, :], dist,
                                         float("inf")), dim=1)
        any_unsafe = torch.any(unsafe)
        for i in range(len(kernels)):
            uc = Q[grid_idx, 2 * i + 1]
            pred_i = any_unsafe & (uc - lipschitz[i] * mindist >= fmin[i])
            pred &= pred_i | (fmin[i] == _NINF)

    # a candidate with no constrained GP at all is never an expander
    # (gp_opt.py:547,570,602)
    return pred & torch.any(fmin > _NINF)


def _visit_order(key, count: int):
    """First ``count`` grid indices in reference visit order: ``key``
    descending, the larger index first on exact ties (an exact top-k of
    the flipped key, whose tie rule puts the lower flipped index first)."""
    N = key.shape[0]
    _, ridx = top_k(torch.flip(key, (0,)), count)
    return N - 1 - ridx


def _find_first_expander(kernels, states, grid, Q, unsafe, mu, sigma, fmin,
                         beta, lipschitz, cand, width, chunk):
    """``(G, chunks)``: G marks the first candidate in visit order whose
    predicate holds (gp_opt.py:557-612), found chunk by chunk."""
    N = grid.shape[0]
    G = torch.zeros((N,), dtype=torch.bool, device=grid.device)
    n_cand, any_unsafe = torch.stack(
        [torch.sum(cand), torch.any(unsafe).long()]).tolist()
    # With no unsafe point the predicate is false for every candidate
    # (both variants need an unsafe point to lift), so the walk is void.
    if n_cand == 0 or not any_unsafe:
        return G, 0
    key = torch.where(cand, width, _NINF)
    order = _visit_order(key, min(chunk, n_cand))
    pos = chunks = 0
    while pos < n_cand:
        if pos >= order.shape[0]:
            order = _visit_order(key, n_cand)      # once, if round 0 failed
        gidx = order[pos:pos + chunk]
        pred = _chunk_expander_predicate(kernels, states, grid, Q, unsafe,
                                         mu, sigma, fmin, beta, lipschitz,
                                         gidx)
        chunks += 1
        if bool(torch.any(pred)):                  # one host sync per chunk
            # argmax returns the first maximum: the first True in order
            G[gidx[torch.argmax(pred.to(torch.int32))]] = True
            return G, chunks
        pos += chunk
    return G, chunks


# ---------------------------------------------------------------------------
# query selection and public steps
# ---------------------------------------------------------------------------

def _select_query(Q, S, M, G, scaling, ucb: bool):
    """Masked argmax (first max in grid order, like np.argmax)."""
    if ucb:
        value = torch.where(S, Q[:, 1], _NINF)
    else:
        width = torch.amax((Q[:, 1::2] - Q[:, 0::2]) / scaling, dim=1)
        value = torch.where(M | G, width, _NINF)
    return torch.argmax(value)


def safeopt_step(kernels, states, grid, fmin, beta: float, scaling,
                 threshold, lipschitz=None, *, ucb: bool = False,
                 use_lipschitz: bool = False, chunk: int = 64) -> StepResult:
    """One full SafeOpt iteration over the candidate grid.

    ``grid`` (N, d), ``fmin``, ``scaling`` and ``threshold`` (G,) are
    tensors on one device; ``beta`` is a float.
    """
    Q, mu, sigma = _confidence_intervals(kernels, states, grid, beta)
    S, M, cand, width, has_safe = _classify(Q, fmin, scaling, threshold,
                                            beta)
    if ucb:
        G = torch.zeros_like(S)
        M = torch.zeros_like(S)   # ucb never populates M/G (gp_opt.py:670)
        chunks = 0
    else:
        lip = lipschitz if use_lipschitz else None
        G, chunks = _find_first_expander(kernels, states, grid, Q, ~S, mu,
                                         sigma, fmin, beta, lip, cand,
                                         width, chunk)
    next_idx = _select_query(Q, S, M, G, scaling, ucb)
    return _pack_result(Q, S, M, G, next_idx, has_safe, chunks)


def safe_maximum(kernels, states, grid, fmin, beta: float):
    """Best safe point by objective lower bound (gp_opt.py:677-712).

    Returns ``(idx, lower_bound, has_safe, Q, S, diag)`` with ``diag``
    packing [idx, lower_bound, has_safe] for one host read.
    """
    Q, _, _ = _confidence_intervals(kernels, states, grid, beta)
    S = torch.all(Q[:, 0::2] > fmin, dim=1)
    value = torch.where(S, Q[:, 0], _NINF)
    idx = torch.argmax(value)
    has_safe = torch.any(S)
    diag = torch.stack([idx.to(torch.float64), value[idx].to(torch.float64),
                        has_safe.to(torch.float64)])
    return idx, value[idx], has_safe, Q, S, diag


def full_expander_sets(kernels, states, grid, fmin, beta: float, scaling,
                       lipschitz=None, *, use_lipschitz: bool = False,
                       chunk: int = 64) -> StepResult:
    """Plotting variant: the expander predicate for EVERY safe point,
    with no early exit (reference ``compute_sets(full_sets=True)``,
    gp_opt.py:527-555)."""
    Q, mu, sigma = _confidence_intervals(kernels, states, grid, beta)
    l, u = Q[:, 0::2], Q[:, 1::2]
    S = torch.all(l > fmin, dim=1)
    has_safe = torch.any(S)
    best_l0 = torch.max(torch.where(S, l[:, 0], _NINF))
    M = S & (u[:, 0] >= best_l0) & has_safe

    lip = lipschitz if use_lipschitz else None
    G = torch.zeros_like(S)
    safe_idx = torch.nonzero(S).squeeze(1)
    chunks = 0
    for s in range(0, safe_idx.shape[0], chunk):
        gidx = safe_idx[s:s + chunk]
        G[gidx] = _chunk_expander_predicate(kernels, states, grid, Q, ~S,
                                            mu, sigma, fmin, beta, lip,
                                            gidx)
        chunks += 1
    G = G & has_safe
    next_idx = torch.zeros((), dtype=torch.int64, device=grid.device)
    return _pack_result(Q, S, M, G, next_idx, has_safe, chunks)

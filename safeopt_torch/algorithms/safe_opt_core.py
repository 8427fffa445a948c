"""Core of the exact (grid) SafeOpt step: the plain and certified paths.

Counterpart of ``safeopt_tpu/algorithms/safe_opt_core.py``. One
``safeopt_step`` runs the reference call stack optimize() ->
update_confidence_intervals -> compute_sets -> get_new_query_point:

1. **Intervals** (``ops/fused_posterior.py``): every GP's posterior
   over the grid and ``Q = mu -+ beta sigma``. GPs of one stationary
   family over every grid column share one K1 pass per capacity; every
   other GP whose kernel K2 takes (a Sum/Product algebra of those
   families, Cosine and Bias leaves, an ``active_dims`` subset, as
   contextual SafeOpt uses) gets a K2 pass of its own. A GP with a
   kernel neither takes (White, RatQuad, StdPeriodic, Linear, Poly or
   MLP anywhere in its tree) takes the eager route, the counterpart of
   the JAX package's XLA branch (``safe_opt_core.py:109-151``): its
   gram, ``V = Linv k``, ``mu`` and ``sigma`` in plain PyTorch, V kept
   for the expander or, past ``_V_BYTES_LIMIT``, the grid in chunks.
   The route comes from the kernel's type (``_gp_groups``), never from a
   failed launch, and one step mixes routes freely.
2. **Classification**: safe set S (strict ``l > fmin`` over every GP),
   maximizers M and the expander candidates.
3. **Expander walk**: candidates are visited in the reference order —
   width descending, the larger grid index first on exact ties — a
   chunk at a time; K3 (``ops/fused_expander.py``) tests a whole chunk
   by rank-1 conditioning on a virtual observation, and the walk stops
   at the first chunk with a success (K4 for the GPs on K2; on the eager
   route the same rank-1 update in plain PyTorch, with the kept V or
   ``M2 @ k(X, grid)``, ``:288-352`` of the JAX module). The order
   comes from the exact top-k (K5, ``ops/topk.py``) on a flipped key:
   the first chunk from a top-k of ``chunk``, and, only if the walk goes
   on, the whole order once. The JAX package's ``lax.while_loop``
   becomes a Python loop with one host sync per chunk.
4. **Selection**: masked argmax (first maximum) of the scaled width over
   M | G, or of the objective upper bound over S for safe-UCB.

Everything runs eagerly on the device of the grid; the host reads a few
scalars per step (the walk's syncs and the packed ``diag``).
``traced_safeopt_step`` is the same step with nothing chosen on the host,
the one ``torch.export`` traces (``utils/deployment.py``): K1-K4 through
their ``torch.library`` operators, the walk in one ``while_loop`` over a
visit order from one stable sort, its operands built once a walk.

The certified path (``exact_boundaries``; ``:642-1118`` of the JAX
module) settles every safe bit within ``band`` of a threshold in
float64. ``interval_precision='high'`` runs the grid pass with the
three-pass product (K1-3p, K2-3p) and recomputes, with the full-float32
K1/K2 on the gathered points, every row within ``refine_band`` of a
decision boundary (``_refine_Q``). Eager GPs have one precision: their
rows pass through the certified path as they are, as the JAX package's
XLA branch ignores ``three_pass``, and both oracles take them. Two
protocols: ``certified_scan`` (the whole step plus the band triage, one
packed pull; the host oracle then corrects with ``safeopt_step_from_Q``
only when a verdict flips),
and ``interval_scan`` -> ``device_oracle`` (float64 on the device) ->
``certified_finish`` (one classification, one pull). The top-k calls are
K5's, so ties fall as in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..gp.kernels import Product, Sum, _Constant, _Stationary
from ..gp.regression import row_mask
from ..ops.fused_expander import (expander_fixed, expander_plan_fixed,
                                  fused_expander_predicate_batched,
                                  fused_expander_predicate_single)
from ..ops.fused_posterior import (fused_intervals_batched,
                                   fused_intervals_single, scalar,
                                   supports_kernel, supports_plan)
from ..ops.topk import top_k
from ..utils.observability import host_syncs

__all__ = ["StepResult", "safeopt_step", "traced_safeopt_step",
           "safe_maximum",
           "full_expander_sets", "boundary_scan", "safeopt_step_from_Q",
           "certified_scan", "interval_scan", "device_oracle",
           "certified_finish"]

_NINF = float("-inf")
# The eager route keeps V (cap, N) per GP for the expander while it is at
# most this many bytes, and above it runs the grid in chunks of
# _CHUNK_ROWS rows without keeping V (``safe_opt_core.py:118-151`` of the
# JAX package, whose limit this is; it counts 4 bytes an entry, the port
# the state's own entry size).
_V_BYTES_LIMIT = 3 << 30
_CHUNK_ROWS = 1 << 16


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


def _gp_groups(kernels, states, d: int) -> List[Tuple[List[int], str]]:
    """``(indices, route)`` per grid pass, from the kernels' types alone:
    ``'batched'``, the GPs K1/K3 take, one group per family and
    capacity; ``'plan'``, a GP alone on K2/K4; ``'eager'``, a GP alone
    whose kernel neither takes, in plain PyTorch."""
    groups, batched = [], {}
    for i, (kern, st) in enumerate(zip(kernels, states)):
        if supports_kernel(kern, d):
            key = (type(kern), st.capacity)
            if key not in batched:
                batched[key] = []
                groups.append((batched[key], "batched"))
            batched[key].append(i)
        else:
            groups.append(([i], "plan" if supports_plan(kern, d)
                           else "eager"))
    return groups


def eager_gps(kernels, states, d: int) -> int:
    """How many GPs take the eager route over a d-column grid."""
    return sum(len(idx) for idx, route in _gp_groups(kernels, states, d)
               if route == "eager")


# ---------------------------------------------------------------------------
# the eager route
# ---------------------------------------------------------------------------

def _grid_gram(kernel, X, Z):
    """``kernel.K(X, Z)`` for a grid-sized ``Z``, with each stationary
    leaf's distance summed in the difference form ``sum_k ((x_k - z_k) /
    l_k)^2``, as the grid kernels sum it (the ``|x|^2 + |z|^2 - 2 x.z``
    form of ``Kernel.K`` loses digits that the factor amplifies)."""
    if isinstance(kernel, Product):
        return _grid_gram(kernel.k1, X, Z) * _grid_gram(kernel.k2, X, Z)
    if isinstance(kernel, Sum):
        return _grid_gram(kernel.k1, X, Z) + _grid_gram(kernel.k2, X, Z)
    if not isinstance(kernel, _Stationary) or isinstance(kernel, _Constant):
        return kernel.K(X, Z)
    Xs, Zs = kernel._scaled(X), kernel._scaled(Z)
    r2 = Xs.new_zeros((Xs.shape[0], Zs.shape[0]))
    for k in range(Xs.shape[1]):
        diff = Xs[:, k, None] - Zs[None, :, k]
        r2 = r2 + diff * diff
    return kernel._K_of_r2(r2)


def _eager_posterior(kernel, state, grid):
    """``(mu, var, V)`` of one GP over the grid in plain PyTorch: ``V =
    Linv @ (k(X, grid) * mask)``, ``mu = V^T w``, ``var = kdiag -
    colsum(V^2)`` (``_posterior_with_V`` of the JAX package); past the
    byte limit one grid chunk at a time with V not kept (``V`` None,
    ``_posterior_chunked``)."""
    N = grid.shape[0]
    mask = row_mask(state)[:, None]
    if state.X.element_size() * state.capacity * N <= _V_BYTES_LIMIT:
        V = state.Linv @ (_grid_gram(kernel, state.X, grid) * mask)
        var = kernel.Kdiag(grid) - torch.sum(V * V, dim=0)
        return V.T @ state.w, torch.clamp(var, min=0.0), V
    lm = state.Linv * mask.T
    mu, var = grid.new_empty(N), grid.new_empty(N)
    for s in range(0, N, _CHUNK_ROWS):
        gb = grid[s:s + _CHUNK_ROWS]
        Vb = lm @ (_grid_gram(kernel, state.X, gb) * mask)
        mu[s:s + _CHUNK_ROWS] = Vb.T @ state.w
        var[s:s + _CHUNK_ROWS] = torch.clamp(
            kernel.Kdiag(gb) - torch.sum(Vb * Vb, dim=0), min=0.0)
    return mu, var, None


def _eager_predicate(kernel, state, grid, unsafe, mu, sigma, V, Xc, uc,
                     fmin, beta):
    """(C,) expander predicate of one GP on the eager route: the rank-1
    conditioning on the virtual observation (x_cand, u) — ``Cm = Linv
    k(X, Xc)``, ``dd``, ``gain`` — with the cross term ``Cm^T V`` from the
    kept ``V`` or, without it, ``M2 @ k(X, grid)`` one grid chunk at a
    time (``M2 = Cm^T Lm``), as the JAX package's XLA branch."""
    mask = row_mask(state)[:, None]
    Cm = state.Linv @ (kernel.K(state.X, Xc) * mask)            # (cap, C)
    dd2 = kernel.Kdiag(Xc) + state.noise_var - torch.sum(Cm * Cm, dim=0)
    dd = torch.sqrt(torch.clamp(dd2, min=1e-30))
    gain = (uc - Cm.T @ state.w) / dd
    if V is not None:
        cross = Cm.T @ V                                         # (C, N)
    else:
        M2 = Cm.T @ (state.Linv * mask.T)                        # (C, cap)
        cross = torch.cat([M2 @ (_grid_gram(kernel, state.X,
                                            grid[s:s + _CHUNK_ROWS]) * mask)
                           for s in range(0, grid.shape[0], _CHUNK_ROWS)],
                          dim=1)
    E = (_grid_gram(kernel, Xc, grid) - cross) / dd[:, None]
    l2 = (mu[None, :] + E * gain[:, None]
          - beta * torch.sqrt(torch.clamp(sigma[None, :] ** 2 - E * E,
                                          min=0.0)))
    return torch.any(unsafe[None, :] & (l2 >= fmin), dim=1)


# ---------------------------------------------------------------------------
# confidence intervals
# ---------------------------------------------------------------------------

def _confidence_intervals(kernels, states, grid, beta, three_pass=False):
    """``(Q, mu, sigma)`` of ``_grid_posterior``."""
    return _grid_posterior(kernels, states, grid, beta, three_pass)[:3]


def _grid_posterior(kernels, states, grid, beta, three_pass=False,
                    traced=False):
    """``Q`` (N, 2G), the posterior ``mu`` and ``sigma`` (G, N) for the
    expander pass, and per GP the eager route's kept ``V`` (None on the
    kernels' routes or past the byte limit). On the kernels' routes mu
    and sigma are recovered from the interval rows; the eager route gives
    them directly, as the JAX package's XLA branch does. ``three_pass``
    takes the kernels' product at the three-pass precision (K1-3p,
    K2-3p): the certified path's interval pass; eager GPs ignore it.
    ``traced`` calls K1 and K2 through their ``torch.library``
    operators."""
    N, d = grid.shape
    G = len(kernels)
    rows, Vs, direct = [None] * G, [None] * G, {}
    for idx, route in _gp_groups(kernels, states, d):
        if route == "eager":
            i = idx[0]
            mu_i, var_i, Vs[i] = _eager_posterior(kernels[i], states[i], grid)
            sigma_i = torch.sqrt(var_i)
            rows[i] = torch.stack([mu_i - beta * sigma_i,
                                   mu_i + beta * sigma_i])
            direct[i] = (mu_i, sigma_i)
        elif route == "plan":
            rows[idx[0]] = fused_intervals_single(
                kernels[idx[0]], states[idx[0]], grid, beta,
                three_pass=three_pass, traced=traced)
        else:
            out = fused_intervals_batched([kernels[i] for i in idx],
                                          [states[i] for i in idx], grid,
                                          beta, three_pass=three_pass,
                                          traced=traced)
            for j, i in enumerate(idx):
                rows[i] = out[j]
    out = torch.stack(rows)                                  # (G, 2, N)
    l, u = out[:, 0], out[:, 1]
    Q = out.permute(2, 0, 1).reshape(N, -1)                  # [l0,u0,l1,..]
    mu = (l + u) * 0.5
    sigma = (u - l) / (2.0 * beta)
    for i, (mu_i, sigma_i) in direct.items():
        mu[i], sigma[i] = mu_i, sigma_i
    return Q, mu, sigma, Vs


def _moments_from_Q(Q, beta):
    """Per-GP ``(mu, sigma)`` (G, N) recovered exactly from the interval
    columns, as ``_confidence_intervals`` derives them."""
    l, u = Q[:, 0::2].T, Q[:, 1::2].T
    return (l + u) * 0.5, (u - l) / (2.0 * beta)


# ---------------------------------------------------------------------------
# set classification
# ---------------------------------------------------------------------------

def _classify(Q, fmin, scaling, threshold, beta, S=None):
    """S, M, the expander-candidate mask and the unscaled widths that
    order the walk (reference gp_opt.py:478-552). A precomputed (e.g.
    boundary-certified) ``S`` may be given in place of the strict
    interval test."""
    l = Q[:, 0::2]                                   # (N, G)
    u = Q[:, 1::2]
    widths = u - l

    if S is None:
        S = torch.all(l > fmin, dim=1)               # strict, like reference
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

def _pick(t, idx):
    """Rows ``idx`` (a list) of ``t``, gathered one by one: a list index
    would be a tensor constant, which a traced loop's body cannot hold."""
    return torch.stack([t[i] for i in idx])


def _walk_fixed(kernels, states, grid, unsafe, mu, sigma, fmin, beta,
                lipschitz):
    """The expander predicate's operands that no candidate changes, built
    once per walk: per group of ``_gp_groups`` K3's ``expander_fixed``,
    K4's ``expander_plan_fixed`` or None (the eager route); for the
    Lipschitz variant the transposed grid and its rows' squared norms."""
    if lipschitz is not None:
        return grid.T.contiguous(), torch.sum(grid * grid, dim=1)
    out = []
    for idx, route in _gp_groups(kernels, states, grid.shape[1]):
        i = idx[0]
        if route == "batched":
            out.append(expander_fixed(
                [kernels[j] for j in idx], [states[j] for j in idx], grid,
                unsafe, _pick(mu, idx), _pick(sigma, idx), beta,
                _pick(fmin, idx)))
        elif route == "plan":
            # copies, not views of mu and sigma: a traced loop's inputs
            # may not alias one another
            out.append(expander_plan_fixed(kernels[i], states[i], grid,
                                           unsafe, mu[i].clone(),
                                           sigma[i].clone(), beta, fmin[i]))
        else:
            out.append(None)
    return out


def _chunk_expander_predicate(kernels, states, grid, Q, unsafe, mu, sigma,
                              fmin, beta, lipschitz, grid_idx, Vs=None,
                              valid=None, traced=False, fixed=None):
    """(C,) expander predicate for candidate grid indices ``grid_idx``.

    GP variant (``lipschitz`` None): rank-1 conditioning on the virtual
    observation (x_cand, u_i) per constraint GP, checked against every
    unsafe grid point (gp_opt.py:577-606) — K3 (K4 on the plan route, the
    eager route's plain PyTorch with the kept ``Vs[i]``, if any). Lipschitz
    variant: ``u_i - L_i * mindist(x_cand, unsafe) >= fmin_i``
    (gp_opt.py:558-576). ``valid`` (C,) marks the slots that hold a
    candidate (the kernels skip the others; default all); ``traced``
    calls K3 and K4 through their ``torch.library`` operators; ``fixed``
    is the walk's ``_walk_fixed`` (built per chunk when None).
    """
    C = grid_idx.shape[0]
    Xc = grid[grid_idx]                                     # (C, d)
    pred = torch.ones((C,), dtype=torch.bool, device=grid.device)

    if lipschitz is None:
        if valid is None:
            valid = torch.ones_like(pred)
        ucs = Q[grid_idx][:, 1::2].T                             # (G, C)
        groups = _gp_groups(kernels, states, grid.shape[1])
        for g, (idx, route) in enumerate(groups):
            fix = None if fixed is None else fixed[g]
            if route == "eager":
                i = idx[0]
                preds = _eager_predicate(
                    kernels[i], states[i], grid, unsafe, mu[i], sigma[i],
                    None if Vs is None else Vs[i], Xc, ucs[i], fmin[i],
                    beta)[None]
            elif route == "plan":
                i = idx[0]
                preds = fused_expander_predicate_single(
                    kernels[i], states[i], grid, unsafe, mu[i], sigma[i],
                    Xc, ucs[i], valid, beta, fmin[i], traced=traced,
                    fixed=fix)[None]
            else:
                pick = _pick if traced else (lambda t, rows: t[rows])
                preds = fused_expander_predicate_batched(
                    [kernels[i] for i in idx], [states[i] for i in idx],
                    grid, unsafe, pick(mu, idx), pick(sigma, idx), Xc,
                    pick(ucs, idx), valid, beta, pick(fmin, idx),
                    traced=traced, fixed=fix)
            for j, i in enumerate(idx):
                pred &= preds[j] | (fmin[i] == _NINF)
    else:
        zt, norms = (grid.T, torch.sum(grid * grid, dim=1)) if fixed is None \
            else fixed
        d2 = (torch.sum(Xc * Xc, dim=1)[:, None] + norms[None, :]
              - 2.0 * (Xc @ zt))
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
                         beta, lipschitz, cand, width, chunk, Vs=None):
    """``(G, chunks)``: G marks the first candidate in visit order whose
    predicate holds (gp_opt.py:557-612), found chunk by chunk. The host
    reads the candidate count once and each chunk's flag (counted in
    ``host_syncs``)."""
    N = grid.shape[0]
    G = torch.zeros((N,), dtype=torch.bool, device=grid.device)
    n_cand, any_unsafe = torch.stack(
        [torch.sum(cand), torch.any(unsafe).long()]).tolist()
    host_syncs.add()
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
                                         gidx, Vs)
        chunks += 1
        host_syncs.add()
        if bool(torch.any(pred)):                  # one host sync per chunk
            # argmax returns the first maximum: the first True in order
            G[gidx[torch.argmax(pred.to(torch.int32))]] = True
            return G, chunks
        pos += chunk
    return G, chunks


def _find_first_expander_traced(kernels, states, grid, Q, unsafe, mu, sigma,
                                fmin, beta, lipschitz, cand, width, chunk,
                                Vs=None):
    """``(G, rounds)`` of ``_find_first_expander`` with nothing chosen on
    the host, so that the walk traces (``torch.export``), the counterpart
    of the JAX ``lax.while_loop`` (``safe_opt_core.py:393-492``): the
    visit order from one stable sort of the flipped key (K5's tie rule),
    one ``while_loop`` over chunks carrying (position, found, winner,
    rounds), each chunk gathered from the order and masked past the
    candidate count, the predicate through the K3/K4 operators (or the
    eager predicate), the winner the first hit in visit order. With no
    unsafe point the walk is void, as on the host. The chunk's predicate
    of each candidate is the host walk's, so G and the query are too.

    PyTorch runs a ``while_loop`` eagerly by reading its condition on the
    host: once before the loop, once before each round and once after the
    last."""
    from torch._higher_order_ops.while_loop import while_loop

    N = grid.shape[0]
    C = min(chunk, N)
    dev = grid.device
    n_cand = torch.where(torch.any(unsafe), torch.sum(cand), 0)
    key = torch.where(cand, width, _NINF)
    _, ridx = torch.sort(torch.flip(key, (0,)), descending=True, stable=True)
    order = N - 1 - ridx
    slots = torch.arange(C, device=dev)
    fixed = _walk_fixed(kernels, states, grid, unsafe, mu, sigma, fmin, beta,
                        lipschitz)

    def zero(dtype=torch.int64):
        return torch.zeros((), dtype=dtype, device=dev)

    def cond(pos, found, win, rounds):
        return ~found & (pos < n_cand)

    def body(pos, found, win, rounds):
        at = pos + slots
        valid = at < n_cand
        gidx = torch.gather(order, 0, torch.clamp(at, max=N - 1))
        pred = _chunk_expander_predicate(
            kernels, states, grid, Q, unsafe, mu, sigma, fmin, beta,
            lipschitz, gidx, Vs, valid=valid, traced=True,
            fixed=fixed) & valid
        hit = torch.any(pred)
        first = torch.argmax(pred.to(torch.int32)).reshape(1)
        return (pos + C, hit, torch.where(hit, torch.gather(gidx, 0, first)
                                          .reshape(()), win), rounds + 1)

    _, found, win, rounds = while_loop(
        cond, body, (zero(), zero(torch.bool), zero() - 1, zero()))
    return (torch.arange(N, device=dev) == win) & found, rounds


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


def _decide(kernels, states, grid, Q, mu, sigma, Vs, fmin, beta, scaling,
            threshold, lipschitz, ucb, use_lipschitz, chunk, S=None,
            traced=False):
    """Classification, expander walk and selection from intervals ``Q``
    (their moments and the eager route's kept ``Vs``), with ``S`` given
    or from the strict test; ``traced`` walks with
    ``_find_first_expander_traced``."""
    S, M, cand, width, has_safe = _classify(Q, fmin, scaling, threshold,
                                            beta, S=S)
    if ucb:
        G = torch.zeros_like(S)
        M = torch.zeros_like(S)   # ucb never populates M/G (gp_opt.py:670)
        chunks = torch.zeros((), dtype=torch.int64, device=grid.device) \
            if traced else 0
    else:
        lip = lipschitz if use_lipschitz else None
        walk = _find_first_expander_traced if traced \
            else _find_first_expander
        G, chunks = walk(kernels, states, grid, Q, ~S, mu, sigma, fmin, beta,
                         lip, cand, width, chunk, Vs)
    next_idx = _select_query(Q, S, M, G, scaling, ucb)
    return _pack_result(Q, S, M, G, next_idx, has_safe, chunks)


def safeopt_step(kernels, states, grid, fmin, beta: float, scaling,
                 threshold, lipschitz=None, *, ucb: bool = False,
                 use_lipschitz: bool = False, chunk: int = 64) -> StepResult:
    """One full SafeOpt iteration over the candidate grid.

    ``grid`` (N, d), ``fmin``, ``scaling`` and ``threshold`` (G,) are
    tensors on one device; ``beta`` is a float.
    """
    Q, mu, sigma, Vs = _grid_posterior(kernels, states, grid, beta)
    return _decide(kernels, states, grid, Q, mu, sigma, Vs, fmin, beta,
                   scaling, threshold, lipschitz, ucb, use_lipschitz, chunk)


def traced_safeopt_step(kernels, states, grid, fmin, beta, scaling,
                        threshold, lipschitz=None, *, ucb: bool = False,
                        use_lipschitz: bool = False,
                        chunk: int = 64) -> StepResult:
    """``safeopt_step`` with nothing chosen on the host, the step that
    ``torch.export`` traces (``utils/deployment.py``): K1-K4 through their
    ``torch.library`` operators (``ops/library.py``), the operands built
    on the device from hyperparameters that live there
    (``fused_posterior.on_device``), and the expander walk in one
    ``while_loop`` (``_find_first_expander_traced``). ``beta`` may be a
    0-d tensor (cast to the grid's dtype, as the live step's float is);
    ``walk_chunks`` is a 0-d tensor. Its decisions are the live step's.
    """
    beta = scalar(beta, grid)
    Q, mu, sigma, Vs = _grid_posterior(kernels, states, grid, beta,
                                       traced=True)
    return _decide(kernels, states, grid, Q, mu, sigma, Vs, fmin, beta,
                   scaling, threshold, lipschitz, ucb, use_lipschitz, chunk,
                   traced=True)


def safe_maximum(kernels, states, grid, fmin, beta: float):
    """Best safe point by objective lower bound (gp_opt.py:677-712).

    Returns ``(idx, lower_bound, has_safe, Q, S, diag)`` with ``diag``
    packing [idx, lower_bound, has_safe] for one host read.
    """
    Q = _confidence_intervals(kernels, states, grid, beta)[0]
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
    Q, mu, sigma, Vs = _grid_posterior(kernels, states, grid, beta)
    l, u = Q[:, 0::2], Q[:, 1::2]
    S = torch.all(l > fmin, dim=1)
    has_safe = torch.any(S)
    best_l0 = torch.max(torch.where(S, l[:, 0], _NINF))
    M = S & (u[:, 0] >= best_l0) & has_safe

    lip = lipschitz if use_lipschitz else None
    G = torch.zeros_like(S)
    safe_idx = torch.nonzero(S).squeeze(1)
    host_syncs.add()
    chunks = 0
    for s in range(0, safe_idx.shape[0], chunk):
        gidx = safe_idx[s:s + chunk]
        G[gidx] = _chunk_expander_predicate(kernels, states, grid, Q, ~S,
                                            mu, sigma, fmin, beta, lip,
                                            gidx, Vs)
        chunks += 1
    G = G & has_safe
    next_idx = torch.zeros((), dtype=torch.int64, device=grid.device)
    return _pack_result(Q, S, M, G, next_idx, has_safe, chunks)


# ---------------------------------------------------------------------------
# boundary-certified decisions (exact_boundaries)
# ---------------------------------------------------------------------------

def _safety_margin(Q, fmin, scaling):
    """(N,) scaled distance of each row's lower bounds to the nearest
    safety threshold (inf where no GP is constrained)."""
    margins = (Q[:, 0::2] - fmin).abs() / scaling
    margins = torch.where(fmin > _NINF, margins, float("inf"))
    return torch.amin(margins, dim=1)


def _int32(*parts):
    """One int32 vector of scalars and vectors (a packed pull)."""
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def boundary_scan(kernels, states, grid, fmin, beta: float, scaling, band,
                  *, k: int = 128):
    """Intervals plus the boundary triage, without classification:
    ``(Q, idx (k,), within (k,) bool, total_within ())`` with ``idx``
    the k rows closest to a safety threshold, ``within`` those inside
    ``band`` and ``total_within > k`` a triage budget overflow."""
    Q = _confidence_intervals(kernels, states, grid, beta)[0]
    margin = _safety_margin(Q, fmin, scaling)
    neg, idx = top_k(-margin, k)
    return Q, idx, (-neg) < band, torch.sum(margin < band)


def _fix_safe_set(Q, fmin, fix_idx, fix_bits):
    """The strict safe set with the certified bits at ``fix_idx`` (entries
    < 0 are padding and change nothing) written over it."""
    S = torch.all(Q[:, 0::2] > fmin, dim=1)
    N = S.shape[0]
    ext = torch.cat([S, S.new_zeros(1)])        # padding writes slot N
    ext[torch.where(fix_idx >= 0, fix_idx.long(), N)] = fix_bits & (
        fix_idx >= 0)
    return ext[:N]


def safeopt_step_from_Q(kernels, states, grid, Q, fix_idx, fix_bits, fmin,
                        beta: float, scaling, threshold, lipschitz=None, *,
                        ucb: bool = False, use_lipschitz: bool = False,
                        chunk: int = 64) -> StepResult:
    """Pass 2 of a certified iteration: ``safeopt_step`` on intervals
    ``Q`` from pass 1, with the safe bits at ``fix_idx`` (entries < 0 are
    padding) OVERRIDDEN by the float64 verdicts ``fix_bits`` before
    maximizers, expanders and the query are derived; the moments come
    from Q exactly (``_moments_from_Q``)."""
    mu, sigma = _moments_from_Q(Q, beta)
    S = _fix_safe_set(Q, fmin, fix_idx, fix_bits)
    return _decide(kernels, states, grid, Q, mu, sigma, [None] * len(kernels),
                   fmin, beta, scaling, threshold, lipschitz, ucb,
                   use_lipschitz, chunk, S=S)


def _refine_Q(kernels, states, grid, Q, fmin, beta: float, scaling, rk: int,
              band_k: int, refine_band):
    """Recompute the decision-critical rows of a reduced-precision ``Q``
    at full float32 and write them back: ``(Q, band_pop, idx)``.

    One top-(band_k + rk) (K5) over one boundary-proximity key, the
    pointwise max of scores each 0 at its boundary and negative away
    from it, in scaled units (``safe_opt_core.py:754-852`` of the JAX
    package): ``-margin``, the distance to a safety threshold; with
    ``rk``, over SAFE rows only, the scaled width against the widest
    safe row, the objective's lower bound against the incumbent
    ``best_l0`` and its upper bound's distance to ``best_l0`` (the
    maximizer boundary). ``band_pop`` counts the rows within
    ``refine_band`` of any boundary: whenever it fits the budget the
    selection holds every such row. The rows go through the full-float32
    K1/K2 (``_confidence_intervals`` on the gathered points).

    The host reads ``band_pop`` once, to choose. Past the budget no
    selection can hold every such row (a state whose safe rows all have
    nearly the same width puts most of them within the band of the
    widest), so the port recomputes every row at full float32 instead
    and returns ``idx`` None: the step's decisions are then the
    full-precision step's. The JAX package keeps the partial selection
    there and warns, leaving band rows at the reduced precision (ROADMAP
    Queue 3). The default budget (``safe_opt.REFINE_BAND_SHARE``) is
    where refining the band would cost more than the full pass.
    """
    l, u = Q[:, 0::2], Q[:, 1::2]
    key = -_safety_margin(Q, fmin, scaling)
    budget = min(band_k + rk, key.shape[0])
    if rk:
        S0 = torch.all(l > fmin, dim=1)
        widths = torch.amax((u - l) / scaling, dim=1)
        s_w = widths - torch.max(torch.where(S0, widths, _NINF))
        l0s = l[:, 0] / scaling[0]
        best_l0 = torch.max(torch.where(S0, l0s, _NINF))
        s_l = l0s - best_l0
        s_m = -(u[:, 0] / scaling[0] - best_l0).abs()
        head = torch.maximum(torch.maximum(s_w, s_l), s_m)
        key = torch.maximum(key, torch.where(S0, head, _NINF))
    band_pop = torch.sum(key > -refine_band)
    host_syncs.add()
    if int(band_pop) > budget:
        return (_confidence_intervals(kernels, states, grid, beta)[0],
                band_pop, None)
    _, idx = top_k(key, budget)
    rows = _confidence_intervals(kernels, states, grid[idx], beta)[0]
    Q = Q.clone()
    Q[idx] = rows
    return Q, band_pop, idx


def _scan_intervals(kernels, states, grid, fmin, beta: float, scaling, band,
                    refine_band, refine_k: int, refine_band_k: int,
                    interval_precision):
    """Pass 1's intervals on the certified paths: the grid pass (three-pass
    under ``interval_precision='high'``), then the full-float32
    refinement (or a full-float32 pass where it cannot cover the band:
    ``refined_idx`` None). ``(Q, mu, sigma, Vs, refine_pop,
    refined_idx)``."""
    Q, mu, sigma, Vs = _grid_posterior(
        kernels, states, grid, beta,
        three_pass=interval_precision == "high")
    refine_pop = torch.zeros((), dtype=torch.int64, device=grid.device)
    refined_idx = None
    if interval_precision is not None and (refine_k or refine_band_k):
        Q, refine_pop, refined_idx = _refine_Q(
            kernels, states, grid, Q, fmin, beta, scaling, refine_k,
            max(refine_band_k, 1), band if refine_band is None
            else refine_band)
        mu, sigma = _moments_from_Q(Q, beta)
        Vs = [None] * len(kernels)
    return Q, mu, sigma, Vs, refine_pop, refined_idx


def _band_triage(Q, refined_idx, fmin, scaling, band, k: int):
    """``(idx, within, total_within)``: the k rows closest to a safety
    threshold, flagged inside the float64 band; over the refined rows
    when they number at least k (every possible band row was refined)."""
    if refined_idx is not None and refined_idx.shape[0] >= k:
        sub = _safety_margin(Q[refined_idx], fmin, scaling)
        neg, j = top_k(-sub, k)
        return refined_idx[j], (-neg) < band, torch.sum(sub < band)
    margin = _safety_margin(Q, fmin, scaling)
    neg, idx = top_k(-margin, k)
    return idx, (-neg) < band, torch.sum(margin < band)


def certified_scan(kernels, states, grid, fmin, beta: float, scaling,
                   threshold, band, lipschitz=None, refine_band=None, *,
                   k: int = 128, refine_k: int = 0, refine_band_k: int = 0,
                   ucb: bool = False, use_lipschitz: bool = False,
                   chunk: int = 64, interval_precision=None):
    """Pass 1 of an optimistic certified iteration: the complete step
    (``safeopt_step``'s decisions on the pass's intervals) and the
    float64 band triage. Returns ``(StepResult, packed)`` with
    ``packed`` one int32 vector ``[diag(5), total_within, refine_pop,
    idx(k), within(k), S[idx](k)]``: one host pull tells the caller the
    step, the rows inside the band and their float32 verdicts."""
    Q, mu, sigma, Vs, refine_pop, refined_idx = _scan_intervals(
        kernels, states, grid, fmin, beta, scaling, band, refine_band,
        refine_k, refine_band_k, interval_precision)
    res = _decide(kernels, states, grid, Q, mu, sigma, Vs, fmin, beta,
                  scaling, threshold, lipschitz, ucb, use_lipschitz, chunk)
    idx, within, total_within = _band_triage(Q, refined_idx, fmin, scaling,
                                             band, k)
    return res, _int32(res.diag, total_within, refine_pop, idx, within,
                       res.S[idx])


def interval_scan(kernels, states, grid, fmin, beta: float, scaling, band,
                  refine_band=None, *, k: int = 128, refine_k: int = 0,
                  refine_band_k: int = 0, interval_precision=None):
    """Pass 1 of the device-oracle certified iteration: intervals (and
    the refinement) and the band triage, no classification. Returns
    ``(Q, packed_t)``, ``packed_t`` = int32 ``[total_within,
    refine_pop, idx(k), within(k)]``."""
    Q, _, _, _, refine_pop, refined_idx = _scan_intervals(
        kernels, states, grid, fmin, beta, scaling, band, refine_band,
        refine_k, refine_band_k, interval_precision)
    idx, within, total_within = _band_triage(Q, refined_idx, fmin, scaling,
                                             band, k)
    return Q, _int32(total_within, refine_pop, idx, within)


def device_oracle(kernels, ostates, grid, Q, packed_t, fmin, beta: float, *,
                  constrained, k: int, kinds=None):
    """Settle the band's safe verdicts in float64 on the grid's device.

    Recomputes the <= k in-band rows' lower bounds at the points of
    ``grid`` (the float64 grid: the points the host oracle takes, not
    their float32 rounding) against each model's ``OracleState`` (the
    float64 factors the host oracle uses; ``kinds[i]``, the kind
    ``device_oracle_state`` returns, picks the mean as that model's
    ``predict_f64`` forms it: ``'exact'`` mu = V^T w, ``'sparse'`` mu =
    k^T alpha; None means every model is exact) and returns
    ``(fix_idx, fix_bits, flips, n_within)`` on the device: ``fix_idx``
    the band rows (-1 elsewhere), ``fix_bits`` their float64
    verdicts, ``flips`` how many differ from the float32 verdicts of
    ``Q``. Unconstrained GPs (``constrained[i]`` False) are skipped, as
    the host oracle skips them."""
    idx = packed_t[2:2 + k].long()
    within = packed_t[2 + k:2 + 2 * k] > 0
    rows = idx.clamp(min=0)
    pts = grid[rows].to(torch.float64)
    l_rows = Q[rows][:, 0::2]                           # pass-1 float32 l
    safe64 = torch.ones((k,), dtype=torch.bool, device=grid.device)
    s_f32 = torch.ones_like(safe64)
    if kinds is None:
        kinds = ("exact",) * len(ostates)
    for i, (kern, st, kind) in enumerate(zip(kernels, ostates, kinds)):
        if not constrained[i]:
            continue
        mask = (torch.arange(st.capacity, device=st.X.device)
                < st.count).to(torch.float64)
        kvec = kern.K(st.X, pts) * mask[:, None]            # (cap, k)
        V = st.F @ kvec
        mu = kvec.T @ st.alpha if kind == "sparse" else V.T @ st.w
        var = kern.Kdiag(pts) - torch.sum(V * V, dim=0)
        l64 = mu - beta * torch.sqrt(torch.clamp(var, min=0.0))
        safe64 &= l64 > fmin[i]
        s_f32 &= l_rows[:, i] > fmin[i].to(l_rows.dtype)
    fix_idx = torch.where(within, idx, -1).to(torch.int32)
    return (fix_idx, within & safe64,
            torch.sum(within & (safe64 != s_f32)).to(torch.int32),
            torch.sum(within).to(torch.int32))


def certified_finish(kernels, states, grid, Q, packed_t, fix_idx, fix_bits,
                     flips, n_within, fmin, beta: float, scaling, threshold,
                     lipschitz=None, *, ucb: bool = False,
                     use_lipschitz: bool = False, chunk: int = 64):
    """Pass 3 of the device-oracle certified iteration: classify once
    with the float64 bits written in (``safeopt_step_from_Q``), then pack
    the caller's stats into one 9-int buffer ``[has_safe, next_idx,
    |S|, |M|, anyG, flips, total_within, refine_pop, n_within]``, the
    path's one host pull."""
    res = safeopt_step_from_Q(kernels, states, grid, Q, fix_idx, fix_bits,
                              fmin, beta, scaling, threshold, lipschitz,
                              ucb=ucb, use_lipschitz=use_lipschitz,
                              chunk=chunk)
    return res, _int32(res.diag, flips, packed_t[0:2], n_within)

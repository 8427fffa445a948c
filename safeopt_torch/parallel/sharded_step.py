"""The SafeOpt step over a device mesh: each rank's grid rows on its card.

``safe_opt_core.safeopt_step``, ``safe_maximum``, ``full_expander_sets``
and the certified functions (``boundary_scan``, ``certified_scan``,
``interval_scan``, ``safeopt_step_from_Q``, ``device_oracle``; and
``certified_finish`` through ``safeopt_step_from_Q``) hand off here when
the grid is a ``DTensor`` (``sharding.shard_grid``). The step does not
go through ``DTensor``
dispatch: K1-K4 are ``torch.library`` operators with no sharding rules,
so every operand is unwrapped (``to_local``), the existing one-device
code runs on the rank's rows, and the few collectives the JAX design
names (``docs/design.md:178-186``, ``:219-226``) are written out over
the mesh's process groups:

* **Intervals.** K1 (K2 for a plan, the eager route for the rest) on the
  local rows only. The rows are independent, so with a ``model`` axis of
  size 1 the local Q is the matching rows of the unsharded Q. With
  ``model`` > 1 each ``model`` rank forms the partial ``w.V`` and
  ``sum V^2`` of its block of factor rows on the local grid rows in
  plain PyTorch (the JAX package runs this case on its ``jnp`` path too),
  and one ``all_reduce(SUM)`` over ``model`` adds them: Q then agrees
  with the unsharded Q to round-off, not bit for bit.
* **Classification.** ``best_l0`` and ``max_var`` are ``all_reduce(MAX)``
  over the grid axes and ``has_safe`` an OR (``_classify``'s
  ``combine``).
* **The walk.** The visit order is global: width descending, the larger
  *global* index first on exact ties. Each rank offers the next
  ``chunk`` candidates of its own visit order (key, global index,
  coordinates, upper bounds); one ``all_gather`` and a merge under the
  tie rule give the exact next global chunk, and each rank's offer
  advances by what the merge took from it. Every rank then tests the
  chunk against its own unsafe rows with K3 (K4 for a plan), and one
  ``all_reduce(MAX)`` of the per-GP (G, C) predicates decides it; for the
  Lipschitz variant ``mindist`` is an ``all_reduce(MIN)``. With
  ``model`` > 1 the factor rows are all-gathered over ``model`` once a
  step, before anything else, so K3 runs unchanged.
* **Selection.** The first global maximum, from each shard's first local
  maximum and its global index. ``next_idx`` and the scalars are plain
  tensors, the same on every rank; Q, S, M and G come back as
  ``DTensor``s sharded like the grid.

The certified path adds, on the same rows and the same collectives:

* **Intervals.** The grid pass (K1-3p under ``interval_precision='high'``,
  K1 otherwise; K2-3p and K2 for a plan) runs on the local rows with the
  whole factor (gathered over ``model`` once, as for the walk), whatever
  the ``model`` size: splitting the three-pass product over ``model``
  waits for a ``model`` axis inside K1 (ROADMAP [16d]). So Q is the
  unsharded Q's rows bit for bit.
* **The global top-k** (``_Shards.top``): each rank offers the k largest
  keys of its rows (``ops.topk.top_k``, no host read), one ``all_gather``
  and a merge under ``top_k``'s rule (``merge_top``: value descending,
  the *smaller* global index first, the opposite tie rule to the walk's
  ``merge_order``) give the one-device selection on every rank.
* **The refinement** (``safe_opt_core._refine_Q`` on the rank's view):
  the safe rows' widest width and ``best_l0`` are ``all_reduce(MAX)``,
  the band population an ``all_reduce(SUM)``; the global top-k selects
  the rows and each rank recomputes, with K1 (K2), only the selected
  rows it holds, on its own points: ``_Shards.own`` puts them first in
  a buffer of at most its own row count, so the recomputation shrinks
  as ranks are added. Past the budget the full float32 pass runs on
  the local rows.
* **The triage** (``_band_triage``): the global top-k of the margins and
  an ``all_reduce(SUM)`` of the band count; over the refined rows their
  margins come from their owners, as do ``S[idx]`` in ``packed`` and the
  device oracle's band points and pass-1 bounds (``_Shards.from_owners``,
  one ``all_gather`` of k rows). Every rank then builds the same
  ``packed``, ``packed_t`` and oracle verdicts.
* **Pass 2** writes the fix bits whose global index falls in the rank's
  rows, and decides as the plain step.

A rank reads the device once for the candidate counts and once per walk
round, as the one-device walk does, and the certified path once more for
the refinement's band population (``host_syncs``); the global top-k
reads nothing.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..algorithms.safe_opt_core import (_NINF, StepResult, _band_triage,
                                        _classify, _fix_safe_set,
                                        _gp_predicates, _grid_gram,
                                        _grid_posterior, _int32,
                                        _lipschitz_predicate, _mindist,
                                        _moments_from_Q, _oracle,
                                        _scan_intervals, _unsafe,
                                        _valid_rows, _visit_order)
from ..gp.regression import row_mask
from ..ops.topk import top_k
from ..utils.observability import host_syncs
from .sharding import MODEL_AXIS, _shard_index, grid_axes

__all__ = ["safeopt_step", "safe_maximum", "full_expander_sets",
           "boundary_scan", "certified_scan", "interval_scan",
           "safeopt_step_from_Q", "device_oracle"]


def _gather(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` all-gathered over each of ``groups`` in turn, the blocks
    concatenated along dim 0 in rank order."""
    t = t.contiguous()
    for group in groups:
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts)
    return t


def _local(t):
    """The rank's part of ``t`` (``t`` itself unless a ``DTensor``)."""
    return t.to_local() if isinstance(t, DTensor) else t


class _Shards:
    """This rank's view of a sharded grid: its rows, their global offset,
    the grid's row count and the process groups of the mesh's grid and
    model axes; the certified helpers' view of the rows
    (``safe_opt_core._OneDevice`` on one device)."""

    def __init__(self, grid: DTensor):
        mesh = grid.device_mesh
        names = mesh.mesh_dim_names
        self.mesh, self.placements = mesh, grid.placements
        self.grid = grid.to_local()
        self.n = self.grid.shape[0]
        axes = grid_axes(mesh)
        self.index, self.count = _shard_index(mesh, axes)
        self.offset = self.index * self.n
        self.total = self.n * self.count
        # gathers run over the fastest axis first, so that the blocks
        # come out in global row order
        self.grid_groups = [mesh.get_group(a) for a in reversed(axes)
                            if mesh.size(names.index(a)) > 1]
        self.model = mesh.size(names.index(MODEL_AXIS))
        self.model_index = dict(zip(names, mesh.get_coordinate()))[
            MODEL_AXIS]
        self.model_group = (mesh.get_group(MODEL_AXIS) if self.model > 1
                            else None)

    def valid(self, num_valid):
        """(n,) mask of the local rows below ``num_valid`` (None: all)."""
        return _valid_rows(self.n, _local(num_valid), self.grid.device,
                           self.offset)

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the grid shards (``op`` 'max', 'min' or
        'sum'); booleans as uint8."""
        if not self.grid_groups:
            return t
        is_bool = t.dtype == torch.bool
        out = t.to(torch.uint8) if is_bool else t.clone()
        rop = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "sum": dist.ReduceOp.SUM}[op]
        for group in self.grid_groups:
            dist.all_reduce(out, op=rop, group=group)
        return out.to(torch.bool) if is_bool else out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every grid shard's ``t`` concatenated along dim 0 in shard
        order (the same shape on every shard)."""
        return _gather(t, self.grid_groups)

    def top(self, key: torch.Tensor, k: int):
        """``top_k`` of the key over every shard's rows, ``(values,
        global indices)`` on every rank: each shard offers its own top
        ``min(k, n)``, padded to k with value -inf and index inf, and one
        ``all_gather`` and ``merge_top`` order the offers. No host
        read."""
        if not 0 < k <= self.total:
            raise ValueError(f"k={k} must be in [1, {self.total}]")
        values, lidx = top_k(key, min(k, self.n))
        m = values.shape[0]
        offer = torch.full((k, 2), float("inf"), dtype=torch.float64,
                           device=key.device)
        offer[:, 0] = _NINF
        offer[:m, 0] = values.to(torch.float64)
        offer[:m, 1] = (self.offset + lidx).to(torch.float64)
        offers = self.gather(offer)
        pick = merge_top(offers[:, 0], offers[:, 1])[:k]
        return offers[pick, 0].to(key.dtype), offers[pick, 1].long()

    def rows_at(self, idx: torch.Tensor) -> torch.Tensor:
        """The local rows of the global indices ``idx``, clamped into
        this shard (the rows another shard holds are placeholders)."""
        return (idx - self.offset).clamp(0, self.n - 1)

    def own(self, idx: torch.Tensor):
        """``(at, mine)``: the local rows of the global indices ``idx``
        that this shard holds, in ``idx``'s order, first in a buffer of
        ``min(len(idx), n)`` rows; ``mine`` is False on the buffer's
        rest (placeholder row 0). A stable sort on ownership, no host
        read."""
        loc = idx - self.offset
        held = (loc >= 0) & (loc < self.n)
        first = torch.sort((~held).to(torch.uint8), stable=True).indices[
            :min(idx.shape[0], self.n)]
        mine = held[first]
        return torch.where(mine, loc[first], 0), mine

    def from_owners(self, t: torch.Tensor, idx: torch.Tensor):
        """``t`` (one entry per index, this shard's rows ``rows_at(idx)``)
        with each entry taken from the shard that holds row ``idx``: one
        ``all_gather``; booleans as uint8."""
        parts = self.gather(t.to(torch.uint8) if t.dtype == torch.bool
                            else t).reshape(self.count, *t.shape)
        out = parts[torch.div(idx, self.n, rounding_mode="floor"),
                    torch.arange(idx.shape[0], device=idx.device)]
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def sharded(self, local: torch.Tensor) -> DTensor:
        """A local (n, ...) result as a ``DTensor`` placed like the
        grid."""
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False)


def _full(t, mesh):
    """The whole of ``t``: a ``DTensor``'s blocks all-gathered over each
    mesh axis of more than one rank its dim 0 is split over (the
    ``model`` axis for ``shard_state``'s factor rows)."""
    if not isinstance(t, DTensor):
        return t
    return _gather(t.to_local(), [
        mesh.get_group(dim) for dim in reversed(range(mesh.ndim))
        if isinstance(t.placements[dim], Shard) and mesh.size(dim) > 1])


def _full_states(states, mesh):
    """Each state (a ``GPState``, an ``OracleState``) with its tensors
    whole."""
    return tuple(type(st)(*(_full(t, mesh) for t in st)) for st in states)


def _split_posterior(kernels, states, sh: _Shards, beta):
    """``(Q, mu, sigma, Vs)`` of the local rows with the factor
    contraction split over the ``model`` axis: this rank's block of
    ``Linv`` rows and ``w`` gives the partial ``w.V`` and ``sum V^2``,
    one ``all_reduce(SUM)`` per GP adds the blocks."""
    grid, m, M = sh.grid, sh.model_index, sh.model
    rows = []
    for kern, st in zip(kernels, states):
        cap = st.capacity
        if cap % M:
            raise ValueError(f"capacity {cap} does not split over {M} "
                             "model ranks")
        blk = slice(m * cap // M, (m + 1) * cap // M)
        mask = row_mask(st)[:, None]
        V = st.Linv[blk] @ (_grid_gram(kern, st.X, grid) * mask)
        part = torch.stack([V.T @ st.w[blk], torch.sum(V * V, dim=0)])
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=sh.model_group)
        sigma = torch.sqrt(torch.clamp(kern.Kdiag(grid) - part[1], min=0.0))
        rows.append(torch.stack([part[0] - beta * sigma,
                                 part[0] + beta * sigma]))
    out = torch.stack(rows)                                  # (G, 2, n)
    l, u = out[:, 0], out[:, 1]
    Q = out.permute(2, 0, 1).reshape(sh.n, -1)
    return Q, (l + u) * 0.5, (u - l) / (2.0 * beta), [None] * len(kernels)


def _view(states, grid, fmin, scaling):
    """``(sh, states, fmin, scaling)``: the rank's view, the full states
    and the local thresholds and scales."""
    sh = _Shards(grid)
    return sh, _full_states(states, sh.mesh), _local(fmin), _local(scaling)


def _setup(kernels, states, grid, fmin, scaling, beta):
    """``(sh, states, fmin, scaling, Q, mu, sigma, Vs)``: ``_view`` and
    the local intervals."""
    sh, states, fmin, scaling = _view(states, grid, fmin, scaling)
    if sh.model > 1:
        Q, mu, sigma, Vs = _split_posterior(kernels, states, sh, beta)
    else:
        Q, mu, sigma, Vs = _grid_posterior(kernels, states, sh.grid, beta)
    return sh, states, fmin, scaling, Q, mu, sigma, Vs


def _first_max(sh: _Shards, value: torch.Tensor):
    """``(index, value)``: the first global maximum of the local
    ``value`` rows across the shards (``argmax``'s rule)."""
    i = torch.argmax(value)
    pairs = sh.gather(torch.stack([value[i].to(torch.float64),
                                   (sh.offset + i).to(torch.float64)])[None])
    best = torch.max(pairs[:, 0])
    at = torch.min(torch.where(pairs[:, 0] == best, pairs[:, 1],
                               float("inf")))
    return at.to(torch.int64), best.to(value.dtype)


def _predicates(kernels, states, sh, unsafe, any_unsafe, mu, sigma, fmin,
                beta, lipschitz, Xc, ucs, Vs):
    """(C,) global expander predicate of candidates at ``Xc`` with upper
    bounds ``ucs`` (G, C): the local rows' per-GP tests (or ``mindist``)
    reduced over the grid shards."""
    if lipschitz is None:
        per = sh.reduce(_gp_predicates(kernels, states, sh.grid, unsafe, mu,
                                       sigma, fmin, beta, Xc, ucs, Vs),
                        "max")
        pred = torch.ones(Xc.shape[0], dtype=torch.bool, device=Xc.device)
        for i in range(len(kernels)):
            pred &= per[i] | (fmin[i] == _NINF)
    else:
        pred = _lipschitz_predicate(
            sh.reduce(_mindist(sh.grid, unsafe, Xc), "min"), any_unsafe,
            ucs, lipschitz, fmin)
    return pred & torch.any(fmin > _NINF)


def _offer(sh, key, lidx, grid, Q, chunk: int):
    """This shard's (chunk, 2 + d + G) float64 offer: key, global index,
    coordinates and upper bounds of its candidates ``lidx`` (local
    indices in its visit order), padded with key -inf and index -1."""
    d, G = grid.shape[1], Q.shape[1] // 2
    out = torch.full((chunk, 2 + d + G), _NINF, dtype=torch.float64,
                     device=grid.device)
    out[:, 1] = -1.0
    c = lidx.shape[0]
    if c:
        out[:c, 0] = key[lidx].to(torch.float64)
        out[:c, 1] = (sh.offset + lidx).to(torch.float64)
        out[:c, 2:2 + d] = grid[lidx].to(torch.float64)
        out[:c, 2 + d:] = Q[lidx][:, 1::2].to(torch.float64)
    return out


def merge_top(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The order of gathered top-k offers under ``top_k``'s rule: value
    descending, the *smaller* global index first on exact ties (padding
    offers, value -inf and index inf, last). ``merge_order`` is the
    walk's, with the opposite tie rule."""
    by_index = torch.sort(index, stable=True).indices
    return by_index[torch.sort(values[by_index], descending=True,
                               stable=True).indices]


def merge_order(keys: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The order of the gathered offers in the global visit order: key
    descending, the larger global index first on exact ties (padding
    offers, key -inf and index -1, last)."""
    by_index = torch.sort(index, descending=True, stable=True).indices
    return by_index[torch.sort(keys[by_index], descending=True,
                               stable=True).indices]


def _walk(kernels, states, sh, Q, unsafe, mu, sigma, Vs, fmin, beta,
          lipschitz, cand, width, chunk: int):
    """``(G, chunks)``: the local rows of ``_find_first_expander``'s G,
    the first candidate in the global visit order whose predicate holds,
    found a global chunk at a time."""
    grid, dev = sh.grid, sh.grid.device
    G = torch.zeros((sh.n,), dtype=torch.bool, device=dev)
    counts = sh.gather(torch.stack([torch.sum(cand),
                                    torch.any(unsafe).long()])[None])
    counts = counts.tolist()
    host_syncs.add()
    n_rank = [c[0] for c in counts]
    n_cand = sum(n_rank)
    if n_cand == 0 or not any(c[1] for c in counts):
        return G, 0
    any_unsafe = torch.ones((), dtype=torch.bool, device=dev)
    d = grid.shape[1]
    mine = n_rank[sh.index]
    key = torch.where(cand, width, _NINF)
    order = _visit_order(key, min(chunk, mine)) if mine else None
    taken = [0] * sh.count
    pos = chunks = 0
    while pos < n_cand:
        C = min(chunk, n_cand - pos)
        at = taken[sh.index]
        if mine and at + chunk > order.shape[0] and order.shape[0] < mine:
            order = _visit_order(key, mine)        # once, if round 0 failed
        lidx = (order[at:at + chunk] if mine
                else torch.zeros(0, dtype=torch.int64, device=dev))
        offers = sh.gather(_offer(sh, key, lidx, grid, Q, chunk))
        sel = merge_order(offers[:, 0], offers[:, 1])[:C]
        gidx = offers[sel, 1].to(torch.int64)
        Xc = offers[sel, 2:2 + d].to(grid.dtype)
        ucs = offers[sel, 2 + d:].to(Q.dtype).T
        pred = _predicates(kernels, states, sh, unsafe, any_unsafe, mu,
                           sigma, fmin, beta, lipschitz, Xc, ucs, Vs)
        took = torch.bincount(sel // chunk, minlength=sh.count)
        flags = torch.cat([torch.any(pred).long().reshape(1),
                           torch.argmax(pred.to(torch.int32)).reshape(1),
                           took]).tolist()         # one host sync a round
        host_syncs.add()
        chunks += 1
        if flags[0]:
            win = int(gidx[flags[1]])
            if sh.offset <= win < sh.offset + sh.n:
                G[win - sh.offset] = True
            return G, chunks
        taken = [t + k for t, k in zip(taken, flags[2:])]
        pos += chunk
    return G, chunks


def _stats(sh, S, M, G):
    """Global ``(|S|, |M|, any G)`` from one ``all_reduce(SUM)``."""
    s = sh.reduce(torch.stack([torch.sum(S), torch.sum(M),
                               torch.any(G).long()]), "sum")
    return s[0], s[1], s[2] > 0


def _result(sh, Q, S, M, G, next_idx, has_safe, chunks) -> StepResult:
    safe_count, maximizer_count, expander_found = _stats(sh, S, M, G)
    diag = torch.stack([has_safe.to(torch.int32), next_idx.to(torch.int32),
                        safe_count.to(torch.int32),
                        maximizer_count.to(torch.int32),
                        expander_found.to(torch.int32)])
    return StepResult(Q=sh.sharded(Q), S=sh.sharded(S), M=sh.sharded(M),
                      G=sh.sharded(G), next_idx=next_idx, has_safe=has_safe,
                      safe_count=safe_count, maximizer_count=maximizer_count,
                      expander_found=expander_found, diag=diag,
                      walk_chunks=chunks)


def _decide(kernels, states, sh, Q, mu, sigma, Vs, fmin, beta, scaling,
            threshold, lipschitz, ucb, use_lipschitz, chunk, valid, S=None):
    """``safe_opt_core._decide`` on the local rows: classification (with
    ``S`` given or from the strict test), the global walk and the first
    global maximum; the sharded ``StepResult``."""
    S, M, cand, width, has_safe = _classify(
        Q, fmin, scaling, _local(threshold), beta, S=S, valid=valid,
        combine=sh.reduce)
    if ucb:
        G = torch.zeros_like(S)
        M = torch.zeros_like(S)   # ucb never populates M/G (gp_opt.py:670)
        chunks = 0
        value = torch.where(S, Q[:, 1], _NINF)
    else:
        lip = _local(lipschitz) if use_lipschitz else None
        G, chunks = _walk(kernels, states, sh, Q, _unsafe(S, valid), mu,
                          sigma, Vs, fmin, beta, lip, cand, width, chunk)
        value = torch.where(M | G, torch.amax((Q[:, 1::2] - Q[:, 0::2])
                                              / scaling, dim=1), _NINF)
    next_idx, _ = _first_max(sh, value)
    return _result(sh, Q, S, M, G, next_idx, has_safe, chunks)


def safeopt_step(kernels, states, grid, fmin, beta: float, scaling,
                 threshold, lipschitz=None, num_valid=None, *,
                 ucb: bool = False, use_lipschitz: bool = False,
                 chunk: int = 64) -> StepResult:
    """``safe_opt_core.safeopt_step`` on a ``DTensor`` grid: every rank
    calls it with the same arguments (states, thresholds and the like
    whole or as ``shard_state``/``replicate`` placed them) and gets the
    same ``next_idx`` and scalars, and its rows of Q, S, M and G."""
    sh, states, fmin, scaling, Q, mu, sigma, Vs = _setup(
        kernels, states, grid, fmin, scaling, beta)
    return _decide(kernels, states, sh, Q, mu, sigma, Vs, fmin, beta,
                   scaling, threshold, lipschitz, ucb, use_lipschitz, chunk,
                   sh.valid(num_valid))


def safe_maximum(kernels, states, grid, fmin, beta: float, num_valid=None):
    """``safe_opt_core.safe_maximum`` on a ``DTensor`` grid: the global
    index and lower bound, ``has_safe`` and ``diag`` on every rank, Q and
    S sharded like the grid."""
    sh, _, fmin, _, Q, _, _, _ = _setup(kernels, states, grid, fmin, None,
                                        beta)
    S = torch.all(Q[:, 0::2] > fmin, dim=1)
    valid = sh.valid(num_valid)
    if valid is not None:
        S = S & valid
    idx, best = _first_max(sh, torch.where(S, Q[:, 0], _NINF))
    has_safe = sh.reduce(torch.any(S), "max")
    diag = torch.stack([idx.to(torch.float64), best.to(torch.float64),
                        has_safe.to(torch.float64)])
    return idx, best, has_safe, sh.sharded(Q), sh.sharded(S), diag


def full_expander_sets(kernels, states, grid, fmin, beta: float, scaling,
                       lipschitz=None, num_valid=None, *,
                       use_lipschitz: bool = False,
                       chunk: int = 64) -> StepResult:
    """``safe_opt_core.full_expander_sets`` on a ``DTensor`` grid: the
    safe rows of every shard, in global order and cut into the same
    chunks as on one device, each tested against every shard's unsafe
    rows."""
    sh, states, fmin, scaling, Q, mu, sigma, Vs = _setup(
        kernels, states, grid, fmin, scaling, beta)
    l, u = Q[:, 0::2], Q[:, 1::2]
    valid = sh.valid(num_valid)
    S = torch.all(l > fmin, dim=1)
    if valid is not None:
        S = S & valid
    has_safe = sh.reduce(torch.any(S), "max")
    best_l0 = sh.reduce(torch.max(torch.where(S, l[:, 0], _NINF)), "max")
    M = S & (u[:, 0] >= best_l0) & has_safe
    unsafe = _unsafe(S, valid)
    lip = _local(lipschitz) if use_lipschitz else None
    any_unsafe = sh.reduce(torch.any(unsafe), "max")

    # every shard's safe rows, padded to the largest count, in row order
    safe_idx = torch.nonzero(S).squeeze(1)
    width = int(sh.reduce(torch.tensor(safe_idx.shape[0],
                                       device=S.device), "max"))
    host_syncs.add()
    G = torch.zeros_like(S)
    chunks = 0
    if width:
        offers = sh.gather(_offer(sh, torch.zeros_like(Q[:, 0]), safe_idx,
                                  sh.grid, Q, width))
        offers = offers[offers[:, 1] >= 0]
        d = sh.grid.shape[1]
        preds: List[torch.Tensor] = []
        for s in range(0, offers.shape[0], chunk):
            part = offers[s:s + chunk]
            preds.append(_predicates(
                kernels, states, sh, unsafe, any_unsafe, mu, sigma, fmin,
                beta, lip, part[:, 2:2 + d].to(sh.grid.dtype),
                part[:, 2 + d:].to(Q.dtype).T, Vs))
            chunks += 1
        pred = torch.cat(preds)
        gidx = offers[:, 1].to(torch.int64) - sh.offset
        mine = (gidx >= 0) & (gidx < sh.n)
        G[gidx[mine]] = pred[mine]
    G = G & has_safe
    next_idx = torch.zeros((), dtype=torch.int64, device=S.device)
    return _result(sh, Q, S, M, G, next_idx, has_safe, chunks)


def boundary_scan(kernels, states, grid, fmin, beta: float, scaling, band,
                  num_valid=None, *, k: int = 128):
    """``safe_opt_core.boundary_scan`` on a ``DTensor`` grid: Q sharded
    like the grid, the global triage (``idx``, ``within``,
    ``total_within``) the same on every rank."""
    sh, states, fmin, scaling = _view(states, grid, fmin, scaling)
    Q = _grid_posterior(kernels, states, sh.grid, beta)[0]
    return (sh.sharded(Q), *_band_triage(Q, None, fmin, scaling, band, k,
                                         sh.valid(num_valid), sh))


def safeopt_step_from_Q(kernels, states, grid, Q, fix_idx, fix_bits, fmin,
                        beta: float, scaling, threshold, lipschitz=None,
                        num_valid=None, *, ucb: bool = False,
                        use_lipschitz: bool = False,
                        chunk: int = 64) -> StepResult:
    """``safe_opt_core.safeopt_step_from_Q`` on a ``DTensor`` grid, with
    ``Q`` sharded like it (or this rank's rows) and the global
    ``fix_idx``/``fix_bits`` the same on every rank: each rank writes the
    bits of the rows it holds."""
    sh, states, fmin, scaling = _view(states, grid, fmin, scaling)
    Q, valid = _local(Q), sh.valid(num_valid)
    mu, sigma = _moments_from_Q(Q, beta)
    S = _fix_safe_set(Q, fmin, _local(fix_idx), _local(fix_bits), valid,
                      sh.offset)
    return _decide(kernels, states, sh, Q, mu, sigma, [None] * len(kernels),
                   fmin, beta, scaling, threshold, lipschitz, ucb,
                   use_lipschitz, chunk, valid, S=S)


def certified_scan(kernels, states, grid, fmin, beta: float, scaling,
                   threshold, band, lipschitz=None, num_valid=None,
                   refine_band=None, *, k: int = 128, refine_k: int = 0,
                   refine_band_k: int = 0, ucb: bool = False,
                   use_lipschitz: bool = False, chunk: int = 64,
                   interval_precision=None):
    """``safe_opt_core.certified_scan`` on a ``DTensor`` grid: the
    sharded step and the same ``packed`` on every rank."""
    sh, states, fmin, scaling = _view(states, grid, fmin, scaling)
    valid = sh.valid(num_valid)
    Q, mu, sigma, Vs, refine_pop, refined_idx = _scan_intervals(
        kernels, states, sh.grid, fmin, beta, scaling, band, refine_band,
        refine_k, refine_band_k, interval_precision, valid, sh)
    res = _decide(kernels, states, sh, Q, mu, sigma, Vs, fmin, beta, scaling,
                  threshold, lipschitz, ucb, use_lipschitz, chunk, valid)
    idx, within, total_within = _band_triage(Q, refined_idx, fmin, scaling,
                                             band, k, valid, sh)
    S_at = sh.from_owners(res.S.to_local()[sh.rows_at(idx)], idx)
    return res, _int32(res.diag, total_within, refine_pop, idx, within, S_at)


def interval_scan(kernels, states, grid, fmin, beta: float, scaling, band,
                  num_valid=None, refine_band=None, *, k: int = 128,
                  refine_k: int = 0, refine_band_k: int = 0,
                  interval_precision=None):
    """``safe_opt_core.interval_scan`` on a ``DTensor`` grid: Q sharded
    like the grid, the same ``packed_t`` on every rank."""
    sh, states, fmin, scaling = _view(states, grid, fmin, scaling)
    valid = sh.valid(num_valid)
    Q, _, _, _, refine_pop, refined_idx = _scan_intervals(
        kernels, states, sh.grid, fmin, beta, scaling, band, refine_band,
        refine_k, refine_band_k, interval_precision, valid, sh)
    idx, within, total_within = _band_triage(Q, refined_idx, fmin, scaling,
                                             band, k, valid, sh)
    return sh.sharded(Q), _int32(total_within, refine_pop, idx, within)


def device_oracle(kernels, ostates, grid, Q, packed_t, fmin, beta: float, *,
                  constrained, k: int, kinds=None):
    """``safe_opt_core.device_oracle`` on the float64 grid sharded like
    the float32 one: the band rows' points and pass-1 bounds gathered
    from their owners, the same verdicts on every rank."""
    sh = _Shards(grid)
    return _oracle(kernels, _full_states(ostates, sh.mesh), sh.grid,
                   _local(Q), _local(packed_t), _local(fmin), beta,
                   constrained, k, kinds, sh)

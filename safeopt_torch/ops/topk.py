"""K5: exact top-k with an explicit tie rule.

Counterpart of ``safeopt_tpu/ops/topk.py:35`` (``partial_top_k``, an
XLA select equal to ``lax.top_k``). The expander walk's visit order
(width descending, larger grid index first on exact ties) rests on
``lax.top_k``'s tie rule — value descending, then index ascending —
applied to a flipped key. ``torch.topk`` promises no order among equal
values, so ``top_k`` makes the rule explicit, with no host read:
``torch.topk`` finds the k-th value, every element above it is taken
together with the lowest-index elements equal to it (a running count of
the ties), a second ``torch.topk`` over the positions gathers that small
set in index order, and a stable sort orders it by value. For k close
to n one stable sort of the whole key is cheaper.
"""

from __future__ import annotations

import torch

__all__ = ["top_k"]


def top_k(key: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest entries of rank-1 ``key``,
    ordered by value descending and then index ascending — equal to
    ``jax.lax.top_k`` including ties. Requires ``0 < k <= len(key)``."""
    n = key.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    if 4 * k >= n:
        values, indices = torch.sort(key, descending=True, stable=True)
        return values[:k], indices[:k]
    kth = torch.topk(key, k).values[-1]
    above = key > kth
    tie = key == kth
    chosen = above | (tie & (torch.cumsum(tie, 0) <= k - torch.sum(above)))
    pos = torch.arange(n, device=key.device)
    idx = torch.topk(torch.where(chosen, pos, n), k, largest=False).values
    values, order = torch.sort(key[idx], descending=True, stable=True)
    return values, idx[order]

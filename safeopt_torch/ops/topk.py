"""K5: exact top-k with an explicit tie rule.

Counterpart of ``safeopt_tpu/ops/topk.py:35`` (``partial_top_k``, an
XLA select equal to ``lax.top_k``). The expander walk's visit order
(width descending, larger grid index first on exact ties) rests on
``lax.top_k``'s tie rule — value descending, then index ascending —
applied to a flipped key. ``torch.topk`` promises no order among equal
values, so ``top_k`` makes the rule explicit: ``torch.topk`` finds the
k-th value, every element above it is taken together with the
lowest-index elements equal to it, and a stable sort orders that small
set. For k close to n one stable sort of the whole key is cheaper.
"""

from __future__ import annotations

import torch

from ..utils.observability import host_syncs

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
    above = torch.nonzero(key > kth).squeeze(1)
    ties = torch.nonzero(key == kth).squeeze(1)[: k - above.shape[0]]
    host_syncs.add(2)                        # the two nonzero sizes
    chosen = torch.sort(torch.cat([above, ties])).values  # index ascending
    values, order = torch.sort(key[chosen], descending=True, stable=True)
    return values, chosen[order]

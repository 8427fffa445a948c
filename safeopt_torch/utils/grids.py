"""Candidate-grid construction.

Counterpart of ``safeopt_tpu/utils/grids.py``. Row ordering follows
NumPy ``meshgrid`` default 'xy' indexing exactly — trajectory parity
depends on it (argmax index ties resolve by row order).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

__all__ = ["linearly_spaced_combinations"]


def linearly_spaced_combinations(bounds, num_samples):
    """Cartesian product of per-dimension linspaces.

    Parameters
    ----------
    bounds : sequence of (min, max) pairs
        One pair per input dimension.
    num_samples : int or sequence of ints
        Samples per dimension (scalar broadcasts to all dimensions).

    Returns
    -------
    combinations : ndarray, shape (prod(num_samples), len(bounds))
        One candidate input per row, in meshgrid 'xy' row order. A
        host float64 array: ``SafeOpt`` ships it to its models' device.
    """
    num_vars = len(bounds)
    if not isinstance(num_samples, Sequence) and not isinstance(
            num_samples, np.ndarray):
        num_samples = [num_samples] * num_vars

    axes = [np.linspace(lo, hi, n) for (lo, hi), n in zip(bounds, num_samples)]
    if num_vars == 1:
        return axes[0][:, None]
    mesh = np.meshgrid(*axes)  # default 'xy' indexing, like the reference
    return np.column_stack([m.ravel() for m in mesh])

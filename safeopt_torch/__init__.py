"""safeopt_torch — safe Bayesian optimization in PyTorch for NVIDIA GPUs.

The PyTorch port of ``safeopt_tpu``, beside it in the same repository.
This package holds the exact-grid main path: ``SafeOpt`` over a finite
candidate grid, with or without context columns, with ``GPRegression``
models whose kernels are the stationary families, Bias and White and
their Product/Sum algebras. Its four grid kernels are written by hand
in CUDA C++ for Hopper (``ops/csrc``), beside an exact top-k. It imports
``torch`` and never ``jax``. Models live on the card by default
(``GPRegression(X, Y)`` is on ``'cuda'``); ``device='cpu'`` runs the
kernels' plain PyTorch versions instead.

Public API mirrors the JAX package for the names this slice covers.
"""

from .algorithms import GaussianProcessOptimization, SafeOpt
from .config import JITTER, default_dtype  # also sets the precision policy
from .gp import (Bias, Cosine, Exponential, GPRegression, Matern32, Matern52,
                 Product, RBF, Sum, White)
from .utils import linearly_spaced_combinations

__version__ = "0.1.0"

__all__ = ["SafeOpt", "GaussianProcessOptimization", "GPRegression",
           "RBF", "Matern32", "Matern52", "Exponential", "Cosine", "Bias",
           "White", "Product", "Sum",
           "linearly_spaced_combinations", "default_dtype", "JITTER"]

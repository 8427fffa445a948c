"""safeopt_torch — safe Bayesian optimization in PyTorch for NVIDIA GPUs.

The PyTorch port of ``safeopt_tpu``, beside it in the same repository.
This package holds the exact-grid main path: ``SafeOpt`` over a
finite candidate grid with ``GPRegression`` models of the four
stationary kernel families, its two grid kernels written by hand in
CUDA C++ for Hopper (``ops/csrc``), and an exact top-k. It imports
``torch`` and never ``jax``. Everything a model computes lives on the
device it was created on (``GPRegression(..., device='cuda')``); CPU
tensors run the kernels' plain PyTorch versions.

Public API mirrors the JAX package for the names this slice covers.
"""

from .algorithms import GaussianProcessOptimization, SafeOpt
from .config import JITTER, default_dtype  # also sets the precision policy
from .gp import Exponential, GPRegression, Matern32, Matern52, RBF
from .utils import linearly_spaced_combinations

__version__ = "0.1.0"

__all__ = ["SafeOpt", "GaussianProcessOptimization", "GPRegression",
           "RBF", "Matern32", "Matern52", "Exponential",
           "linearly_spaced_combinations", "default_dtype", "JITTER"]

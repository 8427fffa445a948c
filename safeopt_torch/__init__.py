"""safeopt_torch — safe Bayesian optimization in PyTorch for NVIDIA GPUs.

The PyTorch port of ``safeopt_tpu``, beside it in the same repository.
This package holds both algorithms: ``SafeOpt`` over a finite candidate
grid, with or without context columns, and ``SafeOptSwarm``, whose
three constrained particle swarms (``SwarmOptimization``) search a
continuous box around an explicit safe set, each iteration one replay
of a CUDA graph on the card; each blocking, asynchronous
(``optimize_async``) or as a lag-1 campaign (``run_lagged_campaign``),
and the device-side loops ``algorithms.runner.run_safeopt_loop`` and
``run_swarmopt_loop``, with their campaign fleets in ``parallel``; its
models, exact (``GPRegression``) or sparse (``SparseGPRegression``, the
DTC approximation through m inducing points, whose pseudo-factor state
runs the same grid kernels), take every kernel family of the JAX
package and their Product/Sum algebras; ``gp`` also holds the
functional engine (``gp_fit``, ``gp_append``, ``gp_pop``) and
hyperparameter fitting (``fit_hyperparameters``: autograd and
``torch.optim.Adam`` in float64 on the card, restarts in one batch,
behind each model's ``optimize``/``optimize_restarts``). Its grid
kernels are written by hand in CUDA C++ for Hopper (``ops/csrc``),
beside an exact top-k, and registered as ``torch.library`` operators;
the GPs they do not take run on an eager route in plain PyTorch.
``utils`` samples GP-prior test functions, plots, checkpoints runs in
the JAX package's format (``utils.checkpoint``) and exports the step or
a whole campaign with ``torch.export`` (``export_step``, ``load_step``).
It imports
``torch`` and never ``jax``. Models live on the card by default
(``GPRegression(X, Y)`` is on ``'cuda'``); ``device='cpu'`` runs the
kernels' plain PyTorch versions instead.

Public API mirrors the JAX package for the names this slice covers.
"""

from .algorithms import (GaussianProcessOptimization, PendingSafeOptStep,
                         PendingSwarmIteration, SafeOpt, SafeOptSwarm,
                         SwarmOptimization, run_lagged_campaign)
from .config import JITTER, default_dtype  # also sets the precision policy
from .gp import (Bias, Cosine, Exponential, GPRegression, Linear, Matern32,
                 Matern52, MLP, Poly, Product, RatQuad, RBF,
                 SparseGPRegression, StdPeriodic, Sum, White,
                 fit_hyperparameters)
from .utils import (linearly_spaced_combinations, plot_2d_gp, plot_3d_gp,
                    plot_contour_gp, sample_gp_function)

__version__ = "0.1.0"

__all__ = ["SafeOpt", "PendingSafeOptStep", "GaussianProcessOptimization",
           "SafeOptSwarm", "PendingSwarmIteration", "SwarmOptimization",
           "run_lagged_campaign", "GPRegression", "SparseGPRegression",
           "fit_hyperparameters", "RBF", "Matern32",
           "Matern52", "Exponential", "RatQuad", "Cosine", "StdPeriodic",
           "Linear", "Poly", "MLP", "Bias", "White", "Product", "Sum",
           "linearly_spaced_combinations", "sample_gp_function",
           "plot_2d_gp", "plot_3d_gp", "plot_contour_gp", "default_dtype",
           "JITTER"]

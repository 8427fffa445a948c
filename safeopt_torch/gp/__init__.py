"""GP engine of the PyTorch port: kernels, host f64 factor, exact and
sparse (DTC) regression, the functional engine and hyperparameter
fitting."""

from .hyperopt import (fit_hyperparameters, log_marginal_likelihood,
                       sparse_log_marginal_likelihood)
from .kernels import (Bias, Cosine, Exponential, Kernel, Linear, Matern32,
                      Matern52, MLP, Poly, Product, RatQuad, RBF,
                      StdPeriodic, Sum, White, kernel_leaves, with_leaves)
from .regression import (GPRegression, GPState, gp_append, gp_fit, gp_pop,
                         gp_predict, predict_from_factors)
from .sparse import SparseGPRegression

__all__ = ["RBF", "Matern32", "Matern52", "Exponential", "RatQuad",
           "Cosine", "StdPeriodic", "Linear", "Poly", "MLP", "Bias",
           "White", "Product", "Sum", "Kernel", "kernel_leaves",
           "with_leaves", "GPRegression", "SparseGPRegression", "GPState",
           "gp_fit", "gp_append", "gp_pop", "gp_predict",
           "predict_from_factors", "fit_hyperparameters",
           "log_marginal_likelihood", "sparse_log_marginal_likelihood"]

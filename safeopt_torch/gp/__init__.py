"""GP engine of the PyTorch port: kernels, host f64 factor, exact
regression and its functional engine."""

from .kernels import (Bias, Cosine, Exponential, Kernel, Linear, Matern32,
                      Matern52, MLP, Poly, Product, RatQuad, RBF,
                      StdPeriodic, Sum, White)
from .regression import (GPRegression, GPState, gp_append, gp_fit, gp_pop,
                         gp_predict, predict_from_factors)

__all__ = ["RBF", "Matern32", "Matern52", "Exponential", "RatQuad",
           "Cosine", "StdPeriodic", "Linear", "Poly", "MLP", "Bias",
           "White", "Product", "Sum", "Kernel", "GPRegression", "GPState",
           "gp_fit", "gp_append", "gp_pop", "gp_predict",
           "predict_from_factors"]

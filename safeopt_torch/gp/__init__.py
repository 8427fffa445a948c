"""GP engine of the PyTorch port: kernels, host f64 factor, regression."""

from .kernels import (Bias, Cosine, Exponential, Kernel, Matern32, Matern52,
                      Product, RBF, Sum, White)
from .regression import GPRegression, GPState

__all__ = ["Kernel", "RBF", "Matern32", "Matern52", "Exponential", "Cosine",
           "Bias", "White", "Product", "Sum", "GPRegression", "GPState"]

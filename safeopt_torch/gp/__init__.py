"""GP engine of the PyTorch port: kernels, host f64 factor, regression."""

from .kernels import Exponential, Kernel, Matern32, Matern52, RBF
from .regression import GPRegression, GPState

__all__ = ["Kernel", "RBF", "Matern32", "Matern52", "Exponential",
           "GPRegression", "GPState"]

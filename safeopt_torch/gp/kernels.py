"""Covariance kernels for the PyTorch port.

Counterpart of ``safeopt_tpu/gp/kernels.py``: ``Kernel`` (with ``*``
and ``+`` building ``Product`` and ``Sum``), ``_Stationary`` (scalar or
ARD lengthscales, ``active_dims``, ``copy``), the stationary families
RBF, Matern-3/2, Matern-5/2, Exponential and Cosine, the constant
``Bias`` and ``White`` noise. Hyperparameters are float64 CPU tensors;
``K`` and ``Kdiag`` cast them to the dtype and device of their inputs.

``K`` keeps the JAX package's gram form, ``|x|^2 + |z|^2 - 2 x.z^T``
with the cross term as one matrix product, so that it agrees with the
JAX ``kernel.K`` to round-off. The grid-sized passes in ``ops/`` use
the difference form instead (see ``ops/fused_posterior.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["Kernel", "RBF", "Matern32", "Matern52", "Exponential", "Cosine",
           "Bias", "White", "Product", "Sum"]


def _as_active_dims(active_dims, input_dim: int) -> Tuple[int, ...]:
    if active_dims is None:
        return tuple(range(input_dim))
    dims = tuple(int(d) for d in active_dims)
    if len(dims) != input_dim:
        raise ValueError(
            "active_dims must have length input_dim "
            f"({len(dims)} != {input_dim})"
        )
    return dims


def _slice_active(X: torch.Tensor, active_dims: Tuple[int, ...]):
    X = torch.atleast_2d(X)
    if X.shape[1] == len(active_dims) and active_dims == tuple(
            range(len(active_dims))):
        return X
    return X[:, list(active_dims)]


class Kernel:
    """Base class for covariance kernels (GPy ``kern`` API surface)."""

    #: number of input dimensions this kernel operates on
    input_dim: int
    #: columns of the full input this kernel reads
    active_dims: Tuple[int, ...]

    def K(self, X, X2=None) -> torch.Tensor:
        """Cross-covariance matrix k(X, X2); X2=None means k(X, X)."""
        raise NotImplementedError

    def Kdiag(self, X) -> torch.Tensor:
        """Diagonal of k(X, X) — the prior variance at each input."""
        raise NotImplementedError

    def __mul__(self, other: "Kernel") -> "Product":
        return Product(self, other)

    def __add__(self, other: "Kernel") -> "Sum":
        return Sum(self, other)


class _Stationary(Kernel):
    """Shared machinery for stationary kernels k(x, z) = f(r).

    ``r^2`` is the lengthscale-scaled squared Euclidean distance over
    the kernel's active dims.
    """

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD = bool(ARD)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else type(self).__name__.lower()

        f64 = torch.float64
        self.variance = torch.as_tensor(variance, dtype=f64).reshape(())
        if lengthscale is None:
            lengthscale = torch.ones(self.input_dim) if self.ARD else 1.0
        lengthscale = torch.as_tensor(lengthscale, dtype=f64)
        if self.ARD:
            self.lengthscale = torch.broadcast_to(
                lengthscale.reshape(-1), (self.input_dim,)).clone()
        else:
            self.lengthscale = lengthscale.reshape(())

    def copy(self) -> "_Stationary":
        """Independent copy (GPy ``kern.copy()``)."""
        return type(self)(self.input_dim, variance=self.variance.clone(),
                          lengthscale=self.lengthscale.clone(),
                          ARD=self.ARD, active_dims=self.active_dims,
                          name=self.name)

    # -- gram construction ------------------------------------------------
    def _scaled(self, X: torch.Tensor) -> torch.Tensor:
        return _slice_active(X, self.active_dims) / self.lengthscale.to(X)

    def _r2(self, X, X2=None) -> torch.Tensor:
        Xs = self._scaled(X)
        Zs = Xs if X2 is None else self._scaled(X2)
        # |x|^2 + |z|^2 - 2 x.z^T, as in the JAX package's _r2
        xn = torch.sum(Xs * Xs, dim=1, keepdim=True)
        zn = torch.sum(Zs * Zs, dim=1, keepdim=True)
        r2 = xn + zn.T - 2.0 * (Xs @ Zs.T)
        return torch.clamp(r2, min=0.0)

    def _K_of_r2(self, r2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def K(self, X, X2=None) -> torch.Tensor:
        return self._K_of_r2(self._r2(X, X2))

    def Kdiag(self, X) -> torch.Tensor:
        X = torch.atleast_2d(X)
        return self.variance.to(X).expand(X.shape[0]).clone()

    def __repr__(self):
        return (
            f"{type(self).__name__}(input_dim={self.input_dim}, "
            f"variance={self.variance}, lengthscale={self.lengthscale}, "
            f"ARD={self.ARD}, active_dims={self.active_dims})"
        )


class RBF(_Stationary):
    """Squared-exponential kernel: k(r) = variance * exp(-r^2 / 2)."""

    def _K_of_r2(self, r2):
        return self.variance.to(r2) * torch.exp(-0.5 * r2)


class Matern32(_Stationary):
    """Matern-3/2: k(r) = variance * (1 + sqrt(3) r) * exp(-sqrt(3) r)."""

    def _K_of_r2(self, r2):
        r = torch.sqrt(r2 + 1e-36)
        s3r = math.sqrt(3.0) * r
        return self.variance.to(r2) * (1.0 + s3r) * torch.exp(-s3r)


class Matern52(_Stationary):
    """Matern-5/2: k(r) = variance * (1 + sqrt(5) r + 5 r^2 / 3)
    * exp(-sqrt(5) r)."""

    def _K_of_r2(self, r2):
        r = torch.sqrt(r2 + 1e-36)
        s5r = math.sqrt(5.0) * r
        return self.variance.to(r2) * (1.0 + s5r + (5.0 / 3.0) * r2) \
            * torch.exp(-s5r)


class Exponential(_Stationary):
    """Exponential (Matern-1/2): k(r) = variance * exp(-r)."""

    def _K_of_r2(self, r2):
        r = torch.sqrt(r2 + 1e-36)
        return self.variance.to(r2) * torch.exp(-r)


class Cosine(_Stationary):
    """Cosine kernel: k(r) = variance * cos(r) (GPy.kern.Cosine).

    Restricted to ``input_dim == 1``, as in the JAX package: cos(|x - z|)
    is a valid covariance only in 1-D (its gram is indefinite for
    ``input_dim >= 2``). Apply it to one column with ``active_dims`` and
    compose with products for more.
    """

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name: Optional[str] = None):
        if int(input_dim) != 1:
            raise ValueError(
                "Cosine is a valid covariance only in 1-D (its gram is "
                "indefinite for input_dim >= 2); apply it to one column "
                "via active_dims and compose with products instead")
        super().__init__(input_dim, variance=variance,
                         lengthscale=lengthscale, ARD=ARD,
                         active_dims=active_dims, name=name)

    def _K_of_r2(self, r2):
        return self.variance.to(r2) * torch.cos(torch.sqrt(r2 + 1e-36))


class _Constant(_Stationary):
    """A kernel with a variance and no lengthscale (Bias, White)."""

    def __init__(self, input_dim, variance=1.0, active_dims=None,
                 name: Optional[str] = None):
        super().__init__(input_dim, variance=variance,
                         active_dims=active_dims, name=name)

    def copy(self) -> "_Constant":
        return type(self)(self.input_dim, variance=self.variance.clone(),
                          active_dims=self.active_dims, name=self.name)


class Bias(_Constant):
    """Constant kernel: k(x, z) = variance everywhere (GPy.kern.Bias)."""

    def K(self, X, X2=None) -> torch.Tensor:
        X = torch.atleast_2d(X)
        m = X.shape[0] if X2 is None else torch.atleast_2d(X2).shape[0]
        return self.variance.to(X).expand(X.shape[0], m).clone()


class White(_Constant):
    """White-noise kernel (GPy.kern.White): ``K(X) = variance * I`` on one
    input set and ``K(X, X2) = 0`` across two, so it only adds prior
    variance on the diagonal."""

    def K(self, X, X2=None) -> torch.Tensor:
        X = torch.atleast_2d(X)
        if X2 is None:
            return self.variance.to(X) * torch.eye(
                X.shape[0], dtype=X.dtype, device=X.device)
        return X.new_zeros((X.shape[0], torch.atleast_2d(X2).shape[0]))


class _Composite(Kernel):
    """Shared machinery of the two-part compositions Product and Sum."""

    def __init__(self, k1: Kernel, k2: Kernel):
        self.k1 = k1
        self.k2 = k2

    @property
    def input_dim(self) -> int:
        # one past the largest active dim of either part
        return max(max(self.k1.active_dims), max(self.k2.active_dims)) + 1

    @property
    def active_dims(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.k1.active_dims)
                            | set(self.k2.active_dims)))

    def copy(self) -> "_Composite":
        """Independent copy of both parts."""
        return type(self)(self.k1.copy(), self.k2.copy())

    def __repr__(self):
        return f"{type(self).__name__}({self.k1!r}, {self.k2!r})"


class Product(_Composite):
    """Product composition ``k1 * k2``; the reference's contextual kernel
    is ``RBF(active_dims=[0]) * RBF(active_dims=[1])``."""

    def K(self, X, X2=None) -> torch.Tensor:
        return self.k1.K(X, X2) * self.k2.K(X, X2)

    def Kdiag(self, X) -> torch.Tensor:
        return self.k1.Kdiag(X) * self.k2.Kdiag(X)


class Sum(_Composite):
    """Sum composition ``k1 + k2`` (GPy ``kern + kern``)."""

    def K(self, X, X2=None) -> torch.Tensor:
        return self.k1.K(X, X2) + self.k2.K(X, X2)

    def Kdiag(self, X) -> torch.Tensor:
        return self.k1.Kdiag(X) + self.k2.Kdiag(X)

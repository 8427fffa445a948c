"""Covariance kernels for the PyTorch port.

Counterpart of ``safeopt_tpu/gp/kernels.py``: ``Kernel`` (with ``*``
and ``+`` building ``Product`` and ``Sum``), ``_Stationary`` (scalar or
ARD lengthscales, ``active_dims``, ``copy``), the stationary families
RBF, Matern-3/2, Matern-5/2, Exponential, RatQuad and Cosine, the
constant ``Bias`` and ``White`` noise, the periodic ``StdPeriodic`` and
the dot-product families ``Linear``, ``Poly`` and ``MLP``.
Hyperparameters are float64 CPU tensors; ``K`` and ``Kdiag`` cast them
to the dtype and device of their inputs; that cast is differentiable, so
``kernel_leaves`` / ``with_leaves`` (the JAX pytree's flatten order)
carry tensors that require grad through ``K`` and ``Kdiag`` for
``hyperopt.py``. The grid kernels (``ops/``)
take the first four families, Cosine and Bias; SafeOpt runs every other
GP on its eager route (``algorithms/safe_opt_core.py``), as the JAX
package runs them on XLA.

``K`` keeps the JAX package's gram form, ``|x|^2 + |z|^2 - 2 x.z^T``
with the cross term as one matrix product, so that it agrees with the
JAX ``kernel.K`` to round-off. The grid-sized passes in ``ops/`` use
the difference form instead (see ``ops/fused_posterior.py``).
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["Kernel", "RBF", "Matern32", "Matern52", "Exponential",
           "RatQuad", "Cosine", "StdPeriodic", "Linear", "Poly", "MLP",
           "Bias", "White", "Product", "Sum", "kernel_leaves", "with_leaves"]


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
    """The columns ``active_dims`` of ``X``: ``X`` itself, a slice, or the
    columns stacked (a list index would be a tensor constant, which the
    body of a traced loop cannot hold)."""
    X = torch.atleast_2d(X)
    if X.shape[1] == len(active_dims) and active_dims == tuple(
            range(len(active_dims))):
        return X
    lo, n = active_dims[0], len(active_dims)
    if active_dims == tuple(range(lo, lo + n)):
        return X[:, lo:lo + n]
    return torch.stack([X[:, c] for c in active_dims], dim=1)


def _f64(value) -> torch.Tensor:
    """A hyperparameter as a float64 CPU tensor (a copy)."""
    return torch.as_tensor(value, dtype=torch.float64).clone()


def _per_dim(value, ard: bool, input_dim: int) -> torch.Tensor:
    """A hyperparameter that is one value per input dimension under
    ``ard`` and a scalar otherwise, as a float64 CPU tensor."""
    value = _f64(value)
    if ard:
        return torch.broadcast_to(value.reshape(-1), (input_dim,)).clone()
    return value.reshape(())


def _pair(kernel, X, X2):
    """The active columns of ``X`` and of ``X2`` (``X``'s when None)."""
    Xa = _slice_active(X, kernel.active_dims)
    return Xa, (Xa if X2 is None else _slice_active(X2, kernel.active_dims))


class Kernel:
    """Base class for covariance kernels (GPy ``kern`` API surface)."""

    #: number of input dimensions this kernel operates on
    input_dim: int
    #: columns of the full input this kernel reads
    active_dims: Tuple[int, ...]
    #: hyperparameter attributes in the JAX pytree's flatten order
    _leaves: Tuple[str, ...] = ()

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

    _leaves = ("variance", "lengthscale")

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
        # jnp.maximum's gradient at a tie (r2 == 0, the diagonal) is one
        # half, as torch.maximum's is; torch.clamp's would be one
        return torch.maximum(r2, r2.new_zeros(()))

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


class RatQuad(_Stationary):
    """Rational quadratic: k(r) = variance * (1 + r^2 / 2)^(-power)
    (GPy.kern.RatQuad)."""

    _leaves = ("variance", "lengthscale", "power")

    def __init__(self, input_dim, variance=1.0, lengthscale=None,
                 power=2.0, ARD=False, active_dims=None,
                 name: Optional[str] = None):
        super().__init__(input_dim, variance=variance,
                         lengthscale=lengthscale, ARD=ARD,
                         active_dims=active_dims, name=name or "ratquad")
        self.power = _f64(power).reshape(())

    def copy(self) -> "RatQuad":
        return RatQuad(self.input_dim, variance=self.variance.clone(),
                       lengthscale=self.lengthscale.clone(),
                       power=self.power.clone(), ARD=self.ARD,
                       active_dims=self.active_dims, name=self.name)

    def _K_of_r2(self, r2):
        return self.variance.to(r2) * (1.0 + 0.5 * r2) ** (
            -self.power.to(r2))


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


class StdPeriodic(Kernel):
    """Standard periodic kernel (GPy.kern.StdPeriodic):
    ``variance * exp(-0.5 * sum_j (sin(pi (x_j - z_j) / period_j) /
    lengthscale_j)^2)``; ``ARD1`` makes ``period`` one value per input
    dimension, ``ARD2`` the ``lengthscale``."""

    _leaves = ("variance", "period", "lengthscale")

    def __init__(self, input_dim, variance=1.0, period=None,
                 lengthscale=None, ARD1=False, ARD2=False,
                 active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD1 = bool(ARD1)
        self.ARD2 = bool(ARD2)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "std_periodic"
        self.variance = _f64(variance).reshape(())
        if period is None:
            period = torch.ones(self.input_dim) if self.ARD1 else 2 * math.pi
        self.period = _per_dim(period, self.ARD1, self.input_dim)
        if lengthscale is None:
            lengthscale = torch.ones(self.input_dim) if self.ARD2 else 1.0
        self.lengthscale = _per_dim(lengthscale, self.ARD2, self.input_dim)

    def copy(self) -> "StdPeriodic":
        return StdPeriodic(self.input_dim, variance=self.variance.clone(),
                           period=self.period.clone(),
                           lengthscale=self.lengthscale.clone(),
                           ARD1=self.ARD1, ARD2=self.ARD2,
                           active_dims=self.active_dims, name=self.name)

    def K(self, X, X2=None) -> torch.Tensor:
        Xa, Za = _pair(self, X, X2)
        period = torch.broadcast_to(self.period.to(Xa), (self.input_dim,))
        ls = torch.broadcast_to(self.lengthscale.to(Xa), (self.input_dim,))
        s2 = Xa.new_zeros((Xa.shape[0], Za.shape[0]))
        for j in range(self.input_dim):
            base = math.pi * (Xa[:, j, None] - Za[None, :, j]) / period[j]
            s2 = s2 + (torch.sin(base) / ls[j]) ** 2
        return self.variance.to(Xa) * torch.exp(-0.5 * s2)

    def Kdiag(self, X) -> torch.Tensor:
        X = torch.atleast_2d(X)
        return self.variance.to(X).expand(X.shape[0]).clone()

    def __repr__(self):
        return (f"StdPeriodic(input_dim={self.input_dim}, "
                f"variance={self.variance}, period={self.period}, "
                f"lengthscale={self.lengthscale}, ARD1={self.ARD1}, "
                f"ARD2={self.ARD2}, active_dims={self.active_dims})")


class Linear(Kernel):
    """Linear kernel (GPy.kern.Linear): ``sum_j variances_j x_j z_j``;
    ``ARD`` makes ``variances`` one value per input dimension. Its prior
    variance vanishes at the origin, so ``scaling='auto'`` refuses a GP
    whose kernel is Linear alone."""

    _leaves = ("variances",)

    def __init__(self, input_dim, variances=1.0, ARD=False,
                 active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD = bool(ARD)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "linear"
        self.variances = _per_dim(variances, self.ARD, self.input_dim)

    def copy(self) -> "Linear":
        return Linear(self.input_dim, variances=self.variances.clone(),
                      ARD=self.ARD, active_dims=self.active_dims,
                      name=self.name)

    def K(self, X, X2=None) -> torch.Tensor:
        Xa, Za = _pair(self, X, X2)
        return (Xa * self.variances.to(Xa)) @ Za.T

    def Kdiag(self, X) -> torch.Tensor:
        Xa = _slice_active(X, self.active_dims)
        return torch.sum(Xa * Xa * self.variances.to(Xa), dim=1)

    def __repr__(self):
        return (f"Linear(input_dim={self.input_dim}, "
                f"variances={self.variances}, ARD={self.ARD}, "
                f"active_dims={self.active_dims})")


class Poly(Kernel):
    """Polynomial kernel (GPy.kern.Poly):
    ``variance * (scale * x.z + bias)^order``. ``order`` must be a
    positive integer: a fractional power of a negative dot product is
    NaN, and NaN rows would classify unsafe without a word."""

    _leaves = ("variance", "scale", "bias")      # order stays static

    def __init__(self, input_dim, variance=1.0, scale=1.0, bias=1.0,
                 order=3.0, active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.order = float(order)
        if self.order < 1 or self.order != round(self.order):
            raise ValueError(
                f"Poly order must be a positive integer (got {order}): "
                "fractional powers of a negative dot-product are NaN")
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "poly"
        self.variance = _f64(variance).reshape(())
        self.scale = _f64(scale).reshape(())
        self.bias = _f64(bias).reshape(())

    def copy(self) -> "Poly":
        return Poly(self.input_dim, variance=self.variance.clone(),
                    scale=self.scale.clone(), bias=self.bias.clone(),
                    order=self.order, active_dims=self.active_dims,
                    name=self.name)

    def _of_dot(self, dot):
        base = self.scale.to(dot) * dot + self.bias.to(dot)
        return self.variance.to(dot) * base ** int(self.order)

    def K(self, X, X2=None) -> torch.Tensor:
        Xa, Za = _pair(self, X, X2)
        return self._of_dot(Xa @ Za.T)

    def Kdiag(self, X) -> torch.Tensor:
        Xa = _slice_active(X, self.active_dims)
        return self._of_dot(torch.sum(Xa * Xa, dim=1))

    def __repr__(self):
        return (f"Poly(input_dim={self.input_dim}, "
                f"variance={self.variance}, scale={self.scale}, "
                f"bias={self.bias}, order={self.order}, "
                f"active_dims={self.active_dims})")


class MLP(Kernel):
    """MLP (arcsine) kernel (GPy.kern.MLP):
    ``variance (2/pi) asin((w x.z + b) / sqrt((w |x|^2 + b + 1)
    (w |z|^2 + b + 1)))`` with ``w = weight_variance`` (one value per
    input dimension under ``ARD``) and ``b = bias_variance``."""

    _leaves = ("variance", "weight_variance", "bias_variance")

    def __init__(self, input_dim, variance=1.0, weight_variance=1.0,
                 bias_variance=1.0, ARD=False, active_dims=None,
                 name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD = bool(ARD)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "mlp"
        self.variance = _f64(variance).reshape(())
        self.weight_variance = _per_dim(weight_variance, self.ARD,
                                        self.input_dim)
        self.bias_variance = _f64(bias_variance).reshape(())

    def copy(self) -> "MLP":
        return MLP(self.input_dim, variance=self.variance.clone(),
                   weight_variance=self.weight_variance.clone(),
                   bias_variance=self.bias_variance.clone(), ARD=self.ARD,
                   active_dims=self.active_dims, name=self.name)

    def _wprod(self, X, X2=None) -> torch.Tensor:
        w, b = self.weight_variance.to(X), self.bias_variance.to(X)
        if X2 is None:
            return torch.sum(X * X * w, dim=1) + b
        return (X * w) @ X2.T + b

    def K(self, X, X2=None) -> torch.Tensor:
        Xa, Za = _pair(self, X, X2)
        xd = torch.sqrt(self._wprod(Xa) + 1.0)
        zd = xd if X2 is None else torch.sqrt(self._wprod(Za) + 1.0)
        cos = self._wprod(Xa, Za) / xd[:, None] / zd[None, :]
        # round-off can push coincident points past +-1
        cos = torch.clamp(cos, -1.0, 1.0)
        return self.variance.to(Xa) * (2.0 / math.pi) * torch.asin(cos)

    def Kdiag(self, X) -> torch.Tensor:
        Xa = _slice_active(X, self.active_dims)
        p = self._wprod(Xa)
        return self.variance.to(Xa) * (2.0 / math.pi) * torch.asin(
            p / (p + 1.0))

    def __repr__(self):
        return (f"MLP(input_dim={self.input_dim}, "
                f"variance={self.variance}, "
                f"weight_variance={self.weight_variance}, "
                f"bias_variance={self.bias_variance}, ARD={self.ARD}, "
                f"active_dims={self.active_dims})")


class _Composite(Kernel):
    """Shared machinery of the two-part compositions Product and Sum."""

    def __init__(self, k1: Kernel, k2: Kernel):
        self.k1 = k1
        self.k2 = k2

    @property
    def parts(self) -> Tuple[Kernel, Kernel]:
        """The two part kernels (GPy ``kern.parts``)."""
        return (self.k1, self.k2)

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


def kernel_leaves(kernel: Kernel) -> List[torch.Tensor]:
    """A kernel tree's hyperparameter tensors in the order of the JAX
    package's ``tree_flatten`` (a leaf's ``_leaves``; a Product or Sum
    its ``k1``'s, then its ``k2``'s). Static fields (``input_dim``,
    ``ARD``, ``active_dims``, Poly's ``order``) are not leaves."""
    if isinstance(kernel, _Composite):
        return kernel_leaves(kernel.k1) + kernel_leaves(kernel.k2)
    return [getattr(kernel, name) for name in kernel._leaves]


def with_leaves(kernel: Kernel, leaves: Sequence[torch.Tensor]) -> Kernel:
    """A copy of ``kernel`` holding ``leaves`` (``kernel_leaves``'s order)
    as they are: no cast and no detach, so tensors that require grad, on
    any device, carry their graph through ``K`` and ``Kdiag``."""
    leaves = list(leaves)
    if len(leaves) != len(kernel_leaves(kernel)):
        raise ValueError(f"{len(leaves)} leaves for a kernel of "
                         f"{len(kernel_leaves(kernel))}")

    def rebuild(k, it):
        if isinstance(k, _Composite):
            return type(k)(rebuild(k.k1, it), rebuild(k.k2, it))
        out = copy.copy(k)
        for name in k._leaves:
            setattr(out, name, next(it))
        return out

    return rebuild(kernel, iter(leaves))

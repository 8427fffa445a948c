"""Float64 host-side factor math (the "f64 island").

Counterpart of ``safeopt_tpu/gp/host_math.py``. The GP factor is
O(n^2) state over n <= a few hundred observations, and an f32 Cholesky
of a gram with kappa ~1e7 loses every digit or hits a negative pivot,
silently emptying the safe set. So the factor is computed and updated
on the host in NumPy/SciPy float64, and the device holds a cast copy
for the O(N) grid work (``regression.GPRegression``).

This module covers every kernel family of ``kernels.py`` and their
Product/Sum algebras on the SciPy path. The JAX package's native C++
engine (``csrc/host_factor.cpp``) is not bound here yet.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .kernels import (Bias, Cosine, Exponential, Kernel, Linear, Matern32,
                      Matern52, MLP, Poly, Product, RatQuad, RBF,
                      StdPeriodic, Sum, White)

__all__ = ["np_kernel", "np_kdiag", "HostFactor"]


def np_kernel(kernel: Kernel, X: np.ndarray, X2=None) -> np.ndarray:
    """Evaluate a kernel gram in NumPy float64 (host mirror of
    ``kernels.Kernel.K``)."""
    if isinstance(kernel, Product):
        return np_kernel(kernel.k1, X, X2) * np_kernel(kernel.k2, X, X2)
    if isinstance(kernel, Sum):
        return np_kernel(kernel.k1, X, X2) + np_kernel(kernel.k2, X, X2)
    if isinstance(kernel, White):
        n = np.atleast_2d(X).shape[0]
        if X2 is None:
            return float(kernel.variance) * np.eye(n)
        return np.zeros((n, np.atleast_2d(X2).shape[0]))
    if isinstance(kernel, Bias):
        n = np.atleast_2d(X).shape[0]
        m = n if X2 is None else np.atleast_2d(X2).shape[0]
        return float(kernel.variance) * np.ones((n, m))
    if isinstance(kernel, (StdPeriodic, Linear, Poly, MLP)):
        return _np_dot_family(kernel, X, X2)
    if not isinstance(kernel, (RBF, Matern32, Matern52, Exponential,
                               RatQuad, Cosine)):
        raise TypeError(f"no host implementation for {type(kernel).__name__}")

    ls = kernel.lengthscale.numpy()
    var = float(kernel.variance)
    dims = list(kernel.active_dims)
    Xs = np.asarray(X, dtype=np.float64)[:, dims] / ls
    Zs = Xs if X2 is None else np.asarray(X2, dtype=np.float64)[:, dims] / ls

    xn = np.sum(Xs * Xs, axis=1)[:, None]
    zn = np.sum(Zs * Zs, axis=1)[None, :]
    r2 = np.maximum(xn + zn - 2.0 * (Xs @ Zs.T), 0.0)

    if isinstance(kernel, RBF):
        return var * np.exp(-0.5 * r2)
    if isinstance(kernel, RatQuad):
        return var * (1.0 + 0.5 * r2) ** (-float(kernel.power))
    r = np.sqrt(r2)
    if isinstance(kernel, Cosine):
        return var * np.cos(r)
    if isinstance(kernel, Exponential):
        return var * np.exp(-r)
    if isinstance(kernel, Matern52):
        s5r = np.sqrt(5.0) * r
        return var * (1.0 + s5r + (5.0 / 3.0) * r2) * np.exp(-s5r)
    s3r = np.sqrt(3.0) * r
    return var * (1.0 + s3r) * np.exp(-s3r)


def _active(kernel, X, X2=None):
    """Float64 active columns of ``X`` and of ``X2`` (``X``'s when
    None)."""
    dims = list(kernel.active_dims)
    Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
    if X2 is None:
        return Xa, Xa
    return Xa, np.atleast_2d(np.asarray(X2, dtype=np.float64))[:, dims]


def _np_dot_family(kernel, X, X2):
    """Gram of a StdPeriodic, Linear, Poly or MLP leaf in float64."""
    Xa, Za = _active(kernel, X, X2)
    if isinstance(kernel, StdPeriodic):
        period = np.broadcast_to(kernel.period.numpy(), (kernel.input_dim,))
        ls = np.broadcast_to(kernel.lengthscale.numpy(), (kernel.input_dim,))
        s2 = np.zeros((Xa.shape[0], Za.shape[0]))
        for j in range(kernel.input_dim):
            base = np.pi * (Xa[:, j][:, None] - Za[:, j][None, :]) \
                / period[j]
            s2 += (np.sin(base) / ls[j]) ** 2
        return float(kernel.variance) * np.exp(-0.5 * s2)
    if isinstance(kernel, Linear):
        return (Xa * kernel.variances.numpy()) @ Za.T
    if isinstance(kernel, Poly):
        return float(kernel.variance) * (
            float(kernel.scale) * (Xa @ Za.T)
            + float(kernel.bias)) ** kernel.order
    w = kernel.weight_variance.numpy()
    b = float(kernel.bias_variance)
    xd = np.sqrt(np.sum(Xa * Xa * w, axis=1) + b + 1.0)
    zd = np.sqrt(np.sum(Za * Za * w, axis=1) + b + 1.0)
    cos = np.clip(((Xa * w) @ Za.T + b) / xd[:, None] / zd[None, :],
                  -1.0, 1.0)
    return float(kernel.variance) * (2.0 / np.pi) * np.arcsin(cos)


def np_kdiag(kernel: Kernel, X: np.ndarray) -> np.ndarray:
    """Prior variance diagonal in float64."""
    if isinstance(kernel, Product):
        return np_kdiag(kernel.k1, X) * np_kdiag(kernel.k2, X)
    if isinstance(kernel, Sum):
        return np_kdiag(kernel.k1, X) + np_kdiag(kernel.k2, X)
    if isinstance(kernel, Linear):
        Xa, _ = _active(kernel, X)
        return np.sum(Xa * Xa * kernel.variances.numpy(), axis=1)
    if isinstance(kernel, Poly):
        Xa, _ = _active(kernel, X)
        return float(kernel.variance) * (
            float(kernel.scale) * np.sum(Xa * Xa, axis=1)
            + float(kernel.bias)) ** kernel.order
    if isinstance(kernel, MLP):
        Xa, _ = _active(kernel, X)
        p = (np.sum(Xa * Xa * kernel.weight_variance.numpy(), axis=1)
             + float(kernel.bias_variance))
        return (float(kernel.variance) * (2.0 / np.pi)
                * np.arcsin(p / (p + 1.0)))
    return float(kernel.variance) * np.ones(np.atleast_2d(X).shape[0])


class HostFactor:
    """Float64 padded Cholesky factor state with exact incremental ops.

    Keeps the same invariants as the device ``GPState`` (identity rows
    beyond ``count``), so the device casts drop straight into the grid
    passes.
    """

    def __init__(self, kernel: Kernel, capacity: int, input_dim: int,
                 noise_var: float):
        self.kernel = kernel
        self.noise_var = float(noise_var)
        self.count = 0
        self.X = np.zeros((capacity, input_dim))
        self.Y = np.zeros((capacity, 1))
        self.L = np.eye(capacity)
        self.Linv = np.eye(capacity)
        self.w = np.zeros(capacity)

    @property
    def capacity(self) -> int:
        """Padded buffer size of the factor state."""
        return self.X.shape[0]

    def set_data(self, X: np.ndarray, Y: np.ndarray) -> None:
        """Full refactorization from scratch (float64 LAPACK)."""
        n = X.shape[0]
        cap = self.capacity
        if n > cap:
            raise ValueError(f"{n} rows exceed capacity {cap}")
        self.X[:] = 0.0
        self.Y[:] = 0.0
        self.X[:n] = X
        self.Y[:n] = np.asarray(Y).reshape(n, 1)
        self.count = n

        self.L = np.eye(cap)
        self.Linv = np.eye(cap)
        self.w = np.zeros(cap)
        if n == 0:
            return
        K = np_kernel(self.kernel, self.X[:n]) + self.noise_var * np.eye(n)
        L = scipy.linalg.cholesky(K, lower=True)
        self.L[:n, :n] = L
        self.Linv[:n, :n] = scipy.linalg.solve_triangular(
            L, np.eye(n), lower=True)
        self.w[:n] = self.Linv[:n, :n] @ self.Y[:n, 0]

    def append(self, x: np.ndarray, y: float) -> None:
        """Exact O(n^2) Cholesky bordering (float64)."""
        pos = self.count
        if pos + 1 > self.capacity:
            raise ValueError("capacity exceeded")
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        kvec = (np_kernel(self.kernel, self.X[:pos], x[None, :])[:, 0]
                if pos else np.zeros(0))
        kxx = np_kdiag(self.kernel, x[None, :])[0]

        c = self.Linv[:pos, :pos] @ kvec
        dd2 = kxx + self.noise_var - c @ c
        dd = np.sqrt(max(dd2, 1e-300))
        self.L[pos, :pos] = c
        self.L[pos, pos] = dd
        self.Linv[pos, :pos] = -(self.Linv[:pos, :pos].T @ c) / dd
        self.Linv[pos, pos] = 1.0 / dd
        mu_x = c @ self.w[:pos]
        self.w[pos] = (float(y) - mu_x) / dd
        self.X[pos] = x
        self.Y[pos, 0] = float(y)
        self.count = pos + 1

    def pop(self) -> None:
        """Drop the last observation (truncation; exact)."""
        if self.count == 0:
            raise ValueError("no data to remove")
        pos = self.count - 1
        self.L[pos, :] = 0.0
        self.L[pos, pos] = 1.0
        self.Linv[pos, :] = 0.0
        self.Linv[pos, pos] = 1.0
        self.w[pos] = 0.0
        self.X[pos] = 0.0
        self.Y[pos] = 0.0
        self.count = pos

    def predict(self, Xq: np.ndarray):
        """Float64 latent posterior (mu, var) at query rows."""
        n = self.count
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        kdiag = np_kdiag(self.kernel, Xq)
        if n == 0:
            return np.zeros(Xq.shape[0]), kdiag
        kvec = np_kernel(self.kernel, self.X[:n], Xq)          # (n, m)
        V = self.Linv[:n, :n] @ kvec
        mu = V.T @ self.w[:n]
        var = kdiag - np.sum(V * V, axis=0)
        return mu, np.maximum(var, 0.0)

    def posterior_cov(self, Xq: np.ndarray) -> np.ndarray:
        """Float64 full latent posterior covariance at query rows,
        ``K(Xq, Xq) - V^T V`` with ``V = Linv K(X, Xq)`` (for
        ``GPRegression.posterior_samples_f``)."""
        n = self.count
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        Kqq = np_kernel(self.kernel, Xq)
        if n == 0:
            return Kqq
        V = self.Linv[:n, :n] @ np_kernel(self.kernel, self.X[:n], Xq)
        return Kqq - V.T @ V

    def grown(self, new_capacity: int) -> "HostFactor":
        """Copy into a larger buffer (refactorizes for exactness)."""
        out = HostFactor(self.kernel, new_capacity, self.X.shape[1],
                         self.noise_var)
        out.set_data(self.X[: self.count].copy(),
                     self.Y[: self.count].copy())
        return out

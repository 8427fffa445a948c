"""Sparse (inducing-point) GP regression with the device interface of
``GPRegression``.

Counterpart of ``safeopt_tpu/gp/sparse.py``. The deterministic-training
conditional (DTC) approximation bounds a long campaign's per-iteration
cost by m inducing points:

    Sigma  = (K_ZZ + K_ZX K_XZ / s2)^-1
    mu(z)  = k_zZ alpha,              alpha = Sigma K_ZX y / s2
    var(z) = k(z,z) - k_zZ (K_ZZ^-1 - Sigma) k_Zz

``B = K_ZZ^-1 - Sigma`` is PSD, so with ``B = R^T R`` and ``w = R^-T
alpha`` the posterior takes the whitened form of a ``GPState`` whose
rows are the m inducing points and whose "triangular inverse" is R:

    V = R @ k(Z, grid);  mu = V^T w;  var = kdiag - colsum(V^2)

K1, K3, the eager route and ``SafeOpt`` run unchanged on it. R must be
LOWER-triangular: K1 and K1-3p sum only ``c <= r`` in bands of 32 rows
(``ops/csrc/intervals.cuh``), and a dense symmetric root would lose its
upper half without a word; R is the QL factor of the symmetric root.
The capacity is ``_next_capacity(m)``, so m = 64, 128, 256 fill the
buffer (``count == capacity``).

All m x m and m x n factor math runs on the host in float64, as the
exact model's does; the information state ``A``, ``b`` is a sum over
observations, so an append or a pop is a rank-1 update and only the
O(m^3) tail reruns, after which the device state is uploaded anew.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from ..config import default_dtype
from .host_math import np_kdiag, np_kernel
from .kernels import Kernel, RBF, White
from .regression import GPState, OracleState, _next_capacity, sample_latent

__all__ = ["SparseGPRegression"]


class SparseGPRegression:
    """DTC sparse GP with the ``GPRegression`` surface.

    Parameters
    ----------
    X, Y : arrays
        Training data (n can be large; a full build costs O(m^2 n)).
    kernel : Kernel, optional (default RBF)
    noise_var : float
    inducing : int or array (m, d)
        Number of inducing points (a uniform subset of X, topped up with
        jittered copies if n < m) or their locations.
    refit_every : int
        Incremental rank-1 updates between full rebuilds.
    jitter : float
        Diagonal added to ``K_ZZ``. The pseudo-factor's magnitude grows
        with ``K_ZZ``'s condition number, and the float32 grid pass
        carries that magnitude as interval noise; a warning fires once a
        model when its largest entry passes 1e4.
    conservative : float
        Safety factor ``c`` on a calibrated posterior-variance floor
        (0 = plain DTC): at every full build the model measures
        ``delta``, a statistic of ``|mu_m(X_i) - mu_2m(X_i)|`` against a
        DTC with twice the inducing points on the same data, and reports
        ``var + (c * delta)^2``. The mean is untouched. The floor is a
        ``White`` summand on ``kern``, while ``kern_base`` stays the
        data model (LML, fitting); no grid kernel takes ``White``, so a
        floored model runs on ``SafeOpt``'s eager route.
    calibration : 'max' or float in (0, 1]
        The statistic: the maximum, or that quantile (the JAX package's
        bench recommends ``conservative=0.75, calibration=0.99``).
    device : str or torch.device
        Where the device state lives: the card (``'cuda'``, the default)
        unless the caller asks for ``'cpu'``.
    dtype : torch.dtype, optional
        Device state dtype; defaults to ``config.default_dtype(device)``.
    """

    def __init__(self, X, Y, kernel: Optional[Kernel] = None,
                 noise_var: float = 1.0, inducing=16,
                 refit_every: int = 512, jitter: float = 1e-8,
                 conservative: float = 0.0, calibration="max",
                 device="cuda", dtype: Optional[torch.dtype] = None):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        if kernel is None:
            kernel = RBF(X.shape[1])
        self._conservative = float(conservative)
        if self._conservative < 0.0:
            raise ValueError("conservative inflation factor must be >= 0")
        if calibration != "max":
            calibration = float(calibration)
            if not 0.0 < calibration <= 1.0:
                raise ValueError(
                    "calibration must be 'max' or a quantile in (0, 1], "
                    f"got {calibration!r}")
        self._calibration = calibration
        self._floor = 0.0
        self.kern = kernel          # property setter: stores kern_base
        self.noise_var = float(noise_var)
        self.device = torch.device(device)
        self.dtype = dtype if dtype is not None else default_dtype(device)

        if np.isscalar(inducing):
            m = int(inducing)
            idx = np.linspace(0, X.shape[0] - 1, min(m, X.shape[0]),
                              dtype=int)
            Z = X[idx]
            if Z.shape[0] < m:   # top up with jittered copies
                rng = np.random.default_rng(0)
                extra = Z[rng.integers(0, Z.shape[0], m - Z.shape[0])]
                Z = np.vstack([Z, extra + 1e-3 * rng.normal(
                    size=extra.shape)])
        else:
            Z = np.atleast_2d(np.asarray(inducing, dtype=np.float64))
        self.Z = Z
        self._m = Z.shape[0]
        self._cap = _next_capacity(self._m)
        self._refit_every = int(refit_every)
        self._jitter = float(jitter)
        self._pending = 0
        self._factor_scale_warned = False

        self._X = X
        self._Y = Y
        self._refit()

    # -- kernel views -------------------------------------------------------

    @property
    def kern(self) -> Kernel:
        """Kernel the posterior consumers see (a ``White``-floor sum when
        the floor is on)."""
        return self._kern_eff

    @kern.setter
    def kern(self, kernel: Kernel) -> None:
        self._kern_base = kernel
        if self._conservative and self._floor > 0.0:
            self._kern_eff = kernel + White(kernel.input_dim,
                                            variance=self._floor,
                                            name="safety_floor")
        else:
            self._kern_eff = kernel

    @property
    def kern_base(self) -> Kernel:
        """The data-model kernel (LML and fitting; ``kern`` without the
        floor)."""
        return self._kern_base

    @property
    def conservative(self) -> float:
        """Safety inflation factor c (0 = plain DTC)."""
        return self._conservative

    @property
    def calibration(self):
        """Floor calibration statistic: 'max' or a quantile in (0, 1]."""
        return self._calibration

    def _calibrate_floor(self) -> None:
        """``floor = (c * delta)^2`` from a doubled-inducing DTC on the same
        data (one extra O((2m)^2 n) build, skipped at c = 0)."""
        self._floor = 0.0
        self.kern = self._kern_base        # plain view for the probe
        if not self._conservative or self._X.shape[0] <= self._m:
            return
        m2 = min(2 * self._m, self._X.shape[0])
        ref = SparseGPRegression(self._X, self._Y, self._kern_base,
                                 noise_var=self.noise_var, inducing=m2,
                                 jitter=self._jitter, device="cpu",
                                 dtype=torch.float64)
        mu_m, _ = self.predict_f64(self._X)
        mu_2m, _ = ref.predict_f64(self._X)
        err = np.abs(mu_m - mu_2m)
        if self._calibration == "max":
            delta = float(np.max(err))
        else:
            delta = float(np.quantile(err, self._calibration))
        self._floor = (self._conservative * delta) ** 2
        self.kern = self._kern_base        # rebuild the floored view

    # -- factor construction (host float64) --------------------------------

    def _refit(self) -> None:
        """Full O(m^2 n) rebuild of the information state ``A = K_ZZ +
        K_ZX K_XZ / s2``, ``b = K_ZX y``, then the posterior tail and the
        floor."""
        Z, X, Y = self.Z, self._X, self._Y
        m = Z.shape[0]
        s2 = self.noise_var
        self._Kzz = np_kernel(self._kern_base, Z) + self._jitter * np.eye(m)
        self._Kzz_cho = scipy.linalg.cho_factor(self._Kzz, lower=True)
        Kzx = np_kernel(self._kern_base, Z, X)
        self._A = self._Kzz + (Kzx @ Kzx.T) / s2
        self._b = Kzx @ Y[:, 0]
        self._pending = 0
        self._recompute_posterior()
        self._calibrate_floor()

    def _apply_rank1(self, x: np.ndarray, y: float, sign: float) -> None:
        """O(m^2) information update for one observation (+1 append, -1
        remove), then the tail, or a full rebuild every ``refit_every``."""
        kzx = np_kernel(self._kern_base, self.Z, x.reshape(1, -1))[:, 0]
        self._A += sign * np.outer(kzx, kzx) / self.noise_var
        self._b += sign * kzx * y
        self._pending += 1
        if self._pending >= self._refit_every:
            self._refit()
        else:
            self._recompute_posterior()

    def _recompute_posterior(self) -> None:
        """O(m^3) tail: the lower-triangular pseudo-factor R and the
        weights from (A, b). Every factorization here is SciPy's: numpy
        and SciPy each bundle an OpenBLAS with its own thread pool, and
        with LAPACK calls alternating between the two, as the JAX
        package's tail makes them, an append at m=64 took 129 ms on an
        H100's host (3.2 ms with SciPy alone; chip_smoke phase 16)."""
        m = self._m
        A_cho = scipy.linalg.cho_factor(self._A, lower=True)
        alpha = scipy.linalg.cho_solve(A_cho, self._b) / self.noise_var
        sigma = scipy.linalg.cho_solve(A_cho, np.eye(m))
        kzz_inv = scipy.linalg.cho_solve(self._Kzz_cho, np.eye(m))
        B = kzz_inv - sigma
        # B is PSD up to rounding; factor its symmetrized, floored form
        B = 0.5 * (B + B.T)
        evals, evecs = scipy.linalg.eigh(B, driver="evd")
        evals = np.maximum(evals, 0.0)
        R0 = (evecs * np.sqrt(evals)) @ evecs.T       # symmetric root
        # any R with R^T R = B keeps the posterior; the QL factor of the
        # symmetric root (R0 = Q L => L^T L = B) is lower-triangular, as
        # K1 needs: QL through QR of the index-reversed root
        R = scipy.linalg.qr(R0[::-1, ::-1], mode="r")[0][::-1, ::-1]
        scale = float(np.abs(R).max())
        if scale > 1e4 and not self._factor_scale_warned:
            # once a model: this runs on every append
            self._factor_scale_warned = True
            warnings.warn(
                f"sparse pseudo-factor max entry {scale:.3g}: K_ZZ is "
                "ill-conditioned enough that float32 device intervals "
                "will carry material noise (host-f64 predict is "
                "unaffected). Raise `jitter` or reduce the inducing "
                "density.", RuntimeWarning, stacklevel=3)
        # w solves R^T w = alpha in the least-squares sense (R is singular
        # with no data); mu = k^T alpha stays exact through alpha itself
        w = scipy.linalg.pinv(R.T, atol=0.0, rtol=1e-12) @ alpha
        self._set_posterior(R, alpha, w)

    def _set_posterior(self, R: np.ndarray, alpha: np.ndarray,
                       w: np.ndarray) -> None:
        """Keep the host factor and upload the padded device state:
        inducing rows, ``L = Linv = R`` bordered by the identity, ``count
        = m``."""
        m, cap = self._m, self._cap
        Xp = np.zeros((cap, self.Z.shape[1]))
        Xp[:m] = self.Z
        Rp = np.eye(cap)
        Rp[:m, :m] = R
        wp = np.zeros(cap)
        wp[:m] = w
        self._R, self._alpha, self._w = R, alpha, w
        self._oracle_cache = None       # the float64 mirror is stale
        Rt = self._tensor(Rp)
        self._state = GPState(
            X=self._tensor(Xp), Y=self._tensor(np.zeros((cap, 1))),
            count=torch.tensor(m, dtype=torch.int64, device=self.device),
            L=Rt, Linv=Rt, w=self._tensor(wp),
            noise_var=self._tensor(self.noise_var))

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(a, dtype=self.dtype, device=self.device)

    # -- GPRegression-compatible surface ------------------------------------

    @property
    def state(self) -> GPState:
        """Pseudo-factor ``GPState`` (inducing rows) for the grid passes."""
        return self._state

    @property
    def num_data(self) -> int:
        """Observation count n (can far exceed the inducing count)."""
        return self._X.shape[0]

    @property
    def num_inducing(self) -> int:
        """Inducing-point count m (bounds the per-iteration cost)."""
        return self._m

    @property
    def X(self) -> np.ndarray:
        """Training inputs (host float64, all n rows)."""
        return self._X

    @property
    def Y(self) -> np.ndarray:
        """Training targets (host float64, all n rows)."""
        return self._Y

    # already host arrays; the aliases keep GPRegression's surface
    X_host = X
    Y_host = Y

    @property
    def input_dim(self) -> int:
        """Input dimensionality d."""
        return self._X.shape[1]

    def predict_noiseless(self, Xq):
        """DTC latent posterior (mean, var), each (q, 1), in host float64
        from the float64 R and alpha (not the device state's cast)."""
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        kz = np_kernel(self.kern, self.Z, Xq)             # (m, q)
        mu = kz.T @ self._alpha
        V = self._R @ kz
        var = np_kdiag(self.kern, Xq) - np.sum(V * V, axis=0)
        return mu[:, None], np.maximum(var, 0.0)[:, None]

    def predict_f64(self, Xq):
        """Float64 DTC latent posterior (mu, var), each 1-D: the oracle
        of ``SafeOpt(exact_boundaries=True)``, exact for the DTC model."""
        mu, var = self.predict_noiseless(Xq)
        return mu.ravel(), var.ravel()

    def predict(self, Xq, include_likelihood: bool = True):
        """DTC posterior (mean, var); the variance includes the noise
        unless ``include_likelihood=False``."""
        mu, var = self.predict_noiseless(Xq)
        if include_likelihood:
            var = var + self.noise_var
        return mu, var

    def device_oracle_state(self):
        """``(OracleState, 'sparse')``: the float64 mirror of
        ``predict_f64`` on the model's device (``X`` the inducing rows,
        ``F`` the padded R, ``alpha`` for ``mu = k^T alpha``, ``w``
        zeros), shipped on first use after each posterior update."""
        if self._oracle_cache is None:
            m, cap = self._m, self._cap
            f64 = dict(dtype=torch.float64, device=self.device)
            Xp = np.zeros((cap, self.Z.shape[1]))
            Xp[:m] = self.Z
            Fp = np.eye(cap)
            Fp[:m, :m] = self._R
            ap = np.zeros(cap)
            ap[:m] = self._alpha
            self._oracle_cache = OracleState(
                X=torch.tensor(Xp, **f64), F=torch.tensor(Fp, **f64),
                w=torch.zeros(cap, **f64), alpha=torch.tensor(ap, **f64),
                count=torch.tensor(m, dtype=torch.int64,
                                   device=self.device))
        return self._oracle_cache, "sparse"

    def log_likelihood(self) -> float:
        """DTC log marginal likelihood at the current hyperparameters
        (host float64; ``hyperopt.sparse_log_marginal_likelihood``)."""
        from .hyperopt import sparse_log_marginal_likelihood

        with torch.no_grad():
            return float(sparse_log_marginal_likelihood(
                self._kern_base, self._X, self._Y, self.Z, self.noise_var))

    def posterior_samples_f(self, Xq, size: int = 1, generator=None,
                            normals=None) -> np.ndarray:
        """Joint latent samples from the DTC posterior at ``Xq``, shape
        (q, 1, size), from the float64 host covariance through R. The
        standard normals are ``normals`` (q, size) when given, else
        ``torch.randn`` with ``generator`` (a fixed seed when None), as
        ``GPRegression.posterior_samples_f`` draws them."""
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        kz = np_kernel(self.kern, self.Z, Xq)          # (m, q)
        V = self._R @ kz
        return sample_latent(kz.T @ self._alpha,
                             np_kernel(self.kern, Xq) - V.T @ V, size,
                             generator, normals)

    def append_data(self, x, y) -> None:
        """O(m^2 + m^3) incremental append (no pass over the n rows)."""
        x = np.asarray(x, dtype=np.float64).reshape(1, -1)
        self._X = np.vstack([self._X, x])
        self._Y = np.vstack([self._Y, [[float(y)]]])
        self._apply_rank1(x[0], float(y), +1.0)

    def pop_data(self) -> None:
        """O(m^2 + m^3) incremental remove-last (the subtracted outer
        product is bit-identical to the added one)."""
        x = self._X[-1]
        y = float(self._Y[-1, 0])
        self._X = self._X[:-1]
        self._Y = self._Y[:-1]
        self._apply_rank1(x, y, -1.0)

    def set_XY(self, X, Y) -> None:
        """Replace the training set; a pure append or truncation of the
        current data rides the rank-1 path, anything else rebuilds."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        n_old = self._X.shape[0]
        n_new = X.shape[0]
        if X.shape[1] == self._X.shape[1]:
            if (n_new > n_old
                    and np.array_equal(X[:n_old], self._X)
                    and np.array_equal(Y[:n_old], self._Y)):
                for i in range(n_old, n_new):
                    self.append_data(X[i], Y[i, 0])
                return
            if (n_new < n_old
                    and np.array_equal(X, self._X[:n_new])
                    and np.array_equal(Y, self._Y[:n_new])):
                for _ in range(n_old - n_new):
                    self.pop_data()
                return
        self._X = X.copy()
        self._Y = Y.copy()
        self._refit()

    def refit(self) -> None:
        """Full O(m^2 n) rebuild (numerical hygiene)."""
        self._refit()

    def optimize_hyperparameters(self, steps: int = 200,
                                 learning_rate: float = 0.05,
                                 optimize_noise: bool = True,
                                 restarts: int = 0, seed: int = 0,
                                 optimize_inducing: bool = False,
                                 device=None) -> float:
        """Fit ``kern_base`` (and the noise) by maximizing the DTC LML
        (``hyperopt.fit_hyperparameters`` with
        ``sparse_log_marginal_likelihood``), and with
        ``optimize_inducing`` the inducing locations too (restarts
        perturb only the hyperparameters); then rebuild. ``device``:
        ``'cpu'``, ``'accel'`` (the card) or ``'auto'``; None fits where
        the model lives. Returns the best LML."""
        from .hyperopt import (fit_device, fit_hyperparameters,
                               sparse_log_marginal_likelihood)

        if device is None:
            device = "cpu" if self.device.type == "cpu" else "accel"
        dev = fit_device(device)
        X = torch.tensor(self._X, dtype=torch.float64, device=dev)
        Y = torch.tensor(self._Y, dtype=torch.float64, device=dev)
        common = dict(steps=steps, learning_rate=learning_rate,
                      optimize_noise=optimize_noise, restarts=restarts,
                      seed=seed, device=device)
        if optimize_inducing:
            kern, noise, Z, lml = fit_hyperparameters(
                self._kern_base, X, Y, self.noise_var, inducing=self.Z,
                lml_fn=lambda k, nv, Zv: sparse_log_marginal_likelihood(
                    k, X, Y, Zv, nv), **common)
            self.Z = np.atleast_2d(np.asarray(Z, dtype=np.float64))
        else:
            Z = torch.tensor(self.Z, dtype=torch.float64, device=dev)
            kern, noise, lml = fit_hyperparameters(
                self._kern_base, X, Y, self.noise_var,
                lml_fn=lambda k, nv: sparse_log_marginal_likelihood(
                    k, X, Y, Z, nv), **common)
        self.kern = kern
        self.noise_var = float(noise)
        self._refit()
        return lml

    def optimize(self, max_iters: int = 200, optimize_inducing: bool = True,
                 device=None, **_gpy_compat) -> float:
        """GPy's spelling of sparse fitting: the inducing locations move
        by default, as Z is a model parameter in GPy."""
        return self.optimize_hyperparameters(
            steps=max_iters, optimize_inducing=optimize_inducing,
            device=device)

    def optimize_restarts(self, num_restarts: int = 5,
                          max_iters: int = 200, seed: int = 0,
                          optimize_inducing: bool = True, device=None,
                          **_gpy_compat) -> float:
        """GPy's multi-start fitting (best finite LML wins); the inducing
        locations move by default, restarts perturb only the
        hyperparameters."""
        return self.optimize_hyperparameters(
            steps=max_iters, restarts=num_restarts, seed=seed,
            optimize_inducing=optimize_inducing, device=device)

    def __repr__(self):
        return (f"SparseGPRegression(n={self.num_data}, "
                f"m={self.num_inducing}, kern={self.kern!r}, "
                f"device={self.device})")

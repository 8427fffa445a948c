"""Exact GP regression for the PyTorch port.

Counterpart of ``safeopt_tpu/gp/regression.py``: the GPy-compatible
``GPRegression`` wrapper over padded fixed-shape buffers.

* **Host f64 factor, device mirror.** The Cholesky factor ``L``, its
  inverse ``Linv`` and the whitened targets ``w = Linv y`` live on the
  host in float64 (``host_math.HostFactor``); the device holds a cast
  copy (``GPState``) that feeds the O(N) grid passes.
* **Masked padding.** Rows at index >= ``count`` are identity rows of
  the factor, so padded rows never contaminate active results once
  query covariances are masked (``Linv * col_mask``).
* **One-row updates.** An append borders the factor and a pop truncates
  it; each changes exactly one row, which is written into the device
  mirror in place (``_device_row_update``) — bit-identical to a full
  rebuild because the untouched rows were cast from the same host
  values.
* **Functional engine.** ``gp_fit``, ``gp_append``, ``gp_pop``,
  ``gp_predict`` and ``predict_from_factors`` work on a padded
  ``GPState`` of any dtype on any device with the JAX package's masking
  conventions (identity rows past ``count``) and return new states;
  ``algorithms/runner.py`` keeps float64 states on the device with them
  (``GPRegression.factor_state``), as the factor math stays in float64.
* **Float64 oracle mirror.** ``device_oracle_state`` ships the host
  oracle's float64 factors to the device once (``OracleState``) for the
  certified path's on-device oracle; each append or pop then writes its
  one row there too (``_oracle_row_update``).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from ..config import default_dtype
from .host_math import HostFactor, np_kernel
from .kernels import Kernel, RBF

__all__ = ["GPState", "OracleState", "GPRegression", "gp_fit", "gp_append",
           "gp_pop", "gp_predict", "predict_from_factors"]


class GPState(NamedTuple):
    """Device posterior state: fixed-shape tensors on one device."""

    X: torch.Tensor          # (cap, d) padded training inputs
    Y: torch.Tensor          # (cap, 1) padded training targets
    count: torch.Tensor      # () int64 — number of active rows
    L: torch.Tensor          # (cap, cap) masked lower Cholesky factor
    Linv: torch.Tensor       # (cap, cap) lower-triangular inverse of L
    w: torch.Tensor          # (cap,) whitened targets L^{-1} y (masked)
    noise_var: torch.Tensor  # () observation noise variance

    @property
    def capacity(self) -> int:
        """Padded buffer size."""
        return self.X.shape[0]

    @property
    def input_dim(self) -> int:
        """Input dimensionality d."""
        return self.X.shape[1]


class OracleState(NamedTuple):
    """Float64 device mirror of a model's host oracle (``predict_f64``):
    exactly the float64 factors the host oracle uses, so that
    ``safe_opt_core.device_oracle`` settles knife-edge safe bits on the
    device; only the summation order differs from the host's
    (``safeopt_tpu/gp/regression.py:75-100``)."""

    X: torch.Tensor          # (cap, d) float64 data rows
    F: torch.Tensor          # (cap, cap) float64 factor; V = F @ k(X, q)
    w: torch.Tensor          # (cap,) float64 whitened weights, mu = V^T w
    alpha: torch.Tensor      # (cap,) float64 direct weights (sparse:
    #                          mu = k^T alpha; zeros for an exact model)
    count: torch.Tensor      # () int64 active rows

    @property
    def capacity(self) -> int:
        """Padded buffer size."""
        return self.X.shape[0]


def row_mask(state: GPState) -> torch.Tensor:
    """(cap,) 1.0 on active rows, 0.0 on padding, in the state dtype."""
    cap = state.capacity
    return (torch.arange(cap, device=state.X.device)
            < state.count).to(state.X.dtype)


def predict_from_factors(kernel: Kernel, X: torch.Tensor, mask: torch.Tensor,
                         Linv: torch.Tensor, w: torch.Tensor,
                         Xq: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent posterior (mu, var) at ``Xq`` from whitened factors:
    ``V = Linv @ (k(X, Xq) * mask)``, ``mu = V^T w``, ``var = kdiag(Xq) -
    colsum(V^2)`` clamped at 0 (no likelihood noise, GPy's
    ``predict_noiseless``)."""
    V = Linv @ (kernel.K(X, Xq) * mask[:, None])
    var = kernel.Kdiag(Xq) - torch.sum(V * V, dim=0)
    return V.T @ w, torch.clamp(var, min=0.0)


def gp_predict(kernel: Kernel, state: GPState,
               Xq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent (noiseless) posterior mean/variance at query rows ``Xq``
    (``predict_from_factors`` on the state's factors; ``Xq`` is taken in
    the state's dtype, on its device)."""
    Xq = torch.as_tensor(Xq, dtype=state.X.dtype, device=state.X.device)
    return predict_from_factors(kernel, state.X, row_mask(state), state.Linv,
                                state.w, torch.atleast_2d(Xq))


def gp_fit(kernel: Kernel, X: torch.Tensor, Y: torch.Tensor, count,
           noise_var) -> GPState:
    """Factorize from scratch over padded buffers ``X`` (cap, d) and ``Y``
    (cap, 1): rows at index >= ``count`` are ignored, the factored
    matrix being ``K + noise I`` on the active block and the identity on
    the padding, so that ``L = blockdiag(chol(K_n + noise I), I)``."""
    cap = X.shape[0]
    count = torch.as_tensor(count, dtype=torch.int64, device=X.device)
    noise_var = torch.as_tensor(noise_var, dtype=X.dtype, device=X.device)
    active = torch.arange(cap, device=X.device) < count
    mask = active.to(X.dtype)
    eye = torch.eye(cap, dtype=X.dtype, device=X.device)
    K = (kernel.K(X) * (mask[:, None] * mask[None, :])
         + eye * torch.where(active, noise_var, 1.0))
    L = torch.linalg.cholesky(K)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return GPState(X=X, Y=Y, count=count.clone(), L=L, Linv=Linv,
                   w=Linv @ (Y[:, 0] * mask), noise_var=noise_var)


def _onehot(state: GPState, pos) -> torch.Tensor:
    """(cap,) bool, True at row ``pos`` (a device scalar: no host read)."""
    return torch.arange(state.capacity, device=state.X.device) == pos


def gp_append(kernel: Kernel, state: GPState, x, y) -> GPState:
    """Exact O(n^2) Cholesky bordering append of one observation at row
    ``count``: ``c = Linv k(X, x)``, ``dd = sqrt(k(x, x) + noise -
    c.c)``, the new rows ``[c, dd]`` of L and ``[-(c^T Linv) / dd,
    1/dd]`` of Linv, and ``w[count] = (y - c.w) / dd``. Everything stays
    on the state's device (the row is chosen by a mask, not a host
    index); the caller keeps ``count`` below the capacity."""
    pos = state.count
    dtype, dev = state.X.dtype, state.X.device
    x = torch.as_tensor(x, dtype=dtype, device=dev).reshape(1, -1)
    y = torch.as_tensor(y, dtype=dtype, device=dev).reshape(())
    kvec = kernel.K(state.X, x)[:, 0] * row_mask(state)
    c = state.Linv @ kvec                      # zero at and after pos
    dd = torch.sqrt(torch.clamp(kernel.Kdiag(x)[0] + state.noise_var
                                - torch.dot(c, c), min=1e-30))
    hot = _onehot(state, pos)
    onehot = hot.to(dtype)
    row = hot[:, None]
    return GPState(
        X=torch.where(row, x, state.X),
        Y=torch.where(row, y, state.Y),
        count=pos + 1,
        L=torch.where(row, (c + dd * onehot)[None, :], state.L),
        Linv=torch.where(row, (-(state.Linv.T @ c) / dd
                               + onehot / dd)[None, :], state.Linv),
        w=state.w + ((y - torch.dot(c, state.w)) / dd) * onehot,
        noise_var=state.noise_var)


def gp_pop(state: GPState) -> GPState:
    """Remove the last observation (exact: the leading block of a
    Cholesky factor is the factor of the leading block). Row ``count -
    1`` of L and Linv returns to the identity and its ``w`` to 0; X and Y
    keep the row, as the JAX package's ``gp_pop`` does."""
    pos = state.count - 1
    hot = _onehot(state, pos)
    onehot = hot.to(state.X.dtype)
    row = hot[:, None]
    return GPState(X=state.X, Y=state.Y, count=pos,
                   L=torch.where(row, onehot[None, :], state.L),
                   Linv=torch.where(row, onehot[None, :], state.Linv),
                   w=state.w * (1.0 - onehot), noise_var=state.noise_var)


def _device_row_update(state: GPState, i: int, row: torch.Tensor,
                       new_count: int) -> None:
    """Write one bordered-update row into the device state IN PLACE.

    ``row`` packs ``[x (d), y, L row (cap), Linv row (cap), w]`` so the
    update costs one host-to-device copy; ``count`` is refilled in
    place. Work already queued on the state's stream reads the old
    values (stream order), so the in-place write needs no copy.
    """
    d, cap = state.input_dim, state.capacity
    row = row.to(device=state.X.device, dtype=state.X.dtype)
    state.X[i] = row[:d]
    state.Y[i, 0] = row[d]
    state.L[i] = row[d + 1:d + 1 + cap]
    state.Linv[i] = row[d + 1 + cap:d + 1 + 2 * cap]
    state.w[i] = row[d + 1 + 2 * cap]
    state.count.fill_(new_count)


def _oracle_row_update(cache: OracleState, i: int, row: torch.Tensor,
                       new_count: int) -> None:
    """Write one bordered-update row into the float64 oracle mirror IN
    PLACE (``_device_row_update``'s contract): ``row`` packs ``[x (d),
    Linv row (cap), w]``."""
    d, cap = cache.X.shape[1], cache.capacity
    row = row.to(device=cache.X.device, dtype=torch.float64)
    cache.X[i] = row[:d]
    cache.F[i] = row[d:d + cap]
    cache.w[i] = row[d + cap]
    cache.count.fill_(new_count)


def sample_latent(mu: np.ndarray, cov: np.ndarray, size: int,
                  generator=None, normals=None) -> np.ndarray:
    """(q, 1, size) joint draws of N(mu, cov) in host float64, through an
    eigendecomposition of the symmetrized, jittered ``cov`` (a
    near-singular posterior covariance defeats Cholesky). The standard
    normals are ``normals`` (q, size) when given, else ``torch.randn``
    with ``generator`` (a fixed seed when None)."""
    cov = 0.5 * (cov + cov.T) + 1e-10 * np.eye(cov.shape[0])
    evals, evecs = np.linalg.eigh(cov)
    root = evecs * np.sqrt(np.maximum(evals, 0.0))
    if normals is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        normals = torch.randn((cov.shape[0], int(size)),
                              generator=generator, dtype=torch.float64)
    eps = np.asarray(normals, dtype=np.float64).reshape(cov.shape[0],
                                                        int(size))
    return (mu[:, None] + root @ eps)[:, None, :]


def _next_capacity(n: int, minimum: int = 64) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class GPRegression:
    """Exact GP regression with a GPy-compatible surface.

    Parameters
    ----------
    X : array (n, d)
        Initial training inputs.
    Y : array (n, 1)
        Initial training targets.
    kernel : Kernel, optional
        Covariance kernel; defaults to ``RBF(d)`` like GPy.
    noise_var : float
        Gaussian observation noise variance (GPy default 1.0).
    capacity : int, optional
        Initial padded buffer size; grows automatically (x2 refit).
    device : str or torch.device
        Where the device mirror lives: the card (``'cuda'``, the
        default) unless the caller asks for ``'cpu'``.
    dtype : torch.dtype, optional
        Device mirror dtype; defaults to ``config.default_dtype(device)``.
    """

    def __init__(self, X, Y, kernel: Optional[Kernel] = None,
                 noise_var: float = 1.0, capacity: Optional[int] = None,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        if Y.shape[1] != 1:
            raise ValueError("Y must have exactly one column")
        if kernel is None:
            kernel = RBF(X.shape[1])
        self.kern = kernel
        self.device = torch.device(device)
        self.dtype = dtype if dtype is not None else default_dtype(device)
        n, d = X.shape
        cap = capacity if capacity is not None else _next_capacity(n + 1)
        self._host = HostFactor(self.kern, cap, d, float(noise_var))
        self._host.set_data(X, Y)
        self._state = self._device_state()
        self._oracle_cache = None

    def _tensor(self, a) -> torch.Tensor:
        # torch.tensor copies: the host factor mutates its arrays in
        # place on every append/pop, so the mirror must never alias them
        # (torch.from_numpy would).
        return torch.tensor(a, dtype=self.dtype, device=self.device)

    def _device_state(self) -> GPState:
        h = self._host
        return GPState(
            X=self._tensor(h.X), Y=self._tensor(h.Y),
            count=torch.tensor(int(h.count), dtype=torch.int64,
                               device=self.device),
            L=self._tensor(h.L), Linv=self._tensor(h.Linv),
            w=self._tensor(h.w), noise_var=self._tensor(h.noise_var))

    def _sync_row(self, pos: int) -> None:
        """Propagate the one row a border or truncation changed, to the
        device mirror and, once shipped, to the float64 oracle mirror."""
        h = self._host
        row = np.concatenate([h.X[pos], h.Y[pos], h.L[pos], h.Linv[pos],
                              h.w[pos:pos + 1]])
        _device_row_update(self._state, pos, torch.tensor(row),
                           int(h.count))
        if self._oracle_cache is not None:
            _oracle_row_update(self._oracle_cache, pos, torch.tensor(
                np.concatenate([h.X[pos], h.Linv[pos], h.w[pos:pos + 1]])),
                int(h.count))

    def _rebuilt(self) -> None:
        """A full device rebuild: the oracle mirror is shipped anew when
        next asked for."""
        self._state = self._device_state()
        self._oracle_cache = None

    def factor_state(self) -> GPState:
        """The host factor as a float64 ``GPState`` on the model's device
        (a copy): the operand of the functional engine and of
        ``algorithms/runner.run_safeopt_loop``, whose appends then write
        rows that cast to the float32 mirror's bits."""
        h = self._host
        f64 = dict(dtype=torch.float64, device=self.device)
        return GPState(
            X=torch.tensor(h.X, **f64), Y=torch.tensor(h.Y, **f64),
            count=torch.tensor(int(h.count), dtype=torch.int64,
                               device=self.device),
            L=torch.tensor(h.L, **f64), Linv=torch.tensor(h.Linv, **f64),
            w=torch.tensor(h.w, **f64),
            noise_var=torch.tensor(h.noise_var, **f64))

    def device_oracle_state(self):
        """``(OracleState, 'exact')``: the float64 device mirror of the
        host oracle (``predict_f64``) for ``SafeOpt(oracle='device')``,
        shipped on first use and after a rebuild, and updated one row
        per append or pop (``_sync_row``)."""
        if self._oracle_cache is None:
            h = self._host
            f64 = dict(dtype=torch.float64, device=self.device)
            self._oracle_cache = OracleState(
                X=torch.tensor(h.X, **f64), F=torch.tensor(h.Linv, **f64),
                w=torch.tensor(h.w, **f64),
                alpha=torch.zeros(h.capacity, **f64),
                count=torch.tensor(int(h.count), dtype=torch.int64,
                                   device=self.device))
        return self._oracle_cache, "exact"

    # -- GPy API surface ---------------------------------------------------
    @property
    def state(self) -> GPState:
        """Device posterior state feeding the grid passes."""
        return self._state

    @property
    def num_data(self) -> int:
        """Active observation count (host-side)."""
        return int(self._host.count)

    @property
    def X(self) -> torch.Tensor:
        """Training inputs (device tensor, GPy ``gp.X``)."""
        return self._state.X[: self.num_data]

    @property
    def Y(self) -> torch.Tensor:
        """Training targets (device tensor, GPy ``gp.Y``)."""
        return self._state.Y[: self.num_data]

    @property
    def X_host(self) -> np.ndarray:
        """Training inputs as host float64."""
        return self._host.X[: self.num_data]

    @property
    def Y_host(self) -> np.ndarray:
        """Training targets as host float64."""
        return self._host.Y[: self.num_data]

    @property
    def input_dim(self) -> int:
        """Input dimensionality d (GPy ``gp.input_dim``)."""
        return self._state.input_dim

    @property
    def noise_var(self) -> float:
        """Gaussian observation-noise variance."""
        return float(self._host.noise_var)

    def predict_noiseless(self, Xq) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latent posterior (mean, var), each (m, 1) — GPy convention."""
        Xq = torch.as_tensor(Xq, dtype=self.dtype, device=self.device)
        mu, var = gp_predict(self.kern, self._state, Xq)
        return mu[:, None], var[:, None]

    def predict(self, Xq, include_likelihood: bool = True):
        """Posterior (mean, var) at Xq; the variance includes the
        observation noise unless ``include_likelihood=False``."""
        mu, var = self.predict_noiseless(Xq)
        if include_likelihood:
            var = var + self.noise_var
        return mu, var

    def predict_f64(self, Xq) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 latent posterior (mu, var) from the host factor."""
        return self._host.predict(Xq)

    def log_likelihood(self) -> float:
        """Exact log marginal likelihood at the current hyperparameters
        (GPy ``gp.log_likelihood()``), in float64 on the host:
        ``-y^T K^-1 y / 2 - sum(log diag L) - n log(2 pi) / 2`` with ``K =
        k(X, X) + noise I``."""
        n = self.num_data
        X, Y = self._host.X[:n], self._host.Y[:n, 0]
        K = np_kernel(self.kern, X) + self.noise_var * np.eye(n)
        L = scipy.linalg.cholesky(K, lower=True)
        alpha = scipy.linalg.cho_solve((L, True), Y)
        return float(-0.5 * Y @ alpha - np.sum(np.log(np.diag(L)))
                     - 0.5 * n * np.log(2.0 * np.pi))

    def posterior_samples_f(self, Xq, size: int = 1, generator=None,
                            normals=None) -> np.ndarray:
        """Joint samples of the LATENT function at ``Xq`` (GPy
        ``gp.posterior_samples_f``), shape (m, 1, size).

        The posterior covariance is assembled and factored on the host in
        float64 (``HostFactor.posterior_cov``; an eigendecomposition,
        since a near-singular posterior covariance defeats Cholesky).
        The standard normals come from ``normals`` (m, size) when given,
        else from ``torch.randn`` with ``generator`` (a fixed seed when
        None): torch cannot reproduce the JAX package's threefry draws,
        so a caller who needs its samples passes its normals.
        """
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        mu, _ = self._host.predict(Xq)
        return sample_latent(mu, self._host.posterior_cov(Xq), size,
                             generator, normals)

    def optimize_hyperparameters(self, steps: int = 200,
                                 learning_rate: float = 0.05,
                                 optimize_noise: bool = True,
                                 restarts: int = 0, seed: int = 0,
                                 device=None) -> float:
        """Fit the kernel's hyperparameters (and the noise) by maximizing
        the exact log marginal likelihood (``hyperopt.
        fit_hyperparameters``: Adam in log space, ``restarts`` perturbed
        starts in one batch, best finite run, BFGS polish), then set them
        on the model and the host factor and ``refit()``. ``device``:
        ``'cpu'``, ``'accel'`` (the card) or ``'auto'``; None fits where
        the model lives. Returns the best LML."""
        from .hyperopt import fit_hyperparameters

        if device is None:
            device = "cpu" if self.device.type == "cpu" else "accel"
        kern, noise, lml = fit_hyperparameters(
            self.kern, self.X_host, self.Y_host, self.noise_var,
            steps=steps, learning_rate=learning_rate,
            optimize_noise=optimize_noise, restarts=restarts, seed=seed,
            device=device)
        self.kern = kern
        self._host.kernel = kern
        self._host.noise_var = float(noise)
        self.refit()
        return lml

    def optimize(self, max_iters: int = 200, device=None,
                 **_gpy_compat) -> float:
        """GPy's spelling of hyperparameter fitting (GPy-only keywords
        such as ``optimizer=`` or ``messages=`` are accepted and
        ignored). Returns the LML."""
        return self.optimize_hyperparameters(steps=max_iters, device=device)

    def optimize_restarts(self, num_restarts: int = 5,
                          max_iters: int = 200, seed: int = 0, device=None,
                          **_gpy_compat) -> float:
        """GPy's multi-start fitting: one run from the current
        hyperparameters and ``num_restarts`` perturbed ones, the best
        finite LML wins. Returns that LML."""
        return self.optimize_hyperparameters(
            steps=max_iters, restarts=num_restarts, seed=seed,
            device=device)

    def refit(self) -> None:
        """Refactorize from scratch (numerical hygiene): the host factor
        anew from its data, and the device mirrors rebuilt."""
        n = self.num_data
        self._host.set_data(self._host.X[:n].copy(), self._host.Y[:n].copy())
        self._rebuilt()

    def append_data(self, x, y) -> None:
        """Append one observation (O(n^2) exact update; the device
        mirror receives only the one changed row)."""
        if self.num_data + 1 > self._host.capacity:
            self._host = self._host.grown(self._host.capacity * 2)
            self._host.append(np.asarray(x, dtype=np.float64), float(y))
            self._rebuilt()                      # capacity changed
            return
        pos = int(self._host.count)
        self._host.append(np.asarray(x, dtype=np.float64), float(y))
        self._sync_row(pos)

    def pop_data(self) -> None:
        """Drop the most recent observation (exact; the device mirror
        receives only the one restored padding row)."""
        self._host.pop()
        self._sync_row(int(self._host.count))

    def set_XY(self, X, Y) -> None:
        """Replace the training set (GPy semantics).

        A pure append or truncation of the current set uses the exact
        incremental updates; anything else is a full refit.
        """
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        n_old = self.num_data
        n_new = X.shape[0]

        if X.shape[1] == self.input_dim:
            X_cur = self._host.X[:n_old]
            Y_cur = self._host.Y[:n_old]
            if (n_new > n_old
                    and np.array_equal(X[:n_old], X_cur)
                    and np.array_equal(Y[:n_old], Y_cur)):
                for i in range(n_old, n_new):
                    self.append_data(X[i], Y[i, 0])
                return
            if (n_new < n_old
                    and np.array_equal(X, X_cur[:n_new])
                    and np.array_equal(Y, Y_cur[:n_new])):
                for _ in range(n_old - n_new):
                    self.pop_data()
                return

        logging.getLogger(__name__).debug(
            "set_XY: data is not a pure append/truncate of the current "
            "set (%d -> %d rows); full O(n^3) refit", n_old, n_new)

        cap = self._host.capacity
        if n_new + 1 > cap or X.shape[1] != self.input_dim:
            cap = _next_capacity(n_new + 1)
            self._host = HostFactor(self.kern, cap, X.shape[1],
                                    self.noise_var)
        self._host.set_data(X, Y)
        self._rebuilt()

    def __repr__(self):
        return (f"GPRegression(n={self.num_data}, d={self.input_dim}, "
                f"noise_var={self.noise_var}, kern={self.kern!r}, "
                f"device={self.device})")

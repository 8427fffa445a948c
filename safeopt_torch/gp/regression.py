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
* **Float64 oracle mirror.** ``device_oracle_state`` ships the host
  oracle's float64 factors to the device once (``OracleState``) for the
  certified path's on-device oracle; each append or pop then writes its
  one row there too (``_oracle_row_update``).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import default_dtype
from .host_math import HostFactor
from .kernels import Kernel, RBF

__all__ = ["GPState", "OracleState", "GPRegression", "gp_predict"]


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


def gp_predict(kernel: Kernel, state: GPState,
               Xq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Latent (noiseless) posterior mean/variance at query rows ``Xq``:
    ``V = Linv @ (k(X, Xq) * mask)``, ``mu = V^T w``,
    ``var = kdiag - colsum(V^2)``."""
    Xq = torch.atleast_2d(Xq)
    kvec = kernel.K(state.X, Xq) * row_mask(state)[:, None]
    V = state.Linv @ kvec
    mu = V.T @ state.w
    var = kernel.Kdiag(Xq) - torch.sum(V * V, dim=0)
    return mu, torch.clamp(var, min=0.0)


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

"""Carry kernels and fitted GP factors across as plain NumPy arrays.

``kernel_params`` and ``gp_arrays`` read any kernel or ``GPRegression``
with the attribute layout this package shares with ``safeopt_tpu``
(``variance``, ``lengthscale``, ``ARD``, ``active_dims``; each family's
own parameters: RatQuad's ``power``, StdPeriodic's ``period`` with
``ARD1``/``ARD2``, Linear's ``variances``, Poly's ``scale``, ``bias``
and ``order``, MLP's ``weight_variance`` and ``bias_variance``; ``k1``
and ``k2`` of a ``Product`` or ``Sum``; the host factor ``gp._host`` with
``X``, ``Y``, ``L``, ``Linv``, ``w``), through ``numpy.asarray`` only. A
kernel tree becomes nested plain dicts. ``kernel_from_params`` and
``gp_from_arrays`` build this package's objects from those values.
Given the float64 factor arrays, the new ``GPRegression`` holds that
very factor instead of refactorizing, so both packages compute from
identical operands. ``sparse_arrays`` and ``sparse_from_arrays`` do the
same for a ``SparseGPRegression``: its inducing points, data,
information state (``A``, ``b``), ``K_ZZ``, pseudo-factor ``R``,
``alpha``, ``w`` and floor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg
import torch

from .gp.kernels import (Bias, Cosine, Exponential, Linear, Matern32,
                         Matern52, MLP, Poly, Product, RatQuad, RBF,
                         StdPeriodic, Sum, White)
from .gp.regression import GPRegression
from .gp.sparse import SparseGPRegression

__all__ = ["kernel_params", "kernel_from_params", "gp_arrays",
           "gp_from_arrays", "sparse_arrays", "sparse_from_arrays"]

_LEAVES = {"rbf": RBF, "matern32": Matern32, "matern52": Matern52,
           "exponential": Exponential, "ratquad": RatQuad, "cosine": Cosine,
           "bias": Bias, "white": White, "stdperiodic": StdPeriodic,
           "linear": Linear, "poly": Poly, "mlp": MLP}
_COMPOSITES = {"product": Product, "sum": Sum}
# each leaf kind's parameters besides input_dim and active_dims: arrays
# (float64, any shape), floats and flags
_ARRAYS = {"rbf": ("lengthscale",), "matern32": ("lengthscale",),
           "matern52": ("lengthscale",), "exponential": ("lengthscale",),
           "ratquad": ("lengthscale",), "cosine": ("lengthscale",),
           "stdperiodic": ("period", "lengthscale"),
           "linear": ("variances",), "mlp": ("weight_variance",)}
_FLOATS = {"ratquad": ("variance", "power"),
           "poly": ("variance", "scale", "bias", "order"),
           "mlp": ("variance", "bias_variance"), "linear": ()}
_FLAGS = {"stdperiodic": ("ARD1", "ARD2"), "bias": (), "white": (),
          "poly": ()}


def kernel_params(kernel) -> dict:
    """Plain parameters of a kernel tree (either package): a leaf's
    ``kind``, ``input_dim``, ``variance``, ``active_dims`` and, where it
    has them, ``lengthscale`` and ``ARD``; a Product or Sum as ``kind``
    with the dicts ``k1`` and ``k2`` of its parts."""
    kind = type(kernel).__name__.lower()
    if kind in _COMPOSITES:
        return dict(kind=kind, k1=kernel_params(kernel.k1),
                    k2=kernel_params(kernel.k2))
    if kind not in _LEAVES:
        raise NotImplementedError(f"no conversion for {type(kernel).__name__}")
    out = dict(kind=kind, input_dim=int(kernel.input_dim),
               active_dims=tuple(int(a) for a in kernel.active_dims))
    for name in _FLOATS.get(kind, ("variance",)):
        out[name] = float(np.asarray(getattr(kernel, name)))
    for name in _ARRAYS.get(kind, ()):
        out[name] = np.array(getattr(kernel, name), dtype=np.float64)
    for name in _FLAGS.get(kind, ("ARD",)):
        out[name] = bool(getattr(kernel, name))
    return out


def kernel_from_params(kind: str, **params):
    """Build this package's kernel tree from ``kernel_params`` values."""
    if kind in _COMPOSITES:
        return _COMPOSITES[kind](kernel_from_params(**params["k1"]),
                                 kernel_from_params(**params["k2"]))
    if kind not in _LEAVES:
        raise NotImplementedError(
            f"kernel kind {kind!r}; the port has "
            f"{sorted(_LEAVES) + sorted(_COMPOSITES)}")
    for name in _ARRAYS.get(kind, ()):
        params[name] = np.asarray(params[name], np.float64)
    return _LEAVES[kind](**params)


def gp_arrays(gp) -> dict:
    """Float64 copies of a ``GPRegression``'s data and host factor, as
    keyword arguments of ``gp_from_arrays`` (kernel excluded)."""
    h = gp._host
    n = int(h.count)
    return dict(X=np.array(h.X[:n]), Y=np.array(h.Y[:n]),
                noise_var=float(h.noise_var), capacity=int(h.X.shape[0]),
                L=np.array(h.L), Linv=np.array(h.Linv), w=np.array(h.w))


def gp_from_arrays(kernel, X, Y, noise_var: float, capacity: int,
                   L=None, Linv=None, w=None, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> GPRegression:
    """A ``GPRegression`` over (X, Y) with the given capacity.

    With ``L``, ``Linv`` ((capacity, capacity)) and ``w`` ((capacity,))
    — the padded float64 factor of another model — the host factor
    takes those arrays as they are; without them it factorizes.
    """
    gp = GPRegression(X, Y, kernel, noise_var=noise_var, capacity=capacity,
                      device=device, dtype=dtype)
    given = [a is not None for a in (L, Linv, w)]
    if any(given):
        if not all(given):
            raise ValueError("pass all of L, Linv and w, or none")
        L, Linv, w = (np.array(a, dtype=np.float64) for a in (L, Linv, w))
        want = {"L": (capacity, capacity), "Linv": (capacity, capacity),
                "w": (capacity,)}
        for name, a in zip(want, (L, Linv, w)):
            if a.shape != want[name]:
                raise ValueError(f"{name} has shape {a.shape}, expected "
                                 f"{want[name]}")
        gp._host.L, gp._host.Linv, gp._host.w = L, Linv, w
        gp._rebuilt()
    return gp


def sparse_arrays(gp) -> dict:
    """Float64 copies of a ``SparseGPRegression``'s (either package's)
    data, host state and settings, as keyword arguments of
    ``sparse_from_arrays`` (kernel excluded: ``kernel_params(gp.kern_base)``
    carries it)."""
    f64 = lambda a: np.array(a, dtype=np.float64)  # noqa: E731
    w = getattr(gp, "_w", None)
    if w is None:      # the JAX model keeps w only in its device state
        w = np.linalg.pinv(gp._R.T, rcond=1e-12) @ gp._alpha
    return dict(Z=f64(gp.Z), X=f64(gp.X), Y=f64(gp.Y),
                noise_var=float(gp.noise_var), A=f64(gp._A), b=f64(gp._b),
                Kzz=f64(gp._Kzz), R=f64(gp._R), alpha=f64(gp._alpha),
                w=f64(w), floor=float(gp._floor),
                conservative=float(gp.conservative),
                calibration=gp.calibration, jitter=float(gp._jitter),
                refit_every=int(gp._refit_every))


def sparse_from_arrays(kernel, Z, X, Y, noise_var: float, A, b, Kzz, R,
                       alpha, w, floor: float = 0.0,
                       conservative: float = 0.0, calibration="max",
                       jitter: float = 1e-8, refit_every: int = 512,
                       device="cuda", dtype: Optional[torch.dtype] = None
                       ) -> SparseGPRegression:
    """A ``SparseGPRegression`` that holds the given float64 host state
    as it is (``kernel`` the data-model kernel): after its own build,
    its ``A``, ``b``, ``K_ZZ`` (and factor), ``R``, ``alpha``, ``w`` and
    floor are replaced by these, and its device state is uploaded from
    them."""
    gp = SparseGPRegression(X, Y, kernel, noise_var=noise_var, inducing=Z,
                            refit_every=refit_every, jitter=jitter,
                            conservative=conservative,
                            calibration=calibration, device=device,
                            dtype=dtype)
    m = gp.num_inducing
    want = {"A": (m, m), "b": (m,), "Kzz": (m, m), "R": (m, m),
            "alpha": (m,), "w": (m,)}
    arrays = {}
    for name, a in zip(want, (A, b, Kzz, R, alpha, w)):
        arrays[name] = np.array(a, dtype=np.float64)
        if arrays[name].shape != want[name]:
            raise ValueError(f"{name} has shape {arrays[name].shape}, "
                             f"expected {want[name]}")
    gp._A, gp._b, gp._Kzz = arrays["A"], arrays["b"], arrays["Kzz"]
    gp._Kzz_cho = scipy.linalg.cho_factor(gp._Kzz, lower=True)
    gp._floor = float(floor)
    gp.kern = kernel                       # the floored view, if any
    gp._set_posterior(arrays["R"], arrays["alpha"], arrays["w"])
    return gp

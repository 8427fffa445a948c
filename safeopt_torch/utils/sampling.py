"""GP-prior test-function sampling.

Counterpart of ``safeopt_tpu/utils/sampling.py:31-142``: draw one sample
path of a GP prior on a grid and return a callable that evaluates the
RKHS interpolant (or the linear interpolant) of that draw, with an
optional mean function and Gaussian observation noise.

The draw stays on the host in float64: the prior gram over a dense grid
is severely ill-conditioned (jitter 1e-6), and a float32 factor would
return NaN. ``kernel.K(x, grid) @ alpha`` then runs on ``device`` in
``dtype``. Torch cannot reproduce the JAX package's threefry draws: the
randomness comes from a ``torch.Generator`` (or a ``seed``), and
``_sample_gp_function`` takes the standard normal of the draw as an
argument, so that a test can feed both packages the same one.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.interpolate
import scipy.linalg
import torch

from ..config import JITTER, default_dtype
from ..gp.host_math import np_kernel
from ..gp.kernels import Kernel
from .grids import linearly_spaced_combinations

__all__ = ["sample_gp_function"]


def sample_gp_function(kernel: Kernel, bounds, noise_var: float,
                       num_samples, interpolation: str = "kernel",
                       mean_function: Optional[Callable] = None,
                       generator: Optional[torch.Generator] = None,
                       seed: int = 0, device="cuda",
                       dtype: Optional[torch.dtype] = None) -> Callable:
    """Sample one function from a GP prior over a grid.

    Parameters
    ----------
    kernel : Kernel
        Prior covariance.
    bounds : list of (min, max) pairs
    noise_var : float
        Observation-noise variance applied when the returned function is
        called with ``noise=True``.
    num_samples : int or list of ints
        Grid resolution per dimension.
    interpolation : 'kernel' | 'linear'
        'kernel' evaluates the RKHS mean interpolant through the prior
        covariance on ``device``; 'linear' uses SciPy's simplex
        interpolation on the grid, on the host.
    mean_function : callable, optional
        Added to the sample path (it receives the tensor of inputs).
    generator : torch.Generator, optional
        Source of the draw's standard normal (a CPU generator); default a
        new one seeded with ``seed``.
    seed : int
        Seeds the draw when ``generator`` is None, and the noise of each
        call made without a generator of its own.
    device, dtype :
        Where and in what the returned function evaluates (default the
        card, ``config.default_dtype(device)``).

    Returns
    -------
    function : callable ``f(x, noise=True, generator=None)``
        Evaluates the sampled function at 2-D inputs ``x``; returns an
        (m, 1) tensor on ``device``. Call i made with noise and without a
        generator draws its noise from a generator seeded with ``(seed,
        i)``: the same for call i whatever came before, as the JAX
        package's ``fold_in(key, i)``.
    """
    if interpolation not in ("kernel", "linear"):
        raise ValueError(f"unknown interpolation mode: {interpolation!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    n = linearly_spaced_combinations(bounds, num_samples).shape[0]
    normal = torch.randn(n, generator=generator, dtype=torch.float64,
                         device=generator.device).cpu().numpy()
    return _sample_gp_function(kernel, bounds, noise_var, num_samples,
                               normal, interpolation, mean_function, seed,
                               device, dtype)


def _sample_gp_function(kernel, bounds, noise_var, num_samples, normal,
                        interpolation="kernel", mean_function=None, seed=0,
                        device="cuda", dtype=None) -> Callable:
    """``sample_gp_function`` with the draw's float64 standard normal
    ``normal`` (one per grid point) given."""
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    inputs_np = linearly_spaced_combinations(bounds, num_samples)
    n = inputs_np.shape[0]
    cov = np_kernel(kernel, inputs_np) + JITTER * np.eye(n)
    chol_np = scipy.linalg.cholesky(cov, lower=True)
    output_np = chol_np @ np.asarray(normal, dtype=np.float64).reshape(n)
    to = dict(dtype=dtype, device=device)
    calls = [0]

    def _noise(x, noise, gen):
        if not noise:
            return 0.0
        if gen is None:
            gen = torch.Generator().manual_seed(
                int(np.random.SeedSequence([seed, calls[0]])
                    .generate_state(1)[0]))
            calls[0] += 1
        draw = torch.randn((x.shape[0], 1), generator=gen, dtype=dtype,
                           device=gen.device)
        return float(np.sqrt(noise_var)) * draw.to(device)

    if interpolation == "kernel":
        inputs = torch.tensor(inputs_np, **to)
        alpha = torch.tensor(scipy.linalg.cho_solve((chol_np, True),
                                                    output_np), **to)

        def evaluate_rkhs(x, noise: bool = True,
                          generator: Optional[torch.Generator] = None):
            x = torch.atleast_2d(torch.as_tensor(x, **to))
            y = (kernel.K(x, inputs) @ alpha)[:, None]
            if mean_function is not None:
                y = y + mean_function(x)
            return y + _noise(x, noise, generator)

        return evaluate_rkhs

    def evaluate_linear(x, noise: bool = True,
                        generator: Optional[torch.Generator] = None):
        x = torch.atleast_2d(torch.as_tensor(x, **to))
        y = scipy.interpolate.griddata(inputs_np, output_np,
                                       x.cpu().numpy(), method="linear")
        y = torch.atleast_2d(torch.as_tensor(y, **to).squeeze()).T
        if mean_function is not None:
            y = y + mean_function(x)
        return y + _noise(x, noise, generator)

    return evaluate_linear

"""GP hyperparameter learning by marginal-likelihood gradient ascent.

Counterpart of ``safeopt_tpu/gp/hyperopt.py``. The log marginal
likelihood is differentiable through the Cholesky, so autograd and
``torch.optim.Adam`` on log-transformed kernel leaves (``kernels.
kernel_leaves``) fit any kernel tree, ARD vectors and Product/Sum
compositions included, without per-kernel code.

Numerics: every fit runs in float64, whatever the models' dtype. The
restarts run as one batch (``torch.func.vmap`` over a leading restart
dimension, the counterpart of ``jax.vmap``) on one device: the card
(``device='auto'`` or ``'accel'``) or the CPU (``'cpu'``). Factors use
``torch.linalg.cholesky_ex``: a restart whose gram is not positive
definite gets a non-finite LML for itself alone, with no host read a
step (``torch.linalg.cholesky`` raises on CUDA where JAX returns NaN).
The JAX package routes ``'auto'`` to the host CPU and refuses
``'accel'`` with restarts; both guard a TPU runtime and are not ported.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.optimize
import torch

from .kernels import kernel_leaves, with_leaves

__all__ = ["log_marginal_likelihood", "sparse_log_marginal_likelihood",
           "fit_hyperparameters", "fit_device"]

_LOG_2PI = math.log(2.0 * math.pi)


def fit_device(device: str) -> torch.device:
    """The device of a fit: ``'cpu'`` the CPU, ``'auto'`` and ``'accel'``
    the card."""
    if device not in ("auto", "cpu", "accel"):
        raise ValueError("device must be 'auto', 'cpu' or 'accel', "
                         f"got {device!r}")
    return torch.device("cpu" if device == "cpu" else "cuda")


def _f64(a, device) -> torch.Tensor:
    """``a`` as a float64 tensor on ``device`` (a tensor keeps its graph)."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _cholesky(K: torch.Tensor):
    """Lower factor of the symmetrized ``K`` and whether it succeeded
    (``jnp.linalg.cholesky`` symmetrizes its input too)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (K + K.T))
    return L, info == 0


def log_marginal_likelihood(kernel, X, Y, noise_var) -> torch.Tensor:
    """Exact GP log marginal likelihood log p(Y | X, theta):
    ``-0.5 y^T K^-1 y - sum(log diag L) - n/2 log(2 pi)`` with ``K =
    kern(X) + noise I``; NaN where ``K`` does not factor. ``X`` and ``Y``
    are taken in float64 on ``noise_var``'s device when it is a tensor,
    else on their own (the CPU for arrays)."""
    dev = noise_var.device if torch.is_tensor(noise_var) else (
        X.device if torch.is_tensor(X) else torch.device("cpu"))
    X = _f64(X, dev)
    y = _f64(Y, dev).reshape(X.shape[0], -1)[:, :1]
    n = X.shape[0]
    K = kernel.K(X) + noise_var * torch.eye(n, dtype=X.dtype, device=dev)
    L, ok = _cholesky(K)
    alpha = torch.cholesky_solve(y, L)[:, 0]
    lml = (-0.5 * torch.dot(y[:, 0], alpha)
           - torch.sum(torch.log(torch.diagonal(L)))
           - 0.5 * n * _LOG_2PI)
    return torch.where(ok, lml, torch.nan)


def sparse_log_marginal_likelihood(kernel, X, Y, Z, noise_var
                                   ) -> torch.Tensor:
    """DTC log marginal likelihood in O(m^2 n).

    ``log N(y; 0, K_xz K_zz^-1 K_zx + s2 I)`` via the Woodbury identity
    with ``A = K_zz + K_zx K_xz / s2``:

        logdet = n log s2 + logdet A - logdet K_zz
        quad   = (y.y - (K_zx y)^T A^-1 (K_zx y) / s2) / s2

    Differentiable in the kernel leaves and in the inducing locations
    ``Z``; NaN where ``A`` or ``K_zz`` does not factor. Operands are
    taken in float64 on ``Z``'s device when it is a tensor.
    """
    dev = Z.device if torch.is_tensor(Z) else (
        noise_var.device if torch.is_tensor(noise_var)
        else torch.device("cpu"))
    X = _f64(X, dev)
    y = _f64(Y, dev).reshape(X.shape[0], -1)[:, 0]
    Z = _f64(Z, dev)
    n, m = X.shape[0], Z.shape[0]
    s2 = noise_var
    Kzz = kernel.K(Z) + 1e-8 * torch.eye(m, dtype=X.dtype, device=dev)
    Kzx = kernel.K(Z, X)
    La, ok_a = _cholesky(Kzz + Kzx @ Kzx.T / s2)
    Lz, ok_z = _cholesky(Kzz)
    log_s2 = torch.log(s2 if torch.is_tensor(s2) else torch.tensor(
        float(s2), dtype=X.dtype, device=dev))
    logdet = (n * log_s2
              + 2.0 * torch.sum(torch.log(torch.diagonal(La)))
              - 2.0 * torch.sum(torch.log(torch.diagonal(Lz))))
    b = Kzx @ y
    c = torch.cholesky_solve(b[:, None], La)[:, 0]
    quad = (torch.dot(y, y) - torch.dot(b, c) / s2) / s2
    lml = -0.5 * (quad + logdet + n * _LOG_2PI)
    return torch.where(ok_a & ok_z, lml, torch.nan)


def _finite_rows(tensors: List[torch.Tensor]) -> torch.Tensor:
    """(B,) True where every entry of a restart's tensors is finite."""
    ok = None
    for t in tensors:
        row = torch.isfinite(t.reshape(t.shape[0], -1)).all(dim=1)
        ok = row if ok is None else ok & row
    return ok


def fit_hyperparameters(kernel, X, Y, noise_var: float, *,
                        steps: int = 200, learning_rate: float = 0.05,
                        optimize_noise: bool = True,
                        noise_floor: float = 1e-6,
                        restarts: int = 0, restart_scale: float = 1.5,
                        seed: int = 0, draws: Optional[torch.Tensor] = None,
                        lml_fn: Optional[Callable] = None,
                        polish: bool = True, inducing=None,
                        device: str = "auto") -> Tuple:
    """Maximize the marginal likelihood over the kernel's leaves (and the
    noise) with Adam in log space: a leaf ``v`` is optimized as
    ``log(max(v, 1e-10))``, the noise as ``p`` with ``noise = exp(p) +
    noise_floor``.

    ``restarts`` adds that many runs from log-space perturbed starts
    (``restart_scale`` standard deviations); run 0 starts from the given
    hyperparameters. The perturbations are ``restart_scale * draws``:
    ``draws`` (restarts, P) standard normals, P the log-space
    coordinates (the kernel's leaves flattened in ``kernel_leaves``
    order, then the noise), or, when None, ``torch.randn`` from a CPU
    ``torch.Generator`` seeded with ``seed``. All runs are one batch, and
    the loss is the sum of the runs' losses, so each run's gradient is
    its own. The best finite run wins, then a BFGS polish
    (``scipy.optimize.minimize``) from it is kept only when finite and
    better.

    ``lml_fn(kernel, noise_var) -> scalar`` overrides the objective (the
    sparse model's DTC LML). ``inducing``: (m, d) locations optimized
    jointly in raw input space (restarts share them), with an
    ``lml_fn(kernel, noise_var, Z)``; the return is then ``(kernel,
    noise_var, Z, lml)``, else ``(kernel, noise_var, lml)``. The fitted
    kernel holds float64 CPU tensors. If no run is finite the input
    hyperparameters come back with their own LML.

    ``device``: ``'auto'`` or ``'accel'`` fits on the card, ``'cpu'`` on
    the CPU; in float64 either way.
    """
    dev = fit_device(device)
    if inducing is not None and lml_fn is None:
        raise ValueError(
            "inducing= requires an lml_fn(kernel, noise_var, Z) "
            "objective (e.g. sparse_log_marginal_likelihood); the "
            "default exact-GP objective has no inducing points")
    if lml_fn is None:
        Xd = _f64(X, dev)
        Yd = _f64(Y, dev).reshape(-1, 1)

        def lml_fn(kern, nv):
            return log_marginal_likelihood(kern, Xd, Yd, nv)

    leaves = kernel_leaves(kernel)
    log_leaves = [torch.log(torch.clamp(_f64(v, dev), min=1e-10))
                  for v in leaves]
    log_noise = torch.log(torch.tensor(max(float(noise_var), noise_floor),
                                       dtype=torch.float64, device=dev))
    fixed_noise = torch.tensor(float(noise_var), dtype=torch.float64,
                               device=dev)
    Z0 = None
    if inducing is not None:
        Z0 = _f64(np.atleast_2d(np.asarray(inducing, dtype=np.float64)),
                  dev)

    def unpack(kls, nz):
        kern = with_leaves(kernel, [torch.exp(v) for v in kls])
        nv = torch.exp(nz) + noise_floor if optimize_noise else fixed_noise
        return kern, nv

    def loss(kls, nz, Zv=None):
        kern, nv = unpack(kls, nz)
        if Zv is not None:
            return -lml_fn(kern, nv, Zv)
        return -lml_fn(kern, nv)

    # the batch: run 0 from the given parameters, runs 1..r perturbed in
    # every log-space coordinate; inducing locations are shared
    r = int(restarts)
    start = log_leaves + [log_noise]
    sizes = [v.numel() for v in start]
    if r > 0:
        if draws is None:
            gen = torch.Generator().manual_seed(int(seed))
            draws = torch.randn((r, sum(sizes)), generator=gen,
                                dtype=torch.float64)
        draws = _f64(draws, dev).reshape(r, sum(sizes))
        pert = torch.split(restart_scale * draws, sizes, dim=1)
    batch = []
    for i, v in enumerate(start):
        rows = [v[None]]
        if r > 0:
            rows.append(v[None] + pert[i].reshape((r,) + v.shape))
        batch.append(torch.cat(rows).detach().requires_grad_())
    params = batch
    if Z0 is not None:
        params = batch + [Z0.expand((r + 1,) + Z0.shape).clone()
                          .requires_grad_()]

    def batch_loss(ps):
        kls, nz = ps[:len(leaves)], ps[len(leaves)]
        Zv = ps[len(leaves) + 1] if Z0 is not None else None
        return loss(kls, nz, Zv)

    batched = torch.func.vmap(batch_loss)
    # torch.optim.Adam's defaults are optax.adam's (b1 0.9, b2 0.999,
    # eps 1e-8), and both add eps outside the square root:
    # m_hat / (sqrt(v_hat) + eps) in optax 0.2.6's scale_by_adam
    # (optax/_src/transform.py:300) and torch 2.13's
    # (exp_avg_sq.sqrt() / bias_correction2_sqrt).add_(eps)
    # (torch/optim/adam.py:544, its foreach path :765)
    opt = torch.optim.Adam(params, lr=learning_rate)
    for _ in range(int(steps)):
        opt.zero_grad(set_to_none=False)
        batched(params).sum().backward()
        # a NaN loss poisons Adam's moments for good: zero that run's
        # non-finite gradients instead, so a diverged start freezes
        # (safeopt_tpu/gp/hyperopt.py:172-175)
        for p in params:
            if p.grad is not None:      # None: a leaf the kernel ignores
                p.grad.masked_fill_(~torch.isfinite(p.grad), 0.0)
        opt.step()
    with torch.no_grad():
        lmls = -batched(params)
        ok = (torch.isfinite(lmls) & _finite_rows(params)).cpu().numpy()
        lmls = lmls.cpu().numpy()

    if not ok.any():
        logging.warning(
            "hyperparameter fit produced non-finite LML/params in all %d "
            "run(s); keeping the input hyperparameters", lmls.shape[0])
        with torch.no_grad():
            lml0 = float(-loss(log_leaves, log_noise, Z0))
        if Z0 is not None:
            return (kernel, float(noise_var), Z0.cpu().numpy(), lml0)
        return kernel, float(noise_var), lml0

    best = int(np.argmax(np.where(ok, lmls, -np.inf)))
    best_p = [p.detach()[best] for p in params]
    lml = float(lmls[best])

    if polish:
        # BFGS from the best Adam iterate (GPy's optimize() is
        # quasi-Newton; Adam's fixed step stalls short of the optimum on
        # stiff LML surfaces); kept only when finite and better
        shapes = [p.shape for p in best_p]
        counts = [p.numel() for p in best_p]

        def unravel(v):
            return [t.reshape(s) for t, s in
                    zip(torch.split(v, counts), shapes)]

        def value_and_grad(x):
            v = torch.tensor(x, dtype=torch.float64,
                             device=dev).requires_grad_()
            val = batch_loss(unravel(v))
            (g,) = torch.autograd.grad(val, v)
            return float(val.detach()), g.cpu().numpy()

        v0 = torch.cat([p.reshape(-1) for p in best_p]).cpu().numpy()
        try:
            with np.errstate(all="ignore"):
                res = scipy.optimize.minimize(
                    value_and_grad, v0, jac=True, method="BFGS",
                    options={"maxiter": 100})
            lml1 = -float(res.fun)
            if np.all(np.isfinite(res.x)) and np.isfinite(lml1) \
                    and lml1 > lml:
                best_p = unravel(torch.tensor(res.x, dtype=torch.float64,
                                              device=dev))
                lml = lml1
        except Exception:   # pragma: no cover - BFGS is best-effort
            logging.debug("BFGS polish failed; keeping Adam result",
                          exc_info=True)

    with torch.no_grad():
        kern, nv = unpack(best_p[:len(leaves)], best_p[len(leaves)])
    kern = with_leaves(kernel, [v.detach().cpu().clone()
                                for v in kernel_leaves(kern)])
    if Z0 is not None:
        return (kern, float(nv), best_p[len(leaves) + 1].cpu().numpy(),
                lml)
    return kern, float(nv), lml

"""K1-K4 as ``torch.library`` operators, so that a traced program holds them.

``torch.export`` cannot see into a ``ctypes`` launch. Registered as
custom operators with a fake implementation each (the output's shape and
dtype from the operands'), the grid kernels become nodes of an exported
graph (``utils/deployment.py``): ``safeopt::fused_intervals`` (K1),
``safeopt::fused_intervals_plan`` (K2), ``safeopt::fused_expander`` (K3,
with an ``(N,)`` or an ``(R, N)`` unsafe mask) and
``safeopt::fused_expander_plan`` (K4). Each operator's implementation is
the kernel's wrapper itself: on a CUDA tensor it launches the
hand-written kernel through the one C launcher (and adds one to the
wrapper's ``launches``), on a CPU tensor it runs the plain PyTorch
version. There is no second copy of the C interface.

The live ``SafeOpt`` step calls the wrappers directly; the traced step
(``safe_opt_core.traced_safeopt_step``) calls these operators. A process
that loads an exported program imports this module first, so that the
operators exist (``deployment.load_step`` does). Importing it builds and
loads nothing: the kernels are built at their first launch.
"""

from __future__ import annotations

import torch

from .fused_expander import fused_expander as _k3
from .fused_expander import fused_expander_plan as _k4
from .fused_posterior import fused_intervals as _k1
from .fused_posterior import fused_intervals_plan as _k2

__all__ = ["fused_intervals", "fused_intervals_plan", "fused_expander",
           "fused_expander_plan"]


@torch.library.custom_op("safeopt::fused_intervals", mutates_args=())
def fused_intervals(zt: torch.Tensor, ils: torch.Tensor, xs: torch.Tensor,
                    lm: torch.Tensor, w: torch.Tensor, scal: torch.Tensor,
                    kind: int) -> torch.Tensor:
    """K1: (G, 2, N) interval rows (``fused_posterior.fused_intervals``)."""
    return _k1(zt, ils, xs, lm, w, scal, kind)


@fused_intervals.register_fake
def _(zt, ils, xs, lm, w, scal, kind):
    return zt.new_empty((xs.shape[0], 2, zt.shape[1]))


@torch.library.custom_op("safeopt::fused_intervals_plan", mutates_args=())
def fused_intervals_plan(zt: torch.Tensor, xs: torch.Tensor, lm: torch.Tensor,
                         w: torch.Tensor, scales: torch.Tensor,
                         pvar: torch.Tensor, plan: torch.Tensor,
                         scal: torch.Tensor) -> torch.Tensor:
    """K2: (2, N) interval rows of one plan GP
    (``fused_posterior.fused_intervals_plan``)."""
    return _k2(zt, xs, lm, w, scales, pvar, plan, scal)


@fused_intervals_plan.register_fake
def _(zt, xs, lm, w, scales, pvar, plan, scal):
    return zt.new_empty((2, zt.shape[1]))


@torch.library.custom_op("safeopt::fused_expander", mutates_args=())
def fused_expander(zt: torch.Tensor, unsafe: torch.Tensor, mu: torch.Tensor,
                   sigma: torch.Tensor, ils: torch.Tensor, xs: torch.Tensor,
                   xc: torch.Tensor, m2: torch.Tensor, cvec: torch.Tensor,
                   scal: torch.Tensor, kind: int) -> torch.Tensor:
    """K3: (G, C) bool expander predicates
    (``fused_expander.fused_expander``)."""
    return _k3(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, kind)


@fused_expander.register_fake
def _(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, kind):
    return torch.empty((xs.shape[0], xc.shape[1]), dtype=torch.bool,
                       device=zt.device)


@torch.library.custom_op("safeopt::fused_expander_plan", mutates_args=())
def fused_expander_plan(zt: torch.Tensor, unsafe: torch.Tensor,
                        mu: torch.Tensor, sigma: torch.Tensor,
                        xs: torch.Tensor, xc: torch.Tensor, m2: torch.Tensor,
                        cvec: torch.Tensor, scales: torch.Tensor,
                        pvar: torch.Tensor, plan: torch.Tensor,
                        scal: torch.Tensor) -> torch.Tensor:
    """K4: (C,) bool expander predicate of one plan GP
    (``fused_expander.fused_expander_plan``)."""
    return _k4(zt, unsafe, mu, sigma, xs, xc, m2, cvec, scales, pvar, plan,
               scal)


@fused_expander_plan.register_fake
def _(zt, unsafe, mu, sigma, xs, xc, m2, cvec, scales, pvar, plan, scal):
    return torch.empty((xc.shape[0],), dtype=torch.bool, device=zt.device)

"""K1: fused grid posterior + confidence intervals.

Counterpart of ``safeopt_tpu/ops/fused_posterior.py:454-664``
(``_interval_kernel_multi`` / ``fused_intervals_batched``). For G GPs
of one stationary family and one capacity, one pass over the grid
computes every GP's interval rows without materialising the (cap, N)
gram or whitened solve:

    k    (cap, B) = k(xs, z * ils)          difference form
    V    (cap, B) = Lm @ k                  Lm = Linv * col_mask, lower
    mu   (B,)     = sum_r w[r] V[r]
    var  (B,)     = max(kdiag - sum_r V[r]^2, 0)
    out  (G, 2, N): rows mu - beta sqrt(var), mu + beta sqrt(var)

On a CUDA tensor ``fused_intervals`` launches the hand-written kernel
``csrc/fused_intervals.cu``; on a CPU tensor it runs
``fused_intervals_plain``, the same function in plain PyTorch. Any G
>= 1 is accepted; GPs of different families or capacities run as one
launch each (the caller groups them). The TPU-only machinery (VMEM
gates, block picking, block-diagonal MXU stacking, 3-pass limbs) has
no counterpart here.

Distances use the difference form ``sum_k (x_k - z_k ils_k)^2``: the
``|x|^2 + |z|^2 - 2 x.z`` form loses digits that the ill-conditioned
factor then amplifies.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..gp.kernels import Exponential, Matern32, Matern52, RBF
from ..gp.regression import row_mask

__all__ = ["KINDS", "kind_of", "supports_kernel", "check_kernel",
           "interval_operands", "fused_intervals", "fused_intervals_plain",
           "fused_intervals_batched"]

# kernel family -> kind code of the CUDA kernels (csrc/common.cuh)
KINDS = {RBF: 0, Matern32: 1, Matern52: 2, Exponential: 3}

# Widest grid the CUDA kernels take: their shared memory grows with d
# (the block's scaled points), and stays independent of the capacity.
MAX_DIM = 64
# grid columns per step of the plain versions (bounds their memory)
PLAIN_COLS = 1 << 16


def supports_kernel(kernel, d: int) -> bool:
    """True when K1/K3 take this kernel over a d-column grid: one of
    the four stationary families, reading every grid column."""
    return (type(kernel) in KINDS and kernel.input_dim == d
            and kernel.active_dims == tuple(range(d)))


def check_kernel(kernel, d: int) -> None:
    """Raise ``NotImplementedError`` for a kernel K1/K3 do not take."""
    if not supports_kernel(kernel, d):
        raise NotImplementedError(
            f"{kernel!r} over a {d}-column grid: the port's grid kernels "
            "(K1/K3) take RBF, Matern32, Matern52 and Exponential over "
            "every grid column. Kernel algebras, context kernels and "
            "active_dims subsets need K2/K4 (the JAX package's "
            "_interval_kernel and _expander_kernel), which are still to "
            "port (ROADMAP Queue 2).")


def kind_of(kernels) -> int:
    """Kind code shared by ``kernels`` (one family only)."""
    kinds = {KINDS.get(type(k)) for k in kernels}
    if len(kinds) != 1 or None in kinds:
        raise ValueError(f"one stationary family per launch, got {kernels}")
    return kinds.pop()


def gram(kind: int, a: torch.Tensor, b_t: torch.Tensor,
         variance: torch.Tensor) -> torch.Tensor:
    """(rows, B) gram in difference form: ``a`` (rows, d) and ``b_t``
    (d, B) are both already divided by the lengthscale."""
    r2 = torch.zeros((a.shape[0], b_t.shape[1]), dtype=a.dtype,
                     device=a.device)
    for k in range(a.shape[1]):
        diff = a[:, k, None] - b_t[k, None, :]
        r2 = r2 + diff * diff
    if kind == KINDS[RBF]:
        return variance * torch.exp(-0.5 * r2)
    r = torch.sqrt(r2 + 1e-36)
    if kind == KINDS[Exponential]:
        return variance * torch.exp(-r)
    if kind == KINDS[Matern52]:
        s5r = math.sqrt(5.0) * r
        return variance * (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)
    s3r = math.sqrt(3.0) * r
    return variance * (1.0 + s3r) * torch.exp(-s3r)


def lengthscales(kernels, d: int, like: torch.Tensor) -> torch.Tensor:
    """(G, d) lengthscales in the dtype and on the device of ``like``."""
    ls = np.stack([np.broadcast_to(k.lengthscale.numpy(), (d,))
                   for k in kernels])
    return torch.tensor(ls, dtype=like.dtype, device=like.device)


def interval_operands(kernels, states, grid: torch.Tensor, beta):
    """K1's operands ``(zt, ils, xs, lm, w, scal, kind)`` for GPs of one
    family and one capacity over ``grid`` (N, d)."""
    n, d = grid.shape
    kind = kind_of(kernels)
    ls = lengthscales(kernels, d, grid)
    scal = torch.tensor([[float(k.variance), float(k.variance),
                          float(beta), 0.0] for k in kernels],
                        dtype=grid.dtype, device=grid.device)
    xs = torch.stack([st.X for st in states]) / ls[:, None, :]
    lm = torch.stack([st.Linv * row_mask(st)[None, :] for st in states])
    w = torch.stack([st.w for st in states])
    return (grid.T.contiguous(), (1.0 / ls).contiguous(), xs.contiguous(),
            lm.contiguous(), w.contiguous(), scal, kind)


def fused_intervals_plain(zt, ils, xs, lm, w, scal, kind):
    """Plain PyTorch version of K1: same operands, same function."""
    G = xs.shape[0]
    N = zt.shape[1]
    out = zt.new_empty((G, 2, N))
    for g in range(G):
        for s in range(0, N, PLAIN_COLS):
            zs = zt[:, s:s + PLAIN_COLS] * ils[g][:, None]
            V = lm[g] @ gram(kind, xs[g], zs, scal[g, 0])
            mu = torch.sum(w[g][:, None] * V, dim=0)
            var = torch.clamp(scal[g, 1] - torch.sum(V * V, dim=0), min=0.0)
            spread = scal[g, 2] * torch.sqrt(var)
            out[g, 0, s:s + PLAIN_COLS] = mu - spread
            out[g, 1, s:s + PLAIN_COLS] = mu + spread
    return out


def check_operands(named, device, dtype, shapes) -> None:
    """Raise unless every tensor is on ``device``, of ``dtype`` (where
    given), contiguous and of its expected shape, and the grid is at
    most ``MAX_DIM`` wide."""
    d = shapes["zt"][0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"the CUDA kernels take 1 to {MAX_DIM} grid "
                         f"columns, got {d}")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        want = dtype if name != "unsafe" else torch.bool
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[name])}")


def raise_on_error(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err:
        from ._build import library
        msg = library().safeopt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """Device pointer of a tensor as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def fused_intervals(zt, ils, xs, lm, w, scal, kind):
    """(G, 2, N) interval rows: K1 on CUDA, the plain version on CPU.

    ``zt`` (d, N) grid, features first; ``ils`` (G, d) inverse
    lengthscales; ``xs`` (G, cap, d) training inputs divided by the
    lengthscale; ``lm`` (G, cap, cap) masked ``Linv``; ``w`` (G, cap)
    whitened targets; ``scal`` (G, 4) = [variance, kdiag, beta, 0].
    Adds one to ``fused_intervals.launches`` per kernel launch.
    """
    if zt.device.type == "cpu":
        return fused_intervals_plain(zt, ils, xs, lm, w, scal, kind)
    if zt.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {zt.device}")
    G, cap, d = xs.shape
    N = zt.shape[1]
    dtype = zt.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64, not {dtype}")
    if kind not in KINDS.values():
        raise ValueError(f"unknown kernel kind {kind}")
    check_operands(
        dict(zt=zt, ils=ils, xs=xs, lm=lm, w=w, scal=scal), zt.device, dtype,
        dict(zt=(d, N), ils=(G, d), xs=(G, cap, d), lm=(G, cap, cap),
             w=(G, cap), scal=(G, 4)))
    lmt = lm.transpose(1, 2).contiguous()   # the kernel reads Lm^T rows
    out = torch.empty((G, 2, N), dtype=dtype, device=zt.device)

    from ._build import library
    lib = library()
    fn = (lib.safeopt_intervals_f32 if dtype == torch.float32
          else lib.safeopt_intervals_f64)
    with torch.cuda.device(zt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(zt), ptr(ils), ptr(xs), ptr(lmt), ptr(w), ptr(scal),
                 ptr(out), G, N, d, cap, kind, ctypes.c_void_p(stream))
    raise_on_error(err, "K1 (fused_intervals)")
    fused_intervals.launches += 1
    return out


fused_intervals.launches = 0


def fused_intervals_batched(kernels, states, grid: torch.Tensor, beta):
    """(G, 2, N) interval rows of GPs of one family and capacity, one
    pass over the grid for all of them."""
    return fused_intervals(*interval_operands(kernels, states, grid, beta))

"""K3: fused expander predicate for a chunk of candidates.

Counterpart of ``safeopt_tpu/ops/fused_expander.py:233-477``
(``_expander_kernel_multi`` / ``fused_expander_predicate_batched``).
For each GP g and each candidate j of a chunk of C, condition GP g on a
virtual observation at the candidate's upper bound (a closed-form
rank-1 update) and test whether any currently unsafe grid point then
has a lower bound at or above ``fmin_g``:

    cross  = M2 @ k(xs, z)       M2 = Cm^T Lm (C, cap), Cm = Linv k(X, Xc)
    E      = (k(xc, z) - cross) * inv_dd
    l2     = mu + E * gain - beta * sqrt(max(sigma^2 - E^2, 0))
    out    = any over z of (unsafe & l2 >= fmin & valid)     -> (G, C)

The candidate-side terms (``Cm``, ``dd``, ``gain``, ``M2``; O(C cap^2))
are plain PyTorch at full precision, as the JAX package leaves them to
XLA. The grid pass is the hand-written kernel ``csrc/fused_expander.cu``
on CUDA tensors and ``fused_expander_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..gp.regression import row_mask
from .fused_posterior import (PLAIN_COLS, check_operands, gram, kind_of,
                              lengthscales, ptr, raise_on_error)

__all__ = ["expander_operands", "fused_expander", "fused_expander_plain",
           "fused_expander_predicate_batched"]


def expander_operands(kernels, states, grid, unsafe, mus, sigmas, Xc, ucs,
                      valid, beta, fmin):
    """K3's operands ``(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec,
    scal, kind)``.

    ``unsafe`` (N,) bool; ``mus`` / ``sigmas`` (G, N) grid posteriors
    from the interval pass; ``Xc`` (C, d) candidate rows; ``ucs`` (G, C)
    the candidates' upper bounds per GP; ``valid`` (C,) bool;
    ``fmin`` (G,) thresholds.
    """
    n, d = grid.shape
    kind = kind_of(kernels)
    ls = lengthscales(kernels, d, grid)
    dtype = grid.dtype
    cvec, m2 = [], []
    for g, (kern, st) in enumerate(zip(kernels, states)):
        mask = row_mask(st)
        kmat_c = kern.K(st.X, Xc) * mask[:, None]             # (cap, C)
        Cm = st.Linv @ kmat_c                                 # (cap, C)
        dd2 = kern.Kdiag(Xc) + st.noise_var - torch.sum(Cm * Cm, dim=0)
        dd = torch.sqrt(torch.clamp(dd2, min=1e-30))
        gain = (ucs[g] - Cm.T @ st.w) / dd
        m2.append(Cm.T @ (st.Linv * mask[None, :]))           # (C, cap)
        cvec.append(torch.stack([1.0 / dd, gain, valid.to(dtype)]))
    scal = torch.tensor([[float(k.variance), float(k.variance),
                          float(beta), 0.0] for k in kernels],
                        dtype=dtype, device=grid.device)
    scal[:, 3] = fmin
    xs = torch.stack([st.X for st in states]) / ls[:, None, :]
    xc = Xc[None, :, :] / ls[:, None, :]
    return (grid.T.contiguous(), unsafe.contiguous(), mus.contiguous(),
            sigmas.contiguous(), (1.0 / ls).contiguous(), xs.contiguous(),
            xc.contiguous(), torch.stack(m2).contiguous(),
            torch.stack(cvec).contiguous(), scal, kind)


def fused_expander_plain(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal,
                         kind):
    """Plain PyTorch version of K3: same operands, same function."""
    G, C = xc.shape[0], xc.shape[1]
    N = zt.shape[1]
    out = torch.zeros((G, C), dtype=torch.bool, device=zt.device)
    for g in range(G):
        inv_dd, gain = cvec[g, 0][:, None], cvec[g, 1][:, None]
        valid = cvec[g, 2][:, None] > 0.5
        for s in range(0, N, PLAIN_COLS):
            e = s + PLAIN_COLS
            zs = zt[:, s:e] * ils[g][:, None]
            cross = m2[g] @ gram(kind, xs[g], zs, scal[g, 0])
            E = (gram(kind, xc[g], zs, scal[g, 0]) - cross) * inv_dd
            var2 = torch.clamp(sigma[g, s:e] * sigma[g, s:e] - E * E,
                               min=0.0)
            l2 = mu[g, s:e] + E * gain - scal[g, 2] * torch.sqrt(var2)
            hit = unsafe[None, s:e] & (l2 >= scal[g, 3]) & valid
            out[g] |= torch.any(hit, dim=1)
    return out


def fused_expander(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, kind):
    """(G, C) bool expander predicates: K3 on CUDA, the plain version on
    CPU. Operands as built by ``expander_operands``; ``scal`` (G, 4) =
    [variance, variance, beta, fmin]. Adds one to
    ``fused_expander.launches`` per kernel launch."""
    if zt.device.type == "cpu":
        return fused_expander_plain(zt, unsafe, mu, sigma, ils, xs, xc, m2,
                                    cvec, scal, kind)
    if zt.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {zt.device}")
    G, cap, d = xs.shape
    C = xc.shape[1]
    N = zt.shape[1]
    dtype = zt.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K3 takes float32 or float64, not {dtype}")
    check_operands(
        dict(zt=zt, unsafe=unsafe, mu=mu, sigma=sigma, ils=ils, xs=xs,
             xc=xc, m2=m2, cvec=cvec, scal=scal), zt.device, dtype,
        dict(zt=(d, N), unsafe=(N,), mu=(G, N), sigma=(G, N), ils=(G, d),
             xs=(G, cap, d), xc=(G, C, d), m2=(G, C, cap), cvec=(G, 3, C),
             scal=(G, 4)))
    m2t = m2.transpose(1, 2).contiguous()   # the kernel reads M2^T rows
    out = torch.zeros((G, C), dtype=torch.int32, device=zt.device)

    from ._build import library
    lib = library()
    fn = (lib.safeopt_expander_f32 if dtype == torch.float32
          else lib.safeopt_expander_f64)
    with torch.cuda.device(zt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(zt), ptr(unsafe), ptr(mu), ptr(sigma), ptr(ils),
                 ptr(xs), ptr(xc), ptr(m2t), ptr(cvec), ptr(scal), ptr(out),
                 G, N, d, cap, C, kind, ctypes.c_void_p(stream))
    raise_on_error(err, "K3 (fused_expander)")
    fused_expander.launches += 1
    return out != 0


fused_expander.launches = 0


def fused_expander_predicate_batched(kernels, states, grid, unsafe, mus,
                                     sigmas, Xc, ucs, valid, beta, fmin):
    """(G, C) expander predicates of GPs of one family and capacity, one
    grid pass per chunk for all of them. A GP with ``fmin = -inf`` still
    gets a row (the caller masks it out)."""
    return fused_expander(*expander_operands(
        kernels, states, grid, unsafe, mus, sigmas, Xc, ucs, valid, beta,
        fmin))

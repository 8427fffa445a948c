"""K3 and K4: fused expander predicate for a chunk of candidates.

K3 is the counterpart of ``safeopt_tpu/ops/fused_expander.py:233-477``
(``_expander_kernel_multi`` / ``fused_expander_predicate_batched``).
For each GP g and each candidate j of a chunk of C, condition GP g on a
virtual observation at the candidate's upper bound (a closed-form
rank-1 update) and test whether any currently unsafe grid point then
has a lower bound at or above ``fmin_g``:

    cross  = M2 @ k(xs, z)       M2 = Cm^T Lm (C, cap), Cm = Linv k(X, Xc)
    E      = (k(xc, z) - cross) * inv_dd
    l2     = mu + E * gain - beta * sqrt(max(sigma^2 - E^2, 0))
    out    = any over z of (unsafe & l2 >= fmin & valid)     -> (G, C)

One launch takes one ``unsafe`` mask (N,) for all G GPs (a SafeOpt
step), or one per campaign, (R, N) with GP g reading row g // (G / R): a
fleet's walk round (``algorithms/fleet_core.py``), as the TPU kernel
reads each campaign's mask under ``jax.vmap``. The CUDA kernel reads the
latter as a row per GP (``expander_rows_kernel``; the wrapper repeats
each campaign's row for its GPs).

K4 is the counterpart of ``:44-226`` (``_expander_kernel`` /
``fused_expander_predicate``): the same (C,) predicate for ONE GP whose
kernel K2 takes, with both grams from its plan
(``fused_posterior.part_plan``).

The candidate-side terms (``Cm``, ``dd``, ``gain``, ``M2``; O(C cap^2))
are plain PyTorch at full precision through ``Kernel.K`` / ``Kdiag``,
as the JAX package leaves them to XLA; the operands no candidate changes
(``expander_fixed``, ``expander_plan_fixed``) are built per chunk by the
live walk and once a walk by the traced one. The grid passes are the
hand-written kernels ``csrc/fused_expander.cu`` (K3) and
``csrc/fused_expander_plan.cu`` (K4) on CUDA tensors, and
``fused_expander_plain`` / ``fused_expander_plan_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..gp.regression import row_mask
from .fused_posterior import (KINDS, PLAIN_COLS, check_operands, float_dtype,
                              gram, kind_of, lengthscales, on_device,
                              part_plan, plan_gram, ptr, raise_on_error,
                              scalar, scalar_rows)

__all__ = ["expander_fixed", "expander_operands", "expander_plan_fixed",
           "fused_expander", "fused_expander_plain",
           "mask_rows", "candidate_terms", "fleet_expander_operands",
           "fused_expander_predicate_batched", "expander_plan_operands",
           "fused_expander_plan", "fused_expander_plan_plain",
           "fused_expander_predicate_single"]


def candidate_terms(kernel, state, Xc, uc, valid):
    """``(m2, cvec)`` of one GP for candidates ``Xc`` (C, d) with upper
    bounds ``uc`` (C,): ``m2`` (C, cap) = Cm^T Lm and ``cvec`` (3, C) =
    [1/dd, gain, valid], at the grid's full precision."""
    mask = row_mask(state)
    kmat_c = kernel.K(state.X, Xc) * mask[:, None]           # (cap, C)
    Cm = state.Linv @ kmat_c                                 # (cap, C)
    dd2 = kernel.Kdiag(Xc) + state.noise_var - torch.sum(Cm * Cm, dim=0)
    dd = torch.sqrt(torch.clamp(dd2, min=1e-30))
    gain = (uc - Cm.T @ state.w) / dd
    m2 = Cm.T @ (state.Linv * mask[None, :])                 # (C, cap)
    return m2, torch.stack([1.0 / dd, gain, valid.to(Xc.dtype)])


def expander_fixed(kernels, states, grid, unsafe, mus, sigmas, beta, fmin):
    """K3's operands that no candidate changes, ``((zt, unsafe, mu, sigma,
    ils, xs, scal, kind), ls)``: built once per walk by the traced step
    (``safe_opt_core._find_first_expander_traced``), per chunk by the
    live one. ``scal[:, 1]`` holds each GP's count, copied on the device
    (no host sync)."""
    n, d = grid.shape
    kind = kind_of(kernels)
    ls = lengthscales(kernels, d, grid)
    scal = scalar_rows(kernels, grid, beta,
                       {1: torch.stack([st.count for st in states]), 3: fmin})
    xs = torch.stack([st.X for st in states]) / ls[:, None, :]
    return (grid.T.contiguous(), unsafe.contiguous(), mus.contiguous(),
            sigmas.contiguous(), (1.0 / ls).contiguous(), xs.contiguous(),
            scal, kind), ls


def expander_operands(kernels, states, grid, unsafe, mus, sigmas, Xc, ucs,
                      valid, beta, fmin, fixed=None):
    """K3's operands ``(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec,
    scal, kind)``.

    ``unsafe`` (N,) bool; ``mus`` / ``sigmas`` (G, N) grid posteriors
    from the interval pass; ``Xc`` (C, d) candidate rows; ``ucs`` (G, C)
    the candidates' upper bounds per GP; ``valid`` (C,) bool;
    ``fmin`` (G,) thresholds; ``fixed`` the walk's ``expander_fixed``
    (built here when None).
    """
    if fixed is None:
        fixed = expander_fixed(kernels, states, grid, unsafe, mus, sigmas,
                               beta, fmin)
    (zt, unsafe, mu, sigma, ils, xs, scal, kind), ls = fixed
    m2, cvec = zip(*[candidate_terms(kern, st, Xc, ucs[g], valid)
                     for g, (kern, st) in enumerate(zip(kernels, states))])
    xc = Xc[None, :, :] / ls[:, None, :]
    return (zt, unsafe, mu, sigma, ils, xs, xc.contiguous(),
            torch.stack(m2).contiguous(), torch.stack(cvec).contiguous(),
            scal, kind)


def fleet_expander_operands(kernels, states, grid, unsafe, mus, sigmas, Xc,
                            ucs, valid, beta, fmin):
    """K3's operands for the same g GPs in each of R campaigns, every
    campaign with its own candidates and mask: ``states`` holds each GP's
    fields with a leading campaign axis R; ``unsafe`` (R, N); ``mus`` /
    ``sigmas`` (R, g, N); ``Xc`` (R, C, d); ``ucs`` (R, g, C); ``valid``
    (R, C); ``fmin`` (g,). GP j of campaign r is the launch's GP ``r g +
    j`` and reads mask row r. The candidate terms are
    ``candidate_terms``'s, batched over the campaigns (``torch.func.vmap``:
    batched products)."""
    N, d = grid.shape
    R, C, _ = Xc.shape
    g = len(kernels)
    cap = states[0].X.shape[1]
    kind = kind_of(kernels)
    ls = lengthscales(kernels, d, grid)                     # (g, d)
    terms = [torch.func.vmap(candidate_terms, in_dims=(None, 0, 0, 0, 0))(
        kern, st, Xc, ucs[:, j], valid)
        for j, (kern, st) in enumerate(zip(kernels, states))]
    m2 = torch.stack([m for m, _ in terms], dim=1)          # (R, g, C, cap)
    cvec = torch.stack([c for _, c in terms], dim=1)        # (R, g, 3, C)
    scal = torch.tensor([[float(k.variance), float(k.variance),
                          float(beta), 0.0] for k in kernels] * R,
                        dtype=grid.dtype, device=grid.device)
    scal[:, 1] = torch.stack([st.count for st in states], dim=1).reshape(-1)
    scal[:, 3] = fmin.repeat(R)
    xs = torch.stack([st.X for st in states], dim=1) / ls[None, :, None, :]
    xc = Xc[:, None, :, :] / ls[None, :, None, :]
    return (grid.T.contiguous(), unsafe.contiguous(),
            mus.reshape(R * g, N).contiguous(),
            sigmas.reshape(R * g, N).contiguous(), (1.0 / ls).repeat(R, 1),
            xs.reshape(R * g, cap, d), xc.reshape(R * g, C, d),
            m2.reshape(R * g, C, cap).contiguous(),
            cvec.reshape(R * g, 3, C).contiguous(), scal, kind)


def candidate_hits(gram_at, xs, xc, unsafe, mu, sigma, m2, cvec, beta,
                   fmin) -> torch.Tensor:
    """(C,) plain expander predicate of one GP; ``gram_at(a, s, e)`` is
    the gram of the rows ``a`` against grid columns s:e."""
    N = unsafe.shape[0]
    out = torch.zeros((xc.shape[0],), dtype=torch.bool, device=xc.device)
    inv_dd, gain = cvec[0][:, None], cvec[1][:, None]
    valid = cvec[2][:, None] > 0.5
    for s in range(0, N, PLAIN_COLS):
        e = min(s + PLAIN_COLS, N)
        cross = m2 @ gram_at(xs, s, e)
        E = (gram_at(xc, s, e) - cross) * inv_dd
        var2 = torch.clamp(sigma[s:e] * sigma[s:e] - E * E, min=0.0)
        l2 = mu[s:e] + E * gain - beta * torch.sqrt(var2)
        hit = unsafe[None, s:e] & (l2 >= fmin) & valid
        out |= torch.any(hit, dim=1)
    return out


def mask_rows(unsafe, G: int) -> int:
    """GPs per row of ``unsafe``: (N,) is one mask for all G GPs, (R, N)
    one mask per campaign of G / R GPs each (campaign-major: GP g reads
    row g // (G / R))."""
    R = 1 if unsafe.dim() == 1 else unsafe.shape[0]
    if unsafe.dim() not in (1, 2) or R < 1 or G % R:
        raise ValueError(f"unsafe of shape {tuple(unsafe.shape)} does not "
                         f"split {G} GPs into equal campaigns")
    return G // R


def fused_expander_plain(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal,
                         kind):
    """Plain PyTorch version of K3: same operands, same function."""
    G = xs.shape[0]
    gpr = mask_rows(unsafe, G)
    rows = unsafe.reshape(-1, zt.shape[1])
    return torch.stack([
        candidate_hits(lambda a, s, e, g=g: gram(kind, a,
                                                 zt[:, s:e] * ils[g][:, None],
                                                 scal[g, 0]),
                       xs[g], xc[g], rows[g // gpr], mu[g], sigma[g], m2[g],
                       cvec[g], scal[g, 2], scal[g, 3])
        for g in range(G)])


def fused_expander(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, kind):
    """(G, C) bool expander predicates: K3 on CUDA, the plain version on
    CPU. Operands as built by ``expander_operands``; ``m2`` (G, C, cap)
    is read in its own layout; ``scal`` (G, 4) = [variance, count, beta,
    fmin]; ``unsafe`` (N,) one mask for every GP, or (R, N) one per
    campaign of G / R GPs (``mask_rows``). The kernel reads training rows
    and columns of ``m2`` below each GP's count only: past it ``m2`` must
    be zero, as it is for the masked factor. Adds one to
    ``fused_expander.launches`` per kernel launch."""
    if zt.device.type == "cpu":
        return fused_expander_plain(zt, unsafe, mu, sigma, ils, xs, xc, m2,
                                    cvec, scal, kind)
    if zt.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {zt.device}")
    G, cap, d = xs.shape
    C = xc.shape[1]
    N = zt.shape[1]
    dtype = float_dtype(zt, "K3")
    if kind not in KINDS.values():
        raise ValueError(f"unknown kernel kind {kind}")
    gpr = mask_rows(unsafe, G)
    check_operands(
        dict(zt=zt, unsafe=unsafe, mu=mu, sigma=sigma, ils=ils, xs=xs,
             xc=xc, m2=m2, cvec=cvec, scal=scal), zt.device, dtype,
        dict(zt=(d, N), unsafe=(N,) if unsafe.dim() == 1 else (G // gpr, N),
             mu=(G, N), sigma=(G, N), ils=(G, d), xs=(G, cap, d),
             xc=(G, C, d), m2=(G, C, cap), cvec=(G, 3, C), scal=(G, 4)))
    # the kernel reads one mask, or a row per GP: a campaign's mask is
    # repeated for its GPs (a row index held in the kernel made its float32
    # instance spill)
    rows = int(unsafe.dim() == 2 and gpr < G)
    if rows:
        unsafe = unsafe.repeat_interleave(gpr, dim=0)
    elif unsafe.dim() == 2:
        unsafe = unsafe[0]
    out = torch.zeros((G, C), dtype=torch.int32, device=zt.device)

    from ._build import library
    lib = library()
    fn = (lib.safeopt_expander_f32 if dtype == torch.float32
          else lib.safeopt_expander_f64)
    with torch.cuda.device(zt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(zt), ptr(unsafe), ptr(mu), ptr(sigma), ptr(ils),
                 ptr(xs), ptr(xc), ptr(m2), ptr(cvec), ptr(scal), ptr(out),
                 G, N, d, cap, C, kind, rows, ctypes.c_void_p(stream))
    raise_on_error(err, "K3 (fused_expander)")
    fused_expander.launches += 1
    return out != 0


fused_expander.launches = 0


def fused_expander_predicate_batched(kernels, states, grid, unsafe, mus,
                                     sigmas, Xc, ucs, valid, beta, fmin,
                                     traced: bool = False, fixed=None):
    """(G, C) expander predicates of GPs of one family and capacity, one
    grid pass per chunk for all of them (with ``traced`` K3 through its
    ``torch.library`` operator; ``fixed`` the walk's ``expander_fixed``).
    A GP with ``fmin = -inf`` still gets a row (the caller masks it
    out)."""
    ops = expander_operands(kernels, states, grid, unsafe, mus, sigmas, Xc,
                            ucs, valid, beta, fmin, fixed)
    if traced:
        from .library import fused_expander as op
        return op(*ops)
    return fused_expander(*ops)


def expander_plan_fixed(kernel, state, grid, unsafe, mu, sigma, beta, fmin):
    """K4's operands that no candidate changes, ``(zt, unsafe, mu, sigma,
    xs, scales, pvar, plan, scal)`` (``expander_fixed``'s counterpart);
    ``scal`` = [0, count, beta, fmin], the count copied on the device."""
    scales, pvar, plan, _ = part_plan(kernel, grid.shape[1], grid)
    if on_device([kernel], grid):
        scal = torch.stack([grid.new_zeros(()), state.count.to(grid.dtype),
                            scalar(beta, grid), scalar(fmin, grid)])
    else:
        scal = torch.tensor([0.0, 0.0, float(beta), 0.0], dtype=grid.dtype,
                            device=grid.device)
        scal[1] = state.count
        scal[3] = fmin
    return (grid.T.contiguous(), unsafe.contiguous(), mu.contiguous(),
            sigma.contiguous(), state.X.contiguous(), scales, pvar, plan,
            scal)


def expander_plan_operands(kernel, state, grid, unsafe, mu, sigma, Xc, uc,
                           valid, beta, fmin, fixed=None):
    """K4's operands ``(zt, unsafe, mu, sigma, xs, xc, m2, cvec, scales,
    pvar, plan, scal)`` for one GP: ``mu`` / ``sigma`` (N,) its grid
    posterior, ``uc`` (C,) its candidates' upper bounds, ``fmin`` its
    threshold, ``fixed`` the walk's ``expander_plan_fixed`` (built here
    when None)."""
    if fixed is None:
        fixed = expander_plan_fixed(kernel, state, grid, unsafe, mu, sigma,
                                    beta, fmin)
    zt, unsafe, mu, sigma, xs, scales, pvar, plan, scal = fixed
    m2, cvec = candidate_terms(kernel, state, Xc, uc, valid)
    return (zt, unsafe, mu, sigma, xs, Xc.contiguous(), m2.contiguous(),
            cvec.contiguous(), scales, pvar, plan, scal)


def fused_expander_plan_plain(zt, unsafe, mu, sigma, xs, xc, m2, cvec,
                              scales, pvar, plan, scal):
    """Plain PyTorch version of K4: same operands, same function."""
    kinds, terms = plan.tolist()
    rows = scales.tolist()
    return candidate_hits(
        lambda a, s, e: plan_gram(a, zt[:, s:e], rows, pvar, kinds, terms),
        xs, xc, unsafe, mu, sigma, m2, cvec, scal[2], scal[3])


def fused_expander_plan(zt, unsafe, mu, sigma, xs, xc, m2, cvec, scales,
                        pvar, plan, scal):
    """(C,) bool expander predicate of one GP with a kernel plan: K4 on
    CUDA, the plain version on CPU. Operands as built by
    ``expander_plan_operands``; as in K3, ``m2`` (C, cap) is read in its
    own layout and must be zero past the count ``scal[1]``. Adds one to
    ``fused_expander_plan.launches`` per kernel launch."""
    if zt.device.type == "cpu":
        return fused_expander_plan_plain(zt, unsafe, mu, sigma, xs, xc, m2,
                                         cvec, scales, pvar, plan, scal)
    if zt.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {zt.device}")
    cap, d = xs.shape
    C = xc.shape[0]
    N = zt.shape[1]
    P = pvar.shape[0]
    dtype = float_dtype(zt, "K4")
    check_operands(
        dict(zt=zt, unsafe=unsafe, mu=mu, sigma=sigma, xs=xs, xc=xc, m2=m2,
             cvec=cvec, scales=scales, pvar=pvar, plan=plan, scal=scal),
        zt.device, dtype,
        dict(zt=(d, N), unsafe=(N,), mu=(N,), sigma=(N,), xs=(cap, d),
             xc=(C, d), m2=(C, cap), cvec=(3, C), scales=(P, d), pvar=(P,),
             plan=(2, P), scal=(4,)))
    out = torch.zeros((C,), dtype=torch.int32, device=zt.device)

    from ._build import library
    lib = library()
    fn = (lib.safeopt_expander_plan_f32 if dtype == torch.float32
          else lib.safeopt_expander_plan_f64)
    with torch.cuda.device(zt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(zt), ptr(unsafe), ptr(mu), ptr(sigma), ptr(xs), ptr(xc),
                 ptr(m2), ptr(cvec), ptr(scales), ptr(pvar), ptr(plan),
                 ptr(scal), ptr(out), N, d, cap, C, P,
                 ctypes.c_void_p(stream))
    raise_on_error(err, "K4 (fused_expander_plan)")
    fused_expander_plan.launches += 1
    return out != 0


fused_expander_plan.launches = 0


def fused_expander_predicate_single(kernel, state, grid, unsafe, mu, sigma,
                                    Xc, uc, valid, beta, fmin,
                                    traced: bool = False, fixed=None):
    """(C,) expander predicate of one GP whose kernel K2/K4 take (with
    ``traced`` K4 through its operator; ``fixed`` the walk's
    ``expander_plan_fixed``)."""
    ops = expander_plan_operands(kernel, state, grid, unsafe, mu, sigma, Xc,
                                 uc, valid, beta, fmin, fixed)
    if traced:
        from .library import fused_expander_plan as op
        return op(*ops)
    return fused_expander_plan(*ops)

"""K1 and K2: fused grid posterior + confidence intervals.

K1 is the counterpart of ``safeopt_tpu/ops/fused_posterior.py:454-664``
(``_interval_kernel_multi`` / ``fused_intervals_batched``). For G GPs
of one stationary family and one capacity, one pass over the grid
computes every GP's interval rows without materialising the (cap, N)
gram or whitened solve:

    k    (cap, B) = k(xs, z * ils)          difference form
    V    (cap, B) = Lm @ k                  Lm = Linv * col_mask, lower
    mu   (B,)     = sum_r w[r] V[r]
    var  (B,)     = max(kdiag - sum_r V[r]^2, 0)
    out  (G, 2, N): rows mu - beta sqrt(var), mu + beta sqrt(var)

K2 is the counterpart of ``:294-447`` (``_interval_kernel`` /
``fused_intervals``): the same rows for ONE GP whose kernel is a
Sum/Product algebra of RBF, Matern32, Matern52, Exponential, Cosine and
Bias leaves, any of them on a subset of the columns (``active_dims``),
which is how contextual SafeOpt models its context columns. The kernel
is expanded into a sum of products (``terms_of``) and shipped as a
*plan* (``part_plan``): per leaf a kind code, a term index, a variance
and a scale row with 1/lengthscale on its active columns and 0 on the
others. The gram takes raw inputs; each leaf's distance is
``sum_k ((x_k - z_k) s_k)^2``, leaf values multiply within a term and
terms add.

On a CUDA tensor ``fused_intervals`` / ``fused_intervals_plan`` launch
the hand-written kernels ``csrc/fused_intervals.cu`` /
``csrc/fused_intervals_plan.cu``; on a CPU tensor they run
``fused_intervals_plain`` / ``fused_intervals_plan_plain``, the same
functions in plain PyTorch. The TPU-only machinery (VMEM gates, block
picking, block-diagonal MXU stacking, the TPU's products-fused-or-not
policy) has no counterpart here.

K1-3p and K2-3p (``fused_intervals3`` / ``fused_intervals_plan3``) are
K1 and K2 with the TPU kernels' ``three_pass=True`` product
(``_tri_matmul``): ``V = Lm_hi k_hi + Lm_hi k_lo + Lm_lo k_hi`` over bf16
limbs (``split_limbs``), the certified path's interval pass. In float32
they run on Hopper's warpgroup tensor-core product
(``csrc/fused_intervals3.cu``, ``intervals3.cuh``), the factor's limbs cut
once per call here and laid out in the order the kernel reads them
(``factor_chunks``); in float64 they are the ``ThreePassProduct``
instances of K1's and K2's sources, a check. Their plain versions
(``fused_intervals3_plain``, ``fused_intervals_plan3_plain``) cut the
limbs as the kernels do: from float32 operands with ``lo`` rounded to
bf16 (a tensor-core operand) and the gram computed bit for bit as the
kernel computes it (``kernel_gram``, ``kernel_plan_gram``: a gram one
ulp off can round a limb the other way), the products and the epilogue
in float64 and the rows returned in float32; from float64 operands with
``lo`` unrounded, all in float64, as the JAX package's float64 3-pass
product.

A GP whose kernel neither takes (White, RatQuad, StdPeriodic, Linear,
Poly or MLP anywhere in its tree) runs on SafeOpt's eager route
(``algorithms/safe_opt_core.py``), as the JAX package runs it on XLA;
``supports_kernel`` and ``supports_plan`` decide it from the kernel's
type alone.

K2 and K4 take a plan of any number of leaves: up to ``MAX_LEAVES`` it
is staged in static shared memory, past it the same sources' wide
instances stage it in dynamic shared memory. The kernels take at most
``MAX_DIM`` grid columns and refuse wider grids; the plain versions, on
CPU tensors, take any.

Distances use the difference form: the ``|x|^2 + |z|^2 - 2 x.z`` form
loses digits that the ill-conditioned factor then amplifies.

The functions that build the operands read the kernels' hyperparameters
on the host and upload them once (the live step, whose kernels keep
them there), or, when they lie on the grid's device (``on_device``: the
traced step of ``torch.export``), build the same values there with no
host read.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..gp.kernels import (Bias, Cosine, Exponential, Matern32, Matern52,
                          Product, RBF, Sum, kernel_leaves)
from ..gp.regression import row_mask

__all__ = ["KINDS", "LEAF_KINDS", "kind_of", "supports_kernel",
           "supports_plan", "terms_of",
           "part_plan", "round_limb", "split_limbs", "kernel_gram",
           "kernel_plan_gram", "interval_operands",
           "fleet_interval_operands", "factor_chunks",
           "fused_intervals",
           "fused_intervals_plain", "fused_intervals3",
           "fused_intervals3_plain", "fused_intervals_batched",
           "interval_plan_operands", "fused_intervals_plan",
           "fused_intervals_plan_plain", "fused_intervals_plan3",
           "fused_intervals_plan3_plain", "fused_intervals_single",
           "on_device", "scalar", "scalar_rows"]

# kernel family -> kind code of the CUDA kernels (csrc/common.cuh); K1/K3
# take the first four, K2/K4 every leaf kind
KINDS = {RBF: 0, Matern32: 1, Matern52: 2, Exponential: 3}
LEAF_KINDS = {**KINDS, Cosine: 4, Bias: 5}
BIAS = LEAF_KINDS[Bias]

# Widest grid the CUDA kernels take: their shared memory grows with d
# (the block's scaled points), and stays independent of the capacity.
MAX_DIM = 64
# Leaves of a K2/K4 plan staged in static shared memory (csrc/common.cuh
# kMaxLeaves); a longer plan runs the kernels' wide instances, which stage
# it in dynamic shared memory.
MAX_LEAVES = 8
# grid columns per step of the plain versions (bounds their memory)
PLAIN_COLS = 1 << 16
# The float32 K1-3p/K2-3p factor chunks (csrc/intervals3.cuh kTM3,
# kKC3): row tiles of 64, chunks of 32 columns.
TILE_ROWS = 64
CHUNK_COLS = 32


def supports_kernel(kernel, d: int) -> bool:
    """True when K1/K3 take this kernel over a d-column grid: one of
    the four stationary families, reading every grid column."""
    return (type(kernel) in KINDS and kernel.input_dim == d
            and kernel.active_dims == tuple(range(d)))


def terms_of(kernel):
    """A kernel tree in sum-of-products form: a list of terms, each a
    list of leaves whose grams multiply; term grams add."""
    if isinstance(kernel, Sum):
        return terms_of(kernel.k1) + terms_of(kernel.k2)
    if isinstance(kernel, Product):
        return [a + b for a in terms_of(kernel.k1)
                for b in terms_of(kernel.k2)]
    return [[kernel]]


def supports_plan(kernel, d: int) -> bool:
    """True when K2/K4 take this kernel over a d-column grid: a
    Sum/Product algebra whose leaves are RBF, Matern32, Matern52,
    Exponential, Cosine or Bias, each reading grid columns only."""
    return all(type(p) in LEAF_KINDS and max(p.active_dims) < d
               for term in terms_of(kernel) for p in term)


def kind_of(kernels) -> int:
    """Kind code shared by ``kernels`` (one family only)."""
    kinds = {KINDS.get(type(k)) for k in kernels}
    if len(kinds) != 1 or None in kinds:
        raise ValueError(f"one stationary family per launch, got {kernels}")
    return kinds.pop()


def kfun(kind: int, r2: torch.Tensor, variance) -> torch.Tensor:
    """Leaf value of a distance-based kind from the scaled squared
    distance, the expressions of the JAX package's kernel bodies."""
    if kind == KINDS[RBF]:
        return variance * torch.exp(-0.5 * r2)
    r = torch.sqrt(r2 + 1e-36)
    if kind == LEAF_KINDS[Cosine]:
        return variance * torch.cos(r)
    if kind == KINDS[Exponential]:
        return variance * torch.exp(-r)
    if kind == KINDS[Matern52]:
        s5r = math.sqrt(5.0) * r
        return variance * (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)
    s3r = math.sqrt(3.0) * r
    return variance * (1.0 + s3r) * torch.exp(-s3r)


def plan_gram(a: torch.Tensor, b_t: torch.Tensor, scales, pvar, kinds,
              terms) -> torch.Tensor:
    """(rows, B) gram of a plan (``_part_gram`` of the JAX package):
    ``a`` (rows, d) and ``b_t`` (d, B) are raw inputs; leaf q scales
    the differences by ``scales[q]`` (nested lists), leaves multiply
    within a term and terms add. A zero scale adds exactly 0 to a
    leaf's distance, so its column is skipped; a unit scale is exact,
    so its multiply is skipped."""
    out = prod = None
    for q, kind in enumerate(kinds):
        if kind == BIAS:
            kp = pvar[q] * a.new_ones((a.shape[0], b_t.shape[1]))
        else:
            r2 = torch.zeros((a.shape[0], b_t.shape[1]), dtype=a.dtype,
                             device=a.device)
            for k, scale in enumerate(scales[q]):
                if scale == 0.0:
                    continue
                diff = a[:, k, None] - b_t[k, None, :]
                if scale != 1.0:
                    diff = diff * scale
                r2 = r2 + diff * diff
            kp = kfun(kind, r2, pvar[q])
        prod = kp if q == 0 or terms[q] != terms[q - 1] else prod * kp
        if q == len(kinds) - 1 or terms[q + 1] != terms[q]:
            out = prod if out is None else out + prod
    return out


def gram(kind: int, a: torch.Tensor, b_t: torch.Tensor,
         variance: torch.Tensor) -> torch.Tensor:
    """(rows, B) gram of one stationary family (K1/K3): a one-leaf plan
    with unit scales, since ``a`` (rows, d) and ``b_t`` (d, B) are both
    already divided by the lengthscale."""
    return plan_gram(a, b_t, [[1.0] * a.shape[1]], [variance], [kind], [0])


def round_limb(x: torch.Tensor, limb: str) -> torch.Tensor:
    """float32 ``x`` rounded to the limb format, as float32: bf16 to
    nearest even, tf32 (10 stored mantissa bits) to nearest with ties away
    from zero; infinities and NaN pass through."""
    if x.dtype != torch.float32:
        raise TypeError(f"limbs are cut from float32, not {x.dtype}")
    if limb == "bf16":
        return x.to(torch.bfloat16).float()
    if limb != "tf32":
        raise ValueError(f"unknown limb format {limb!r}")
    bits = x.view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    rounded = (bits + 0x1000) & -0x2000      # add half an ulp, cut 13 bits
    return torch.where(special, bits, rounded).view(torch.float32)


def split_limbs(x: torch.Tensor, limb: str, round_lo: bool = True):
    """``(hi, lo)`` in ``x``'s dtype: ``hi = round(x)`` (through float32
    for a float64 ``x``), ``lo = x - hi``, rounded to the limb format
    too when ``round_lo``."""
    hi = round_limb(x.float(), limb).to(x.dtype)
    lo = x - hi
    if round_lo:
        lo = round_limb(lo.float(), limb).to(x.dtype)
    return hi, lo


def kernel_gram(kind, a, b_t, variance):
    """(rows, B) gram of one stationary family; in float32 bit for bit as
    the CUDA kernels compute an RBF gram (each column's square added to
    the distance with one rounding, a fused multiply-add), in float64 as
    ``gram``."""
    if a.dtype != torch.float32:
        return gram(kind, a, b_t, variance)
    r2 = a.new_zeros((a.shape[0], b_t.shape[1]))
    for k in range(a.shape[1]):
        diff = a[:, k, None] - b_t[k, None, :]
        r2 = _fma32(diff, diff, r2.double())
    return _kfun32(kind, r2, variance)


def _fma32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the kernels' fused
    multiply-add: the product of two float32 values is exact in float64
    (and the sum rounded twice, to float64 and to float32, differs from
    one rounding only where the first lands on a float32 tie)."""
    return (a.double() * b.double() + c).float()


def _kfun32(kind: int, r2: torch.Tensor, variance) -> torch.Tensor:
    """float32 leaf value from ``r2`` as the kernels' ``kfun`` computes
    it: the JAX package's expressions with the Matern-5/2 polynomial's
    ``(5/3) r2`` added by a fused multiply-add, as nvcc contracts it."""
    if kind != LEAF_KINDS[Matern52]:
        return kfun(kind, r2, variance)
    r = torch.sqrt(r2 + 1e-36)
    s5r = math.sqrt(5.0) * r
    poly = _fma32(r2, torch.tensor(5.0 / 3.0, dtype=torch.float32),
                  (1.0 + s5r).double())
    return variance * poly * torch.exp(-s5r)


def kernel_plan_gram(a: torch.Tensor, b_t: torch.Tensor, scales, pvar, kinds,
                     terms) -> torch.Tensor:
    """(rows, B) gram of a plan; in float32 bit for bit as K2 computes it
    (each leaf's scaled difference rounded, its square added to the
    distance by a fused multiply-add; RBF, Exponential, Cosine and Bias
    leaves; the Matern polynomials as ``_kfun32`` assumes nvcc contracts
    them), in float64 as ``plan_gram``. Arguments as ``plan_gram``."""
    if a.dtype != torch.float32:
        return plan_gram(a, b_t, scales, pvar, kinds, terms)
    out = prod = None
    for q, kind in enumerate(kinds):
        if kind == BIAS:
            kp = pvar[q] * a.new_ones((a.shape[0], b_t.shape[1]))
        else:
            r2 = a.new_zeros((a.shape[0], b_t.shape[1]))
            for k, scale in enumerate(scales[q]):
                if scale == 0.0:
                    continue
                diff = (a[:, k, None] - b_t[k, None, :]) * scale
                r2 = _fma32(diff, diff, r2.double())
            kp = _kfun32(kind, r2, pvar[q])
        prod = kp if q == 0 or terms[q] != terms[q - 1] else prod * kp
        if q == len(kinds) - 1 or terms[q + 1] != terms[q]:
            out = prod if out is None else out + prod
    return out


def on_device(kernels, like: torch.Tensor) -> bool:
    """True when every hyperparameter of ``kernels`` lies on the device of
    ``like``: the operands are then built from them by tensor operations
    on that device, with no host read (the traced step, a kernel shipped
    to the card); else from their host values, uploaded once."""
    return all(t.device == like.device for k in kernels
               for t in kernel_leaves(k))


def scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``value`` (a float or a tensor) in the dtype and on
    the device of ``like``, made there (no upload)."""
    if torch.is_tensor(value):
        return value.to(like.dtype).reshape(())
    return like.new_full((), float(value))


def part_plan(kernel, d: int, like: torch.Tensor):
    """K2/K4's plan of ``kernel`` over a d-column grid, in the dtype and
    on the device of ``like``: ``(scales, pvar, plan, kdiag)`` with
    ``scales`` (P, d) 1/lengthscale on each leaf's active columns and 0
    elsewhere, ``pvar`` (P,) the leaf variances, ``plan`` (2, P) int32
    rows of leaf kind codes and term indices, and ``kdiag`` the prior
    variance, the sum over terms of the product of their leaf variances:
    a float, or (``on_device``) a 0-d tensor in the leaves' dtype, summed
    in the same order. Any number of leaves."""
    terms = terms_of(kernel)
    leaves = [p for term in terms for p in term]
    kinds = [LEAF_KINDS[type(p)] for p in leaves]
    term_idx = [t for t, term in enumerate(terms) for _ in term]
    plan = torch.tensor([kinds, term_idx], dtype=torch.int32,
                        device=like.device)
    if on_device([kernel], like):
        zero, rows, kdiag = like.new_zeros(()), [], None
        for p in leaves:
            if isinstance(p, Bias):
                rows.append(like.new_zeros((d,)))
                continue
            # the reciprocal in the leaves' float64, then rounded, as the
            # host route computes it
            inv = (1.0 / torch.broadcast_to(p.lengthscale, (p.input_dim,))
                   ).to(like.dtype)
            col = {c: j for j, c in enumerate(p.active_dims)}
            rows.append(torch.stack([inv[col[c]] if c in col else zero
                                     for c in range(d)]))
        for term in terms:
            prod = term[0].variance
            for p in term[1:]:
                prod = prod * p.variance
            kdiag = prod if kdiag is None else kdiag + prod
        return (torch.stack(rows),
                torch.stack([p.variance.to(like.dtype) for p in leaves]),
                plan, kdiag)
    scales = np.zeros((len(leaves), d))
    for q, p in enumerate(leaves):
        if not isinstance(p, Bias):      # constant: distances don't enter
            ls = np.broadcast_to(p.lengthscale.numpy(), (p.input_dim,))
            scales[q, list(p.active_dims)] = 1.0 / ls
    kdiag = sum(math.prod(float(p.variance) for p in term)
                for term in terms)
    to = dict(dtype=like.dtype, device=like.device)
    return (torch.tensor(scales, **to),
            torch.tensor([float(p.variance) for p in leaves], **to),
            plan, kdiag)


def lengthscales(kernels, d: int, like: torch.Tensor) -> torch.Tensor:
    """(G, d) lengthscales in the dtype and on the device of ``like``."""
    if on_device(kernels, like):
        return torch.stack([torch.broadcast_to(k.lengthscale.to(like.dtype),
                                               (d,)) for k in kernels])
    ls = np.stack([np.broadcast_to(k.lengthscale.numpy(), (d,))
                   for k in kernels])
    return torch.tensor(ls, dtype=like.dtype, device=like.device)


def scalar_rows(kernels, like: torch.Tensor, beta, fill) -> torch.Tensor:
    """(G, 4) rows ``[variance, variance, beta, 0]`` of K1's and K3's
    ``scal``, column ``c`` replaced by ``fill[c]`` (a (G,) tensor on the
    device: the counts, the thresholds), in the dtype and on the device of
    ``like``."""
    if on_device(kernels, like):
        var = torch.stack([k.variance.to(like.dtype) for k in kernels])
        cols = [var, var, scalar(beta, like).expand(len(kernels)),
                like.new_zeros(len(kernels))]
        for c, col in fill.items():
            cols[c] = col.to(like.dtype)
        return torch.stack(cols, dim=1)
    scal = torch.tensor([[float(k.variance), float(k.variance),
                          float(beta), 0.0] for k in kernels],
                        dtype=like.dtype, device=like.device)
    for c, col in fill.items():
        scal[:, c] = col
    return scal


def interval_operands(kernels, states, grid: torch.Tensor, beta):
    """K1's operands ``(zt, ils, xs, lm, w, scal, kind)`` for GPs of one
    family and one capacity over ``grid`` (N, d). ``scal[:, 3]`` holds
    each GP's count, copied on the device (no host sync)."""
    n, d = grid.shape
    kind = kind_of(kernels)
    ls = lengthscales(kernels, d, grid)
    scal = scalar_rows(kernels, grid, beta,
                       {3: torch.stack([st.count for st in states])})
    xs = torch.stack([st.X for st in states]) / ls[:, None, :]
    lm = torch.stack([st.Linv * row_mask(st)[None, :] for st in states])
    w = torch.stack([st.w for st in states])
    return (grid.T.contiguous(), (1.0 / ls).contiguous(), xs.contiguous(),
            lm.contiguous(), w.contiguous(), scal, kind)


def fleet_interval_operands(kernels, states, grid: torch.Tensor, beta):
    """K1's operands for the same g GPs in each of K campaigns: ``states``
    holds each GP's fields with a leading campaign axis K, and GP j of
    campaign k is the launch's GP ``k g + j``. Every operand of a GP is
    ``interval_operands``'s, built with one stack per field."""
    n, d = grid.shape
    K, g = states[0].X.shape[0], len(kernels)
    cap = states[0].X.shape[1]
    kind = kind_of(kernels)
    ls = lengthscales(kernels, d, grid)                     # (g, d)
    scal = torch.tensor([[float(k.variance), float(k.variance),
                          float(beta), 0.0] for k in kernels] * K,
                        dtype=grid.dtype, device=grid.device)
    counts = torch.stack([st.count for st in states], dim=1)  # (K, g)
    scal[:, 3] = counts.reshape(-1)
    mask = (torch.arange(cap, device=grid.device)
            < counts[..., None]).to(grid.dtype)              # (K, g, cap)
    xs = torch.stack([st.X for st in states], dim=1) / ls[None, :, None, :]
    lm = torch.stack([st.Linv for st in states], dim=1) * mask[:, :, None, :]
    w = torch.stack([st.w for st in states], dim=1)
    return (grid.T.contiguous(), (1.0 / ls).repeat(K, 1),
            xs.reshape(K * g, cap, d), lm.reshape(K * g, cap, cap),
            w.reshape(K * g, cap), scal, kind)


def interval_rows(gram_at, lm, w, kdiag, beta, N: int) -> torch.Tensor:
    """(2, N) rows ``mu -+ beta sigma`` of one GP in plain PyTorch;
    ``gram_at(s, e)`` is its (cap, e - s) gram against grid columns
    s:e."""
    out = lm.new_empty((2, N))
    for s in range(0, N, PLAIN_COLS):
        e = min(s + PLAIN_COLS, N)
        V = lm @ gram_at(s, e)
        mu = torch.sum(w[:, None] * V, dim=0)
        var = torch.clamp(kdiag - torch.sum(V * V, dim=0), min=0.0)
        spread = beta * torch.sqrt(var)
        out[0, s:e] = mu - spread
        out[1, s:e] = mu + spread
    return out


def fused_intervals_plain(zt, ils, xs, lm, w, scal, kind):
    """Plain PyTorch version of K1: same operands, same function."""
    return torch.stack([
        interval_rows(lambda s, e, g=g: gram(kind, xs[g],
                                             zt[:, s:e] * ils[g][:, None],
                                             scal[g, 0]),
                      lm[g], w[g], scal[g, 1], scal[g, 2], zt.shape[1])
        for g in range(xs.shape[0])])


def three_pass_rows(gram_at, lm, w, kdiag, beta, N: int,
                    u=None) -> torch.Tensor:
    """(2, N) rows ``mu -+ beta sigma`` of one GP with the three-pass
    product ``V = Lm_hi k_hi + Lm_hi k_lo + Lm_lo k_hi`` over bf16 limbs,
    in ``lm``'s dtype: from float32 operands ``lo`` is rounded to bf16, as
    a tensor core reads it, and the products and the epilogue run in
    float64; from float64 operands ``lo`` stays unrounded. ``gram_at(s,
    e)`` is the (cap, e - s) gram against grid columns s:e. With ``u``
    (cap,), mu is ``u . k`` from the gram itself, not ``w . V``."""
    round_lo = lm.dtype == torch.float32
    hi, lo = (t.double() for t in split_limbs(lm, "bf16", round_lo))
    w64 = w.double()
    out = torch.empty((2, N), dtype=torch.float64, device=lm.device)
    for s in range(0, N, PLAIN_COLS):
        e = min(s + PLAIN_COLS, N)
        k = gram_at(s, e)
        k_hi, k_lo = (t.double() for t in split_limbs(k, "bf16", round_lo))
        V = hi @ k_hi + hi @ k_lo + lo @ k_hi
        mu = (torch.sum(w64[:, None] * V, dim=0) if u is None
              else u.double() @ k.double())
        var = torch.clamp(float(kdiag) - torch.sum(V * V, dim=0), min=0.0)
        spread = float(beta) * torch.sqrt(var)
        out[0, s:e] = mu - spread
        out[1, s:e] = mu + spread
    return out.to(lm.dtype)


def fused_intervals3_plain(zt, ils, xs, lm, w, scal, kind):
    """Plain PyTorch version of K1-3p: K1's operands, the three-pass
    product (``three_pass_rows``) on the kernel's gram (``kernel_gram``)."""
    return torch.stack([
        three_pass_rows(lambda s, e, g=g: kernel_gram(
            kind, xs[g], zt[:, s:e] * ils[g][:, None], scal[g, 0]),
            lm[g], w[g], scal[g, 1], scal[g, 2], zt.shape[1])
        for g in range(xs.shape[0])])


def check_operands(named, device, dtype, shapes) -> None:
    """Raise unless every tensor is on ``device``, of ``dtype`` (bool for
    ``unsafe``, int32 for ``plan``), contiguous and of its expected
    shape, the grid is at most ``MAX_DIM`` wide and a plan has a leaf."""
    d = shapes["zt"][0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"the CUDA kernels take 1 to {MAX_DIM} grid "
                         f"columns, got {d}")
    if "plan" in shapes and shapes["plan"][1] < 1:
        raise ValueError("a K2/K4 plan needs at least one leaf")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        want = {"unsafe": torch.bool, "plan": torch.int32}.get(name, dtype)
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[name])}")


def float_dtype(t: torch.Tensor, what: str) -> torch.dtype:
    """The dtype of ``t``, which the CUDA kernels take in float32 or
    float64 only."""
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, not {t.dtype}")
    return t.dtype


def raise_on_error(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err:
        from ._build import library
        msg = library().safeopt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """Device pointer of a tensor as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def transposed_factor(lm: torch.Tensor) -> torch.Tensor:
    """(G, cap, ldl) ``Lm^T`` as K1/K2 read it: ``lm`` (G, cap, cap)
    transposed, its rows padded with zeros to ``ldl``, the capacity
    rounded up to 32, so that every 32-row band the kernels copy is in
    bounds and 16-byte aligned."""
    G, cap, _ = lm.shape
    ldl = -(-cap // 32) * 32
    if ldl == cap:
        return lm.transpose(1, 2).contiguous()
    lmt = lm.new_zeros((G, cap, ldl))
    lmt[:, :, :cap] = lm.transpose(1, 2)
    return lmt


def factor_chunks(lm: torch.Tensor) -> torch.Tensor:
    """The float32 factor ``lm`` (G, cap, cap) as the float32 K1-3p/K2-3p
    read it: its bf16 limbs (``split_limbs``, the plain version's bits),
    zero-padded to ``cap_pad``, the capacity rounded up to ``TILE_ROWS``,
    in chunks of ``TILE_ROWS`` rows by ``CHUNK_COLS`` columns, row tile
    major: (G, cap_pad / 64, cap_pad / 32, 2, 4, 8, 8, 8), the chunk's hi
    then lo limb, each in wgmma's no-swizzle core-matrix order (column
    group of 8, row group of 8, row, column), so that one contiguous
    8 KB copy lands a chunk ready for the tensor cores."""
    G, cap, _ = lm.shape
    pad = -(-cap // TILE_ROWS) * TILE_ROWS
    if pad != cap:
        lm = torch.nn.functional.pad(lm, (0, pad - cap, 0, pad - cap))
    mt, qt = pad // TILE_ROWS, pad // CHUNK_COLS

    def chunks(limb):
        t = limb.to(torch.bfloat16).view(G, mt, 8, 8, qt, CHUNK_COLS // 8, 8)
        return t.permute(0, 1, 4, 5, 2, 3, 6)

    return torch.stack([chunks(t) for t in split_limbs(lm, "bf16")],
                       dim=3).contiguous()


def k1_layout(zt, ils, xs, lm, w, scal, kind, what):
    """``(G, N, d, cap, dtype)`` of K1's operands (``what`` names the
    kernel in errors); raises unless they lie on a CUDA device in one
    float dtype with K1's shapes and a stationary kind."""
    if zt.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not "
                         f"{zt.device}")
    G, cap, d = xs.shape
    N = zt.shape[1]
    dtype = float_dtype(zt, what)
    if kind not in KINDS.values():
        raise ValueError(f"unknown kernel kind {kind}")
    check_operands(
        dict(zt=zt, ils=ils, xs=xs, lm=lm, w=w, scal=scal), zt.device, dtype,
        dict(zt=(d, N), ils=(G, d), xs=(G, cap, d), lm=(G, cap, cap),
             w=(G, cap), scal=(G, 4)))
    return G, N, d, cap, dtype


def _launch_k1(symbol, what, zt, ils, xs, lm, w, scal, kind, chunks=False):
    """(G, 2, N) rows from the K1-layout kernel ``symbol`` (with an
    ``_f32`` / ``_f64`` suffix in the library) on CUDA operands; with
    ``chunks`` the float32 kernel takes the factor as ``factor_chunks``,
    else (and the float64 one) as ``transposed_factor``."""
    G, N, d, cap, dtype = k1_layout(zt, ils, xs, lm, w, scal, kind, what)
    lmt = (factor_chunks if chunks and dtype == torch.float32
           else transposed_factor)(lm)
    out = torch.empty((G, 2, N), dtype=dtype, device=zt.device)

    from ._build import library
    fn = getattr(library(), symbol + ("_f32" if dtype == torch.float32
                                      else "_f64"))
    with torch.cuda.device(zt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(zt), ptr(ils), ptr(xs), ptr(lmt), ptr(w), ptr(scal),
                 ptr(out), G, N, d, cap, kind, ctypes.c_void_p(stream))
    raise_on_error(err, what)
    return out


def fused_intervals(zt, ils, xs, lm, w, scal, kind):
    """(G, 2, N) interval rows: K1 on CUDA, the plain version on CPU.

    ``zt`` (d, N) grid, features first; ``ils`` (G, d) inverse
    lengthscales; ``xs`` (G, cap, d) training inputs divided by the
    lengthscale; ``lm`` (G, cap, cap) masked ``Linv``; ``w`` (G, cap)
    whitened targets; ``scal`` (G, 4) = [variance, kdiag, beta, count].
    The kernel reads rows and columns below each GP's count only: past
    it ``lm`` must be zero, as the masked factor is. Adds one to
    ``fused_intervals.launches`` per kernel launch.
    """
    if zt.device.type == "cpu":
        return fused_intervals_plain(zt, ils, xs, lm, w, scal, kind)
    out = _launch_k1("safeopt_intervals", "K1 (fused_intervals)", zt, ils,
                     xs, lm, w, scal, kind)
    fused_intervals.launches += 1
    return out


fused_intervals.launches = 0


def fused_intervals3(zt, ils, xs, lm, w, scal, kind):
    """(G, 2, N) interval rows with the three-pass product: K1-3p on CUDA,
    ``fused_intervals3_plain`` on CPU. K1's operands and contract. Adds
    one to ``fused_intervals3.launches`` per kernel launch."""
    if zt.device.type == "cpu":
        return fused_intervals3_plain(zt, ils, xs, lm, w, scal, kind)
    out = _launch_k1("safeopt_intervals3", "K1-3p (fused_intervals3)", zt,
                     ils, xs, lm, w, scal, kind, chunks=True)
    fused_intervals3.launches += 1
    return out


fused_intervals3.launches = 0


def fused_intervals_batched(kernels, states, grid: torch.Tensor, beta,
                            three_pass: bool = False, traced: bool = False):
    """(G, 2, N) interval rows of GPs of one family and capacity, one
    pass over the grid for all of them: K1, or K1-3p with
    ``three_pass``; with ``traced`` K1 through its ``torch.library``
    operator (``ops/library.py``), which a traced program holds."""
    ops = interval_operands(kernels, states, grid, beta)
    if traced:
        from .library import fused_intervals as op
        return op(*ops)
    return (fused_intervals3 if three_pass else fused_intervals)(*ops)


def interval_plan_operands(kernel, state, grid: torch.Tensor, beta):
    """K2's operands ``(zt, xs, lm, w, scales, pvar, plan, scal)`` for
    one GP over ``grid`` (N, d); ``scal`` = [0, kdiag, beta, count]."""
    scales, pvar, plan, kdiag = part_plan(kernel, grid.shape[1], grid)
    if torch.is_tensor(kdiag):
        scal = torch.stack([grid.new_zeros(()), scalar(kdiag, grid),
                            scalar(beta, grid), state.count.to(grid.dtype)])
    else:
        scal = torch.tensor([0.0, kdiag, float(beta), 0.0], dtype=grid.dtype,
                            device=grid.device)
        scal[3] = state.count
    lm = state.Linv * row_mask(state)[None, :]
    return (grid.T.contiguous(), state.X.contiguous(), lm.contiguous(),
            state.w.contiguous(), scales, pvar, plan, scal)


def fused_intervals_plan_plain(zt, xs, lm, w, scales, pvar, plan, scal):
    """Plain PyTorch version of K2: same operands, same function."""
    kinds, terms = plan.tolist()
    rows = scales.tolist()
    return interval_rows(
        lambda s, e: plan_gram(xs, zt[:, s:e], rows, pvar, kinds, terms),
        lm, w, scal[1], scal[2], zt.shape[1])


def fused_intervals_plan3_plain(zt, xs, lm, w, scales, pvar, plan, scal):
    """Plain PyTorch version of K2-3p: K2's operands, the three-pass
    product (``three_pass_rows``) on the kernel's gram
    (``kernel_plan_gram``)."""
    kinds, terms = plan.tolist()
    rows = scales.tolist()
    return three_pass_rows(
        lambda s, e: kernel_plan_gram(xs, zt[:, s:e], rows, pvar, kinds,
                                      terms),
        lm, w, scal[1], scal[2], zt.shape[1])


def _launch_k2(symbol, what, zt, xs, lm, w, scales, pvar, plan, scal,
               chunks=False):
    """(2, N) rows from the K2-layout kernel ``symbol`` (with an ``_f32``
    / ``_f64`` suffix in the library) on CUDA operands; ``chunks`` as
    ``_launch_k1``'s."""
    if zt.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not "
                         f"{zt.device}")
    cap, d = xs.shape
    N = zt.shape[1]
    P = pvar.shape[0]
    dtype = float_dtype(zt, what)
    check_operands(
        dict(zt=zt, xs=xs, lm=lm, w=w, scales=scales, pvar=pvar, plan=plan,
             scal=scal), zt.device, dtype,
        dict(zt=(d, N), xs=(cap, d), lm=(cap, cap), w=(cap,),
             scales=(P, d), pvar=(P,), plan=(2, P), scal=(4,)))
    lmt = (factor_chunks if chunks and dtype == torch.float32
           else transposed_factor)(lm[None])[0]
    out = torch.empty((2, N), dtype=dtype, device=zt.device)

    from ._build import library
    fn = getattr(library(), symbol + ("_f32" if dtype == torch.float32
                                      else "_f64"))
    with torch.cuda.device(zt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(zt), ptr(xs), ptr(lmt), ptr(w), ptr(scales), ptr(pvar),
                 ptr(plan), ptr(scal), ptr(out), N, d, cap, P,
                 ctypes.c_void_p(stream))
    raise_on_error(err, what)
    return out


def fused_intervals_plan(zt, xs, lm, w, scales, pvar, plan, scal):
    """(2, N) interval rows of one GP with a kernel plan: K2 on CUDA, the
    plain version on CPU.

    ``zt`` (d, N) raw grid, features first; ``xs`` (cap, d) raw
    training inputs; ``lm`` (cap, cap) masked ``Linv``; ``w`` (cap,)
    whitened targets; ``scales``, ``pvar``, ``plan`` from ``part_plan``;
    ``scal`` (4,) = [0, kdiag, beta, count]; as in K1, ``lm`` is zero
    past the count. Adds one to ``fused_intervals_plan.launches`` per
    kernel launch.
    """
    if zt.device.type == "cpu":
        return fused_intervals_plan_plain(zt, xs, lm, w, scales, pvar, plan,
                                          scal)
    out = _launch_k2("safeopt_intervals_plan", "K2 (fused_intervals_plan)",
                     zt, xs, lm, w, scales, pvar, plan, scal)
    fused_intervals_plan.launches += 1
    return out


fused_intervals_plan.launches = 0


def fused_intervals_plan3(zt, xs, lm, w, scales, pvar, plan, scal):
    """(2, N) interval rows of one GP with a kernel plan and the
    three-pass product: K2-3p on CUDA, ``fused_intervals_plan3_plain`` on
    CPU. K2's operands and contract. Adds one to
    ``fused_intervals_plan3.launches`` per kernel launch."""
    if zt.device.type == "cpu":
        return fused_intervals_plan3_plain(zt, xs, lm, w, scales, pvar, plan,
                                           scal)
    out = _launch_k2("safeopt_intervals_plan3",
                     "K2-3p (fused_intervals_plan3)", zt, xs, lm, w, scales,
                     pvar, plan, scal, chunks=True)
    fused_intervals_plan3.launches += 1
    return out


fused_intervals_plan3.launches = 0


def fused_intervals_single(kernel, state, grid: torch.Tensor, beta,
                           three_pass: bool = False, traced: bool = False):
    """(2, N) interval rows of one GP whose kernel K2 takes: K2, or K2-3p
    with ``three_pass``; with ``traced`` K2 through its operator."""
    ops = interval_plan_operands(kernel, state, grid, beta)
    if traced:
        from .library import fused_intervals_plan as op
        return op(*ops)
    return (fused_intervals_plan3 if three_pass
            else fused_intervals_plan)(*ops)

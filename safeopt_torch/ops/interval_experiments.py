"""B1-B5: the interval stage's experiment kernels.

The JAX package's benchmark harnesses hold five TPU kernels, each a
variant of K1 (``_interval_kernel_multi``) that asks what K1's time is
made of or what precision a cheaper product gives. Here they are CUDA
kernels for the H100 (``csrc/interval_experiments.cu``) beside their plain
PyTorch versions. No SafeOpt path calls them: they are driven by
``tools_torch/bench_interval_experiments.py``,
``tools_torch/probe_interval_precision.py`` and ``chip_smoke.py``.

- B1 ``intervals_launch`` (``benchmarks/bench_interval_mosaic.py``
  ``_variant_impl``): K1 at the caller's slices per block, resident gram
  rows and shared-memory carveout; bit-identical to K1 at every layout.
- B2, B5 ``interval_ablation`` (``bench_interval_mosaic3.py``
  ``kern_gram_only`` / ``kern_solve_only``, ``bench_interval_ablation.py``
  ``_kernel``): ``gram_sums`` (the gram's column sums of k and k^2 over
  the active rows), ``solve_rank1`` (K1's product and epilogue on the
  rank-1 gram ``xs[:, 0] z[0]`` of raw points), ``no_product`` (V := k)
  and ``epilogue`` (V := 0.01 z[0], raw). Like K1 they run over each GP's
  active rows (its count, ``scal[:, 3]``); the TPU kernels ran over the
  capacity. ``gram_sums``, ``no_product`` and ``epilogue`` run one
  gram-only body (``csrc/gram_rows.cuh``: rows staged in shared memory,
  several points a thread), whose float32 rows are bit for bit the
  in-order sums of ``ablation_in_order``.
- B3 ``intervals_mu_from_gram`` (``bench_interval_mosaic4.py``
  ``kern_mxu_emit``): K1 with ``mu = sum_c u[c] k[c]``, ``u = Lm^T w``
  computed here in float64 once per call.
- B1-3p, B2-3p, B3-3p: ``three_pass=True`` of ``intervals_launch``,
  ``interval_ablation(mode="solve_rank1")`` and
  ``intervals_mu_from_gram``, the harnesses' ``3pass`` columns: the same
  functions with K1-3p's product ``V = Lm_hi k_hi + Lm_hi k_lo + Lm_lo
  k_hi`` over bf16 limbs (``fused_intervals3``). In float32 all three run
  K1-3p's ``wgmma`` bodies (``csrc/interval_experiments3.cu``; resident
  up to capacity ``RESIDENT3_CAP``, tiled past it, by
  ``three_pass_body``) on the factor's limb chunks (``factor_chunks``):
  B1-3p at the caller's layout, with K1-3p's bits at every layout that
  keeps its summation order; B2-3p on the rank-1 gram; B3-3p with mu
  ``u . k`` added from the float32 gram entries before their limb cut,
  each entry once, in a fixed order. In float64 they run
  ``ThreePassProduct``'s body (FP64 FMAs of the limbs), a check of the
  gram policies and the limb cut, not a route. Their plain versions are
  ``three_pass_rows`` on the kernel's gram (``kernel_gram``; the rank-1
  gram of B2 is one float32 multiply an entry), B3-3p's with mu ``u .
  k``. The other ablation modes have no product and refuse
  ``three_pass``.
- B4 ``intervals_split`` (``bench_interval_variants.py`` ``_kernel``, the
  TPU's 3-pass ``_dot3``): one GP's intervals with ``V = Lm_hi k_hi +
  Lm_hi k_lo + Lm_lo k_hi`` on K1-3p's ``wgmma`` bodies in ``bf16`` or
  ``tf32`` limbs, Lm cut in the kernel from float32 chunks
  (``factor_landing``) or passed as its limbs' chunks (``split_factor``,
  the harness's ``hoisted``), float32 only.

CUDA tensors launch the kernels, CPU tensors run the plain versions;
nothing else chooses. Each wrapper adds one to its ``launches`` per
launch of its FP32-product kernel (``interval_ablation`` also to
``mode_launches[mode]``, ``intervals_split`` to ``limb_launches[limb]``)
and to its ``three_pass_launches`` per launch of its three-pass kernel.

Limbs (``split_limbs``): ``hi = round(x)`` to the limb format and ``lo =
x - hi``, rounded again as a tensor core operand is (``round_lo``).
bf16 rounds to nearest even; tf32 to nearest, ties away from zero (the
kernel's ``cvt.rna``), on the float32 bits. A float64 input is rounded
through float32, as JAX's ``astype(bfloat16)`` does. The JAX package's
CPU reference of the 3-pass product does not round ``lo`` (a DEFAULT dot
on the CPU is exact), the tensor core does; ``round_lo`` switches.

``float32_bound`` states how far a float32 kernel may be from its plain
version on the same operands (see its docstring); ``drop_band`` plants
a fault to hold the bound against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..gp.kernels import RBF
from .fused_posterior import (KINDS, PLAIN_COLS, RESIDENT3_CAP, TILE_ROWS,
                              check_operands, factor_chunks,
                              fused_intervals3_plain, fused_intervals_plain,
                              gram, interval_rows, k1_layout, kernel_gram,
                              kernel_plan_gram, plan_gram, ptr,
                              _fma32, raise_on_error, round_limb,
                              split_limbs,
                              three_pass_body, three_pass_rows,
                              transposed_factor)

__all__ = ["ABLATIONS", "LIMBS", "intervals_launch", "interval_ablation",
           "interval_ablation_plain", "ablation_in_order", "mu_weights", "intervals_mu_from_gram",
           "intervals_mu_from_gram_plain", "round_limb", "split_limbs",
           "kernel_gram", "padded_factor", "split_factor", "factor_landing",
           "intervals_split", "intervals_split_plain", "float32_bound",
           "float32_bound_plan", "plan_rows_on_kernel_gram", "drop_band"]

ABLATIONS = {"gram_sums": 0, "solve_rank1": 1, "no_product": 2,
             "epilogue": 3}
LIMBS = ("bf16", "tf32")
U32 = 2.0 ** -24         # unit roundoff of float32
# B4's contraction step per limb format: wgmma k16 (bf16), k8 (tf32)
MMA_K = {"bf16": 16, "tf32": 8}
# B4's factor chunks per limb format (csrc/intervals3.cuh Limbs3): columns
# of a chunk, and values of a limb in a 16-byte core-matrix row
CHUNK_COLS = {"bf16": 32, "tf32": 16}
CORE_K = {"bf16": 8, "tf32": 4}
# the float32 B1-3p's launch knobs (csrc/interval_experiments3.cu):
# consumer warpgroups of the resident body, ring stages; 0 is K1-3p's
B1_3P_GROUPS = (0, 1, 3)
B1_3P_STAGES = (0, 2, 3, 4)


def _library():
    from ._build import library
    return library()


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    with torch.cuda.device(t.device):
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _counts(scal, cap):
    """Each GP's active rows, as the kernels read them from ``scal``."""
    return [min(max(int(c), 0), cap) for c in scal[:, 3].tolist()]


def _epilogue(V, w, kdiag, beta):
    """(2, B) rows ``mu -+ beta sigma`` from V (rows, B): K1's epilogue."""
    mu = torch.sum(w[:, None] * V, dim=0)
    var = torch.clamp(kdiag - torch.sum(V * V, dim=0), min=0.0)
    spread = beta * torch.sqrt(var)
    return torch.stack([mu - spread, mu + spread])


# -- B1 -----------------------------------------------------------------------

def _check_launch(dtype, cap, slices, res, carveout, three_pass, groups,
                  stages):
    """Raise unless (slices, res, carveout, groups, stages) is a layout
    that ``intervals_launch`` takes for ``dtype`` at capacity ``cap``."""
    if not (carveout == -1 or 0 <= carveout <= 100):
        raise ValueError(f"carveout is -1 or a percentage, got {carveout}")
    if not (three_pass and dtype == torch.float32):
        if slices not in (0, 1, 2, 4, 8) or res < 0 or res % 16:
            raise ValueError(f"B1 takes slices in (0, 1, 2, 4, 8) and res "
                             f"a multiple of 16, got {slices}, {res}")
        if groups or stages:
            raise ValueError("groups and stages are the float32 B1-3p's "
                             f"knobs, got {groups}, {stages}")
        return
    if slices:
        raise ValueError("the float32 B1-3p takes groups and stages (its "
                         f"wgmma items are 64 points), not slices={slices}")
    if groups not in B1_3P_GROUPS or stages not in B1_3P_STAGES:
        raise ValueError(f"the float32 B1-3p takes groups in {B1_3P_GROUPS} "
                         f"and stages in {B1_3P_STAGES}, got {groups}, "
                         f"{stages}")
    _check_res3(cap, res, "B1-3p")
    if three_pass_body(cap) == "tiled" and groups:
        raise ValueError(f"past capacity {RESIDENT3_CAP} the float32 B1-3p "
                         "runs the tiled body: no groups")


def _check_res3(cap, res, what):
    """Raise unless ``res`` is resident gram rows that the float32
    ``what`` takes on K1-3p's wgmma bodies at capacity ``cap``: a multiple
    of 32 up to the capacity rounded up to 64, and none on the tiled
    body."""
    pad = -(-cap // TILE_ROWS) * TILE_ROWS
    if res < 0 or res % CHUNK_COLS["bf16"] or res > pad:
        raise ValueError(f"the float32 {what} takes res a multiple of "
                         f"{CHUNK_COLS['bf16']} up to {pad}, got {res}")
    if res and three_pass_body(cap) == "tiled":
        raise ValueError(f"past capacity {RESIDENT3_CAP} the float32 {what} "
                         "runs the tiled body: no resident rows")


def intervals_launch(zt, ils, xs, lm, w, scal, kind, slices=0, res=0,
                     carveout=-1, three_pass=False, groups=0, stages=0):
    """(G, 2, N) interval rows, K1's operands and function, at a launch
    layout: B1 or B1-3p on CUDA, K1's or K1-3p's plain version on CPU
    (``fused_intervals_plain``, ``fused_intervals3_plain``). A layout
    whose shared memory does not fit the card raises.

    - B1 and the float64 B1-3p (``three_pass``; the float64 K1-3p's
      ``ThreePassProduct`` body): ``slices`` slices of 32 points per
      block, a power of two up to 8 or 0 for K1's own layout, and ``res``
      resident gram rows, a multiple of 16 (read only with ``slices``).
      Every layout gives K1's (K1-3p's) bits.
    - The float32 B1-3p: K1-3p's ``wgmma`` bodies (64-point items, so no
      ``slices``) with ``groups`` consumer warpgroups a block (1 or 3),
      ``stages`` factor chunks in flight per warpgroup (2 to 4) and
      ``res`` resident gram rows (a multiple of 32 up to the capacity
      rounded up to 64); 0 for each is K1-3p's own choice. Past capacity
      ``RESIDENT3_CAP`` it runs the tiled body, which takes ``stages``
      alone. ``stages``, ``res`` and the carveout keep K1-3p's summation
      order and its bits; ``groups`` decides which warp adds which row
      tile, so another count than K1-3p's (1 up to capacity 128, 3 past
      it) changes the order, and the rows are held by
      ``float32_bound(..., "split", limb="bf16")`` against
      ``fused_intervals3_plain``.

    ``carveout``: the shared-memory carveout in percent, -1 for the
    kernel's default."""
    _check_launch(zt.dtype, xs.shape[-2], slices, res, carveout, three_pass,
                  groups, stages)
    what = "B1-3p" if three_pass else "B1"
    if zt.device.type == "cpu":
        plain = fused_intervals3_plain if three_pass else fused_intervals_plain
        return plain(zt, ils, xs, lm, w, scal, kind)
    G, N, d, cap, dtype = k1_layout(zt, ils, xs, lm, w, scal, kind, what)
    out = torch.empty((G, 2, N), dtype=dtype, device=zt.device)
    lib = _library()
    if three_pass and dtype == torch.float32:
        err = lib.safeopt_intervals3_launch_f32(
            ptr(zt), ptr(ils), ptr(xs), ptr(factor_chunks(lm)), ptr(w),
            ptr(scal), ptr(out), G, N, d, cap, kind, groups, stages, res,
            carveout, _stream(zt))
        layout = f"groups={groups} stages={stages}"
    else:
        fn = (lib.safeopt_intervals_launch_f32 if dtype == torch.float32
              else lib.safeopt_intervals_launch_f64)
        err = fn(ptr(zt), ptr(ils), ptr(xs), ptr(transposed_factor(lm)),
                 ptr(w), ptr(scal), ptr(out), G, N, d, cap, kind, slices,
                 res, carveout, int(three_pass), _stream(zt))
        layout = f"slices={slices}"
    raise_on_error(err, f"{what} (intervals_launch {layout} res={res} "
                        f"carveout={carveout})")
    if three_pass:
        intervals_launch.three_pass_launches += 1
    else:
        intervals_launch.launches += 1
    return out


intervals_launch.launches = 0
intervals_launch.three_pass_launches = 0


# -- B2 / B5 ------------------------------------------------------------------

def _check_ablation(mode, three_pass):
    if mode not in ABLATIONS:
        raise ValueError(f"unknown ablation {mode!r}")
    if three_pass and mode != "solve_rank1":
        raise ValueError(f"the ablation {mode!r} has no product, so no "
                         "three-pass form (only 'solve_rank1' has one)")


def interval_ablation_plain(zt, ils, xs, lm, w, scal, kind, mode,
                            three_pass=False):
    """Plain PyTorch version of ``interval_ablation``."""
    _check_ablation(mode, three_pass)
    G, cap, _ = xs.shape
    N = zt.shape[1]
    if mode == "solve_rank1":      # K1's function on the rank-1 gram
        rows = three_pass_rows if three_pass else interval_rows
        return torch.stack([
            rows(lambda s, e, g=g: xs[g, :, 0, None] * zt[0, s:e],
                 lm[g], w[g], scal[g, 1], scal[g, 2], N)
            for g in range(G)])
    out = zt.new_empty((G, 2, N))
    for g, n in enumerate(_counts(scal, cap)):
        for s in range(0, N, PLAIN_COLS):
            e = min(s + PLAIN_COLS, N)
            if mode == "epilogue":
                V = (0.01 * zt[0, s:e]).expand(n, e - s)
            else:
                V = gram(kind, xs[g, :n], zt[:, s:e] * ils[g][:, None],
                         scal[g, 0])
            if mode == "gram_sums":
                out[g, 0, s:e] = V.sum(dim=0)
                out[g, 1, s:e] = (V * V).sum(dim=0)
            else:
                out[g, :, s:e] = _epilogue(V, w[g, :n], scal[g, 1],
                                           scal[g, 2])
    return out


def interval_ablation(zt, ils, xs, lm, w, scal, kind, mode,
                      three_pass=False):
    """(G, 2, N) rows of the ablation ``mode`` on K1's operands: B2/B5 on
    CUDA, the plain version on CPU. ``gram_sums``: sums of k and k^2 over
    each GP's active rows; ``solve_rank1``: K1's function on the gram
    ``xs[:, 0] z[0]``; ``no_product``: K1's epilogue on V := k;
    ``epilogue``: K1's epilogue on V := 0.01 z[0] (raw grid column 0).
    ``three_pass``: ``solve_rank1`` with K1-3p's product (B2-3p); the
    other modes raise."""
    _check_ablation(mode, three_pass)
    if zt.device.type == "cpu":
        return interval_ablation_plain(zt, ils, xs, lm, w, scal, kind, mode,
                                       three_pass)
    G, N, d, cap, dtype = k1_layout(zt, ils, xs, lm, w, scal, kind,
                                     "B2/B5")
    out = torch.empty((G, 2, N), dtype=dtype, device=zt.device)
    lib = _library()
    if three_pass and dtype == torch.float32:     # K1-3p's wgmma bodies
        err = lib.safeopt_rank1_solve3_f32(
            ptr(zt), ptr(xs), ptr(factor_chunks(lm)), ptr(w), ptr(scal),
            ptr(out), G, N, d, cap, _stream(zt))
    else:
        lmt = transposed_factor(lm) if mode == "solve_rank1" else lm
        fn = (lib.safeopt_interval_ablation_f32 if dtype == torch.float32
              else lib.safeopt_interval_ablation_f64)
        err = fn(ptr(zt), ptr(ils), ptr(xs), ptr(lmt), ptr(w), ptr(scal),
                 ptr(out), G, N, d, cap, kind, ABLATIONS[mode],
                 int(three_pass), _stream(zt))
    raise_on_error(err, f"{'B2-3p' if three_pass else 'B2/B5'} "
                        f"(interval_ablation {mode})")
    if three_pass:
        interval_ablation.three_pass_launches += 1
    else:
        interval_ablation.launches += 1
        interval_ablation.mode_launches[mode] += 1
    return out


interval_ablation.launches = 0
interval_ablation.mode_launches = dict.fromkeys(ABLATIONS, 0)
interval_ablation.three_pass_launches = 0


def ablation_in_order(zt, ils, xs, lm, w, scal, kind, mode):
    """float32 (G, 2, N) rows of the ablation ``mode`` (``gram_sums``,
    ``no_product`` or ``epilogue``) summed as B2/B5's kernel sums them,
    for a bitwise check of the kernel on the same float32 operands: per
    grid point the GP's active rows in ascending order, one accumulator a
    sum, each V[c] ``kernel_gram``'s entry (or 0.01 z[0]); ``s1 += V``
    (``gram_sums``) or ``s1 = fma(w[c], V, s1)``, and ``s2 = fma(V, V,
    s2)``, every fused multiply-add rounded once (``_fma32``); then K1's
    epilogue, ``mu -+ beta sqrt(max(kdiag - s2, 0))`` with beta's product
    fused into the sum. Under ``epilogue`` V is the same every row, and
    nvcc computes its square once: ``s2 += V^2`` rounds twice. Those are
    the contractions the card showed (a beta that is no power of two
    tells them apart). ``kernel_gram`` is the kernel's gram for RBF and
    the exponential (Matern entries differ in the last bits). At most 64
    rows of the gram at a time."""
    if zt.dtype != torch.float32:
        raise TypeError(f"the in-order sums are float32's, not {zt.dtype}")
    if mode not in ("gram_sums", "no_product", "epilogue"):
        raise ValueError(f"the ablation {mode!r} is not a sum over the "
                         "gram's rows")
    G, cap, _ = xs.shape
    N = zt.shape[1]
    out = zt.new_empty((G, 2, N))
    v0 = 0.01 * zt[0]
    for g, n in enumerate(_counts(scal, cap)):
        s1, s2 = zt.new_zeros(N), zt.new_zeros(N)
        zg = zt * ils[g][:, None]
        for r0 in range(0, n, 64):
            r1 = min(r0 + 64, n)
            if mode == "epilogue":
                k, vv = v0.expand(r1 - r0, N), v0 * v0
            else:
                k = kernel_gram(kind, xs[g, r0:r1], zg, scal[g, 0])
            for r in range(r1 - r0):
                s1 = (s1 + k[r] if mode == "gram_sums"
                      else _fma32(w[g, r0 + r], k[r], s1))
                s2 = s2 + vv if mode == "epilogue" else _fma32(k[r], k[r], s2)
        if mode == "gram_sums":
            out[g, 0], out[g, 1] = s1, s2
            continue
        # float32's square root, correctly rounded as the card's sqrtf:
        # one rounding of float64's, which holds it exactly
        sigma = torch.sqrt(torch.clamp(scal[g, 1] - s2, min=0.0).double()
                           ).float()
        out[g, 0] = _fma32(-scal[g, 2], sigma, s1)
        out[g, 1] = _fma32(scal[g, 2], sigma, s1)
    return out


# -- B3 -----------------------------------------------------------------------

def mu_weights(lm, w):
    """(G, cap) ``u = Lm^T w`` in float64, returned in ``lm``'s dtype:
    ``mu = u . k`` is ``w . (Lm k)``."""
    return torch.einsum("grc,gr->gc", lm.double(), w.double()).to(lm.dtype)


def intervals_mu_from_gram_plain(zt, ils, xs, lm, w, scal, kind,
                                 three_pass=False):
    """Plain PyTorch version of ``intervals_mu_from_gram``; with
    ``three_pass`` V through ``three_pass_rows`` on the kernel's gram and
    mu ``u . k`` in float64."""
    u = mu_weights(lm, w)
    G, N = xs.shape[0], zt.shape[1]
    if three_pass:
        return torch.stack([
            three_pass_rows(lambda s, e, g=g: kernel_gram(
                kind, xs[g], zt[:, s:e] * ils[g][:, None], scal[g, 0]),
                lm[g], w[g], scal[g, 1], scal[g, 2], N, u=u[g])
            for g in range(G)])
    out = zt.new_empty((G, 2, N))
    for g in range(G):
        for s in range(0, N, PLAIN_COLS):
            e = min(s + PLAIN_COLS, N)
            k = gram(kind, xs[g], zt[:, s:e] * ils[g][:, None], scal[g, 0])
            V = lm[g] @ k
            mu = u[g] @ k
            var = torch.clamp(scal[g, 1] - torch.sum(V * V, dim=0), min=0.0)
            spread = scal[g, 2] * torch.sqrt(var)
            out[g, 0, s:e] = mu - spread
            out[g, 1, s:e] = mu + spread
    return out


def intervals_mu_from_gram(zt, ils, xs, lm, w, scal, kind,
                           three_pass=False, res=0):
    """(G, 2, N) interval rows, K1's operands and function with mu taken
    from the gram: B3 on CUDA, the plain version on CPU. ``three_pass``:
    V through K1-3p's product (B3-3p). ``res``: the float32 B3-3p's
    resident gram rows, as B1-3p's (a multiple of 32 up to the capacity
    rounded up to 64; 0, the most that fit: every row up to capacity
    ``RESIDENT3_CAP``); past them its warpgroups compute each chunk's
    gram as they come to it, and the chunk's diagonal row tile adds its
    ``u k``. Every ``res`` gives the same function; the tiled body takes
    none."""
    what = "B3-3p" if three_pass else "B3"
    if res and not (three_pass and zt.dtype == torch.float32):
        raise ValueError(f"res is the float32 B3-3p's knob, got {res}")
    _check_res3(xs.shape[-2], res, what)
    if zt.device.type == "cpu":
        return intervals_mu_from_gram_plain(zt, ils, xs, lm, w, scal, kind,
                                            three_pass)
    G, N, d, cap, dtype = k1_layout(zt, ils, xs, lm, w, scal, kind, what)
    u = mu_weights(lm, w).contiguous()
    out = torch.empty((G, 2, N), dtype=dtype, device=zt.device)
    lib = _library()
    if three_pass and dtype == torch.float32:     # K1-3p's wgmma bodies
        err = lib.safeopt_mu_from_gram3_f32(
            ptr(zt), ptr(ils), ptr(xs), ptr(factor_chunks(lm)), ptr(u),
            ptr(scal), ptr(out), G, N, d, cap, kind, res, _stream(zt))
    else:
        fn = (lib.safeopt_intervals_mu_from_gram_f32
              if dtype == torch.float32
              else lib.safeopt_intervals_mu_from_gram_f64)
        err = fn(ptr(zt), ptr(ils), ptr(xs), ptr(transposed_factor(lm)),
                 ptr(u), ptr(scal), ptr(out), G, N, d, cap, kind,
                 int(three_pass), _stream(zt))
    raise_on_error(err, f"{what} (intervals_mu_from_gram res={res})")
    if three_pass:
        intervals_mu_from_gram.three_pass_launches += 1
    else:
        intervals_mu_from_gram.launches += 1
    return out


intervals_mu_from_gram.launches = 0
intervals_mu_from_gram.three_pass_launches = 0


# -- B4 -----------------------------------------------------------------------

def padded_factor(lm: torch.Tensor) -> torch.Tensor:
    """(pad, pad) ``lm`` with zeros past ``cap``, pad the capacity rounded
    up to ``TILE_ROWS`` (64): whole row tiles and chunks, as B4 reads
    them."""
    cap = lm.shape[0]
    pad = -(-cap // TILE_ROWS) * TILE_ROWS
    if pad == cap:
        return lm.contiguous()
    out = lm.new_zeros((pad, pad))
    out[:cap, :cap] = lm
    return out


def _chunked(t: torch.Tensor, limb: str) -> torch.Tensor:
    """(pad, pad) ``t`` in B4's chunk order for ``limb``'s chunks: row
    tile, chunk, core-matrix column, row group of 8, row, value: (pad /
    64, pad / kc, kc / core, 8, 8, core), each chunk's limb in wgmma's
    no-swizzle core-matrix order (``factor_chunks``' for bf16)."""
    pad = t.shape[0]
    kc, core = CHUNK_COLS[limb], CORE_K[limb]
    return t.view(pad // TILE_ROWS, 8, 8, pad // kc, kc // core,
                  core).permute(0, 3, 4, 1, 2, 5)


def intervals_split_plain(zt, ils, xs, lm, w, scal, kind, limb="bf16",
                          round_lo=True):
    """Plain PyTorch version of ``intervals_split``: the limbs bit for bit
    (the gram of float32 operands as the kernel computes it), the three
    limb products and the epilogue in float64, the rows returned in the
    operands' dtype."""
    N = zt.shape[1]
    hi, lo = (t.double() for t in split_limbs(lm, limb, round_lo))
    w64 = w.double()
    out = torch.empty((2, N), dtype=torch.float64, device=zt.device)
    for s in range(0, N, PLAIN_COLS):
        e = min(s + PLAIN_COLS, N)
        k = kernel_gram(kind, xs, zt[:, s:e] * ils[:, None], scal[0])
        k_hi, k_lo = (t.double() for t in split_limbs(k, limb, round_lo))
        V = hi @ k_hi + hi @ k_lo + lo @ k_hi
        out[:, s:e] = _epilogue(V, w64, float(scal[1]), float(scal[2]))
    return out.to(zt.dtype)


def split_factor(lm: torch.Tensor, limb: str) -> torch.Tensor:
    """Lm's limbs as B4 reads them pre-split (the harness's ``hoisted``):
    ``lm`` padded to whole row tiles (``padded_factor``), cut to ``(hi,
    lo)`` (``split_limbs``), in chunks of 64 rows by ``CHUNK_COLS[limb]``
    columns, hi then lo, each in the core-matrix order (``_chunked``):
    (pad / 64, pad / kc, 2, kc / core, 8, 8, core), bf16 for bf16 limbs
    (``factor_chunks``' own layout, K1-3p's), float32 holding the tf32
    bits for tf32. Cut once and pass to ``intervals_split(limbs=...)``
    for as many launches as needed."""
    if limb not in LIMBS:
        raise ValueError(f"unknown limb format {limb!r}")
    limbs = split_limbs(padded_factor(lm), limb)
    if limb == "bf16":
        limbs = [t.to(torch.bfloat16) for t in limbs]
    return torch.stack([_chunked(t, limb) for t in limbs], dim=2).contiguous()


def factor_landing(lm: torch.Tensor, limb: str) -> torch.Tensor:
    """float32 ``lm`` as B4 takes it to cut its limbs in the kernel: in
    chunks of ``split_factor``'s, each as one contiguous piece that the
    kernel's warpgroup cuts in place (``csrc/intervals3.cuh``
    ``cut_chunk``): a value lands on the bytes of its own hi limb's
    core-matrix row. tf32 (4 values a 16-byte row): the hi limb's layout,
    (pad / 64, pad / 16, 4, 8, 8, 4). bf16 (8 values a row, 4 a 16-byte
    vector of float32): each row's first 4 values at its hi row, its last
    4 at its lo row, (pad / 64, pad / 32, 2, 4, 8, 8, 4)."""
    if limb not in LIMBS:
        raise ValueError(f"unknown limb format {limb!r}")
    t = _chunked(padded_factor(lm), limb)
    if limb == "bf16":
        t = t.reshape(*t.shape[:5], 2, 4).permute(0, 1, 5, 2, 3, 4, 6)
    return t.contiguous()


def intervals_split(zt, ils, xs, lm, w, scal, kind, limb="bf16",
                    limbs=None):
    """(2, N) interval rows of ONE GP through the split-limb product: B4
    on CUDA (float32 only), the plain version with ``lo`` rounded on CPU.

    K1's operands of one GP: ``zt`` (d, N), ``ils`` (d,), ``xs`` (cap,
    d) scaled, ``lm`` (cap, cap), ``w`` (cap,), ``scal`` (4,) = [variance,
    kdiag, beta, count]. ``limbs``, from ``split_factor(lm, limb)``, are
    Lm's limbs cut outside the kernel (the harness's ``hoisted``); None
    cuts them in the kernel from ``factor_landing(lm, limb)``, laid out
    by this call. The rows are the same bits either way. K1-3p's body for
    the capacity (``three_pass_body``), one GP: in bf16 with the limbs
    hoisted, K1-3p's own rows for that GP alone."""
    if limb not in LIMBS:
        raise ValueError(f"unknown limb format {limb!r}")
    if zt.device.type == "cpu":
        return intervals_split_plain(zt, ils, xs, lm, w, scal, kind, limb)
    if zt.device.type != "cuda":
        raise ValueError(f"B4 runs on CUDA or CPU tensors, not {zt.device}")
    if zt.dtype != torch.float32:
        raise TypeError(f"B4 takes float32 only, not {zt.dtype}")
    if kind not in KINDS.values():
        raise ValueError(f"unknown kernel kind {kind}")
    cap, d = xs.shape
    N = zt.shape[1]
    check_operands(
        dict(zt=zt, ils=ils, xs=xs, lm=lm, w=w, scal=scal), zt.device,
        torch.float32, dict(zt=(d, N), ils=(d,), xs=(cap, d),
                            lm=(cap, cap), w=(cap,), scal=(4,)))
    if limbs is None:
        chunks = factor_landing(lm, limb)
    else:
        pad, kc, core = (-(-cap // TILE_ROWS) * TILE_ROWS, CHUNK_COLS[limb],
                         CORE_K[limb])
        shape = (pad // TILE_ROWS, pad // kc, 2, kc // core, 8, 8, core)
        dtype = torch.bfloat16 if limb == "bf16" else torch.float32
        if (not torch.is_tensor(limbs) or limbs.device != zt.device
                or limbs.dtype != dtype or not limbs.is_contiguous()
                or tuple(limbs.shape) != shape):
            raise ValueError(f"limbs are one contiguous {shape} {dtype} "
                             f"tensor on {zt.device}, as split_factor(lm, "
                             f"{limb!r}) gives it")
        chunks = limbs
    out = torch.empty((2, N), dtype=torch.float32, device=zt.device)
    lib = _library()
    fn = (lib.safeopt_intervals_split_bf16 if limb == "bf16"
          else lib.safeopt_intervals_split_tf32)
    err = fn(ptr(zt), ptr(ils), ptr(xs), ptr(chunks), ptr(w), ptr(scal),
             ptr(out), N, d, cap, kind, int(limbs is not None), _stream(zt))
    raise_on_error(err, f"B4 (intervals_split {limb})")
    intervals_split.launches += 1
    intervals_split.limb_launches[limb] += 1
    return out


intervals_split.launches = 0
intervals_split.limb_launches = dict.fromkeys(LIMBS, 0)


# -- error bounds -------------------------------------------------------------

def float32_bound(zt, ils, xs, lm, w, scal, kind, what, limb=None,
                  three_pass=False):
    """Bound on |float32 kernel - plain version| per output, shaped like
    the kernel's output, for ``what`` in ``"intervals"`` (K1 and B1:
    V in FMA chains, mu = w . V), ``"mu_from_gram"`` (B3),
    ``"gram_sums"``, ``"solve_rank1"``, ``"no_product"``, ``"epilogue"``
    (B2/B5) and ``"split"`` (B4, with ``limb``; K1-3p in bf16). The
    operands are the kernel's float32 ones, upcast to float64 (the plain
    version B2/B3/B5 are held against runs on them); B4's and K1-3p's
    plain versions run on the float32 operands themselves, and so do
    those of ``three_pass`` ``"solve_rank1"`` and ``"mu_from_gram"``
    (B2-3p, B3-3p): their V is held as ``"split"``'s in bf16 limbs, and
    their gram, computed bit for bit as the kernel's, adds no error. RBF
    grams only.

    With u = 2^-24 and, per point, A = |Lm| |k| over the active rows:

    - a gram entry is off by at most eG = u var (8 + 2 sqrt(d) max|z|)
      (exp within 2 ulps and its argument's rounding, times r2 e^(-r2/2)
      <= 2/e and |diff| e^(-r2/2) <= e^(-1/2)); B4's plain version
      computes the kernel's gram bit for bit, so there eG = 2 u |k|;
    - a sum of m products in float32 is off by at most m u (sum of
      |products|): the FMA chains of K1's body take m = n per row of V;
      the rank-1 gram adds one rounding per entry;
    - the three-pass product over limbs (``"split"`` and ``three_pass``:
      B4, K1-3p, B2-3p, B3-3p) takes, in each k-step of K columns (K =
      16 for bf16, 8 for tf32) of a row's 64-row tile, the three limb
      products with at most two roundings each, every one within u of
      the row's running sum of |Lm| |k| after the step
      (``_split_error``), and the limbs' two roundings, 2 u A;
    - mu and sum V^2 add n terms more: |dmu| <= sum |w| dV + n u sum |w V|
      (B3: n u sum |u k| + eG sum |u| + u sum |u k|), |dq| <= sum (2|V| +
      dV) dV + n u sum V^2;
    - the rows mu -+ beta sigma: |dmu| + beta min(sqrt(dq'), dq' / sigma)
      with dq' = dq + u kdiag (0 where sum V^2 - dq' > kdiag: both sides
      clamp var to 0), plus 4 u (|mu| + beta sigma) for the roundings of
      the rows themselves (the kernel's and the plain version's).

    ``gram_sums``: n u sum |k| + n eG and n u sum k^2 + 2 eG sum |k| +
    n eG^2. These are worst cases (every rounding of one sign); a kernel
    that drops or misplaces terms is off by a share of A itself."""
    if kind != KINDS[RBF]:
        raise NotImplementedError("bounds derived for RBF grams only")
    if three_pass:
        if what not in ("solve_rank1", "mu_from_gram"):
            raise ValueError(f"{what!r} has no three-pass form here")
        limb = "bf16"
    u = U32
    f64 = dict(dtype=torch.float64, device=zt.device)
    single = xs.dim() == 2
    if single:                          # B4's operands of one GP
        ils, xs, lm, w, scal = (ils[None], xs[None], lm[None], w[None],
                                scal[None])
    zt, ils, xs, lm, w, scal = (t.to(**f64) for t in (zt, ils, xs, lm, w,
                                                       scal))
    G, cap, d = xs.shape
    N = zt.shape[1]
    out = torch.empty((G, 2, N), **f64)
    zmax = float((zt.abs().amax(dim=1)[None] * ils).max())
    for g, n in enumerate(_counts(scal, cap)):
        var, kdiag, beta = (float(x) for x in scal[g, :3])
        eG = u * var * (8.0 + 2.0 * math.sqrt(d) * zmax)
        L = lm[g, :n, :n]
        La = L.abs()
        uvec = L.T @ w[g, :n]
        for s in range(0, N, PLAIN_COLS):
            e = min(s + PLAIN_COLS, N)
            z = zt[:, s:e] * ils[g][:, None]
            if what == "epilogue":
                k = (0.01 * zt[0, s:e]).expand(n, e - s)
            elif what == "solve_rank1":
                k = xs[g, :n, 0, None] * zt[0, None, s:e]
            else:
                k = gram(kind, xs[g, :n], z, var)
            ka = k.abs()
            if what == "gram_sums":
                out[g, 0, s:e] = n * u * ka.sum(dim=0) + n * eG
                out[g, 1, s:e] = (n * u * (k * k).sum(dim=0)
                                  + 2 * eG * ka.sum(dim=0) + n * eG ** 2)
                continue
            if what == "no_product":
                V, dV = k, torch.full_like(k, eG)
            elif what == "epilogue":
                V, dV = k, 2 * u * ka
            else:
                V = L @ k
                A = La @ ka
                if what == "split" or three_pass:
                    dV = _split_error(La, ka, n, limb, A)
                elif what == "solve_rank1":
                    dV = (n + 1) * u * A
                elif what in ("intervals", "mu_from_gram"):
                    dV = n * u * A + eG * La.sum(dim=1)[:, None]
                else:
                    raise ValueError(f"unknown kernel {what!r}")
            dmu = None
            if what == "mu_from_gram":
                uk = (uvec[:, None] * k).abs().sum(dim=0)
                dmu = n * u * uk + u * uk
                if not three_pass:
                    dmu = dmu + eG * uvec.abs().sum()
            tol = _rows_tolerance(V, dV, w[g, :n], n, kdiag, beta, dmu)
            out[g, 0, s:e] = tol
            out[g, 1, s:e] = tol
    return out[0] if single else out


def _split_error(La, ka, n, limb, A=None):
    """``float32_bound``'s |dV| (n, B) of the three-pass product over
    ``limb`` limbs from |Lm| (n, n) and |k| (n, B): row r's tile (64 rows)
    runs s_r = ceil(min(64 (r // 64 + 1), n) / K) k-steps of K =
    ``MMA_K[limb]`` columns, each adding the three limb products with at
    most two roundings, each within u of the running sum after the step,
    which is at most the sum of |Lm[r, c]| |k[c]| over the columns read so
    far: 6 u sum_c (s_r - c // K) |Lm[r, c]| |k[c]|, plus the limbs' own
    2 u A (A = |Lm| |k|)."""
    K = MMA_K[limb]
    r = torch.arange(n, device=La.device)
    steps = -(-torch.clamp(TILE_ROWS * (r // TILE_ROWS + 1), max=n) // K)
    W = (steps[:, None] - (r // K)[None, :]).clamp(min=0).to(La.dtype)
    if A is None:
        A = La @ ka
    return U32 * (6 * ((La * W) @ ka) + 2 * A)


def _rows_tolerance(V, dV, w, n, kdiag, beta, dmu=None):
    """``float32_bound``'s distance of the rows mu -+ beta sigma from V
    (n, B) off by at most dV per entry: |dmu| (unless given) + beta
    |dsigma| + the rows' own roundings."""
    u = U32
    wv = w[:, None] * V
    if dmu is None:
        dmu = (w[:, None].abs() * dV).sum(dim=0) + n * u * wv.abs().sum(dim=0)
    ssq = (V * V).sum(dim=0)
    dq = ((2 * V.abs() + dV) * dV).sum(dim=0) + n * u * ssq + u * kdiag
    sd = torch.clamp(kdiag - ssq, min=0.0).sqrt()
    # past kdiag by more than dq, both sides clamp var to 0
    dsd = torch.where(ssq - dq > kdiag, 0.0,
                      torch.minimum(dq.sqrt(), dq / sd))
    return dmu + beta * dsd + 4 * u * (wv.sum(dim=0).abs() + beta * sd)


def float32_bound_plan(zt, xs, lm, w, scales, pvar, plan, scal,
                       limb="bf16"):
    """``float32_bound(..., "split", limb)`` for K2's operands (one GP
    with a plan gram, K2-3p against ``fused_intervals_plan3_plain``):
    (2, N), from the plan's float64 gram; any leaf kinds (the plain
    version computes the kernel's gram bit for bit, so the gram's own
    error does not enter). ``limb`` None bounds K2 itself, V in float32
    FMA chains of at most n products a row (m = n, as
    ``float32_bound``'s ``"intervals"``), against
    ``plan_rows_on_kernel_gram``, which also takes the kernel's gram."""
    f64 = dict(dtype=torch.float64, device=zt.device)
    zt, xs, lm, w, pvar, scal = (t.to(**f64) for t in (zt, xs, lm, w, pvar,
                                                        scal))
    cap, N = xs.shape[0], zt.shape[1]
    n = _counts(scal[None], cap)[0]
    kdiag, beta = float(scal[1]), float(scal[2])
    kinds, terms = plan.tolist()
    rows = scales.tolist()
    L = lm[:n, :n]
    out = torch.empty((2, N), **f64)
    for s in range(0, N, PLAIN_COLS):
        e = min(s + PLAIN_COLS, N)
        k = plan_gram(xs[:n], zt[:, s:e], rows, pvar, kinds, terms)
        dV = (n * U32 * (L.abs() @ k.abs()) if limb is None
              else _split_error(L.abs(), k.abs(), n, limb))
        tol = _rows_tolerance(L @ k, dV, w[:n], n, kdiag, beta)
        out[0, s:e] = tol
        out[1, s:e] = tol
    return out


def plan_rows_on_kernel_gram(zt, xs, lm, w, scales, pvar, plan, scal):
    """(2, N) rows of K2's function in float64 from its float32 operands,
    on the gram the float32 kernel computes (``kernel_plan_gram``): what
    ``float32_bound_plan(..., limb=None)`` holds the float32 K2 to, so
    that only the product's and the sums' roundings are left."""
    kinds, terms = plan.tolist()
    rows = scales.tolist()
    f64 = torch.float64
    return interval_rows(
        lambda s, e: kernel_plan_gram(xs, zt[:, s:e], rows, pvar, kinds,
                                      terms).to(f64),
        lm.to(f64), w.to(f64), scal[1].to(f64), scal[2].to(f64),
        zt.shape[1])


def drop_band(ops, what, first=True):
    """``ops`` (K1's operands, one GP's in B4's layout, or K2's) as a
    kernel that drops each GP's first (or last) 32 active rows would see
    them: where V is Lm times a gram (``what`` in ``"solve_rank1"``,
    ``"mu_from_gram"``, ``"split"``, ``"intervals"``; K2's operands
    take ``"split"`` only) those rows of Lm zeroed; elsewhere the count
    cut by 32, after
    the operand rows moved up by 32 for the first band. The rows'
    distance from the sound ones past ``float32_bound`` shows that the
    float32 check would fail such a kernel."""
    if len(ops) == 8:                   # K2's: one GP with a plan
        if what != "split":
            raise ValueError(f"K2's operands take 'split', not {what!r}")
        zt, xs, lm, w, scales, pvar, plan, scal = ops
        n = _counts(scal[None], lm.shape[-1])[0]
        lo = 0 if first else max(n - 32, 0)
        lm = lm.clone()
        lm[lo:min(lo + 32, n)] = 0
        return zt, xs, lm, w, scales, pvar, plan, scal
    zt, ils, xs, lm, w, scal, kind = ops
    lm, scal = lm.clone(), scal.clone()
    if what in ("solve_rank1", "mu_from_gram", "split", "intervals"):
        rows = lm.view(-1, *lm.shape[-2:])
        for g, n in enumerate(_counts(scal.view(-1, 4), lm.shape[-1])):
            lo = 0 if first else max(n - 32, 0)
            rows[g, lo:min(lo + 32, n)] = 0
    else:
        if first:
            xs, w = xs.roll(-32, dims=-2), w.roll(-32, dims=-1)
        scal[..., 3] -= 32
    return zt, ils, xs, lm, w, scal, kind

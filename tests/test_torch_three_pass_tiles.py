"""The float32 K1-3p/K2-3p layout and summation order, on the CPU.

The CUDA kernels of ``csrc/fused_intervals3.cu`` (``intervals3.cuh``)
run only on the card. What they read and in what order they add is
checked here before any card run:

- ``factor_chunks``, the factor's bf16 limbs in the order the kernels
  read them, holds ``split_limbs(Lm)`` bit for bit and zeros past the
  count and the capacity;
- a float32 emulation of the kernels' arithmetic (``emulate``): the
  gram's limbs cut from the kernel's gram (``kernel_gram``,
  ``kernel_plan_gram``); per row tile of 64 and k16 step the three limb
  products, each a float32 sum added to a float32 accumulator; the tiles
  shared among three warpgroups (the kernels' block past capacity 128;
  at and below it one warpgroup takes every tile), largest first, each
  to the one with less work so far; per point, each warp's two rows a
  thread, a butterfly over a warp's eight row pairs, each warp's tiles
  in its order and the warps in order. On the cap-512 state (chip_smoke's
  phase 11 and 12, two GPs of 400 observations) and the contextual one
  (240 observations, the contextual kernel, scaling 'auto') it lies
  within ``float32_bound`` of the plain version, and its scaled error
  against the float64 rows stays under the certified path's slack,
  ``refine_band - boundary_band``.

The tensor cores add a k16 step's products at a precision of their own;
the emulation adds them exactly (in float64) and rounds once, which the
bound's two roundings a step cover.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import safeopt_torch as pt
from safeopt_torch.algorithms.safe_opt import REFINE_BAND
from safeopt_torch.ops import fused_posterior as fp
from safeopt_torch.ops import interval_experiments as ie

# csrc/intervals3.cuh: rows of a tile, columns of a k16 step, consumer
# warpgroups of a block past capacity 128
TILE, K16, GROUPS = 64, 16, 3


def _refine_slack():
    return REFINE_BAND - inspect.signature(pt.SafeOpt).parameters[
        "boundary_band"].default


def _unchunk(chunks, cap):
    """(G, cap, cap) hi and lo limbs back from ``factor_chunks``."""
    G, mt, qt = chunks.shape[:3]
    # to (limb, G, row tile, row group, row, chunk, column group, column)
    t = chunks.float().permute(3, 0, 1, 5, 6, 2, 4, 7)
    t = t.reshape(2, G, mt * TILE, qt * fp.CHUNK_COLS)
    return t[0, :, :cap, :cap], t[1, :, :cap, :cap], t


@pytest.mark.parametrize("G,cap", [(1, 64), (2, 100), (2, 512), (1, 1000)])
def test_factor_chunks_hold_the_limbs(G, cap):
    """Every entry of the chunks is the matching limb of ``Lm``, bit for
    bit; the padding past the capacity is zero."""
    gen = torch.Generator().manual_seed(cap)
    lm = torch.randn(G, cap, cap, generator=gen).tril() * 30.0
    chunks = fp.factor_chunks(lm)
    pad = -(-cap // TILE) * TILE
    assert chunks.dtype == torch.bfloat16
    assert chunks.shape == (G, pad // TILE, pad // fp.CHUNK_COLS, 2,
                            fp.CHUNK_COLS // 8, 8, 8, 8)
    hi, lo, full = _unchunk(chunks, cap)
    want_hi, want_lo = fp.split_limbs(lm, "bf16")
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert not full[:, :, cap:].any() and not full[:, :, :, cap:].any()
    # one 8 KB chunk per (row tile, column chunk), hi then lo
    assert chunks[0, 0, 0].numel() * 2 == 8192


def test_factor_chunks_are_zero_past_the_count():
    """The masked factor of a GP below its capacity: the rows and columns
    past the count, which the kernels never multiply, are exact zeros in
    the chunks too."""
    gp = _state_gps(400, 512, torch.float32)[0]
    ops = fp.interval_operands([gp.kern], [gp.state],
                               torch.zeros((3, 2)), 2.0)
    hi, lo, _ = _unchunk(fp.factor_chunks(ops[3]), 512)
    for limb in (hi, lo):
        assert not limb[:, 400:].any() and not limb[:, :, 400:].any()
    assert hi[:, :400, :400].any()


def tile_order(n, groups=GROUPS):
    """``[(m, kend, group)]``: the kernels' row tiles at count n in the
    order they are taken, largest first, each to the warpgroup with less
    work so far (in k16 steps; ties to the lower index)."""
    load, out = [0] * groups, []
    for m in range(-(-n // TILE) - 1, -1, -1):
        kend = min(TILE * (m + 1), n)
        o = min(range(groups), key=lambda q: (load[q], q))
        load[o] += -(-kend // K16)
        out.append((m, kend, o))
    return out


def test_tile_order_balances_the_warpgroups():
    """At n = 400 the three warpgroups get 37, 36 and 36 k16 steps of the
    109; every tile goes to one warpgroup."""
    order = tile_order(400)
    steps = [sum(-(-k // K16) for _, k, g in order if g == q)
             for q in range(GROUPS)]
    assert sorted(m for m, _, _ in order) == list(range(7))
    assert steps == [37, 36, 36]


def _f32(x):
    return x.to(torch.float32)


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once."""
    return _f32(a.double() * b.double() + c.double())


def emulate(k, hi, lo, w, n, kdiag, beta):
    """(2, B) float32 rows of one GP as the float32 K1-3p/K2-3p add them:
    ``k`` (cap, B) the kernel's float32 gram, ``hi``/``lo`` (cap, cap) the
    factor's limbs, ``w`` (cap,) float32."""
    B = k.shape[1]
    nk = -(-n // K16) * K16
    kg = torch.zeros((nk, B), dtype=torch.float32)
    kg[:n] = k[:n]
    k_hi, k_lo = fp.split_limbs(kg, "bf16")
    pad = -(-n // TILE) * TILE + TILE
    a_hi = torch.zeros((pad, nk), dtype=torch.float64)
    a_lo = torch.zeros((pad, nk), dtype=torch.float64)
    a_hi[:n, :n], a_lo[:n, :n] = hi[:n, :n].double(), lo[:n, :n].double()
    wv = torch.zeros(pad, dtype=torch.float32)
    wv[:n] = w[:n]
    red_m = torch.zeros((GROUPS * 4, B), dtype=torch.float32)
    red_q = torch.zeros((GROUPS * 4, B), dtype=torch.float32)
    for m, kend, g in tile_order(n):
        rows = slice(TILE * m, TILE * (m + 1))
        acc = torch.zeros((TILE, B), dtype=torch.float32)
        for c in range(0, kend, K16):
            cols = slice(c, c + K16)
            for a, b in ((a_hi, k_hi), (a_hi, k_lo), (a_lo, k_hi)):
                acc = _f32(acc.double() + a[rows, cols] @ b[cols].double())
        wt = wv[rows]
        for warp in range(4):
            r0 = torch.arange(8) + 16 * warp       # rows gid, gid + 8
            v0, v1 = acc[r0], acc[r0 + 8]
            mm = _fma32(wt[r0 + 8, None], v1, _f32(wt[r0, None] * v0))
            qq = _fma32(v1, v1, _f32(v0 * v0))
            for o in (1, 2, 4):                    # lanes xor 4, 8, 16
                mm = mm + mm[torch.arange(8) ^ o]
                qq = qq + qq[torch.arange(8) ^ o]
            red_m[4 * g + warp] += mm[0]
            red_q[4 * g + warp] += qq[0]
    mu = torch.zeros(B, dtype=torch.float32)
    q = torch.zeros(B, dtype=torch.float32)
    for v in range(GROUPS * 4):
        mu, q = mu + red_m[v], q + red_q[v]
    spread = _f32(beta) * torch.sqrt(torch.clamp(_f32(kdiag) - q, min=0.0))
    return torch.stack([mu - spread, mu + spread])


def _state_gps(n_obs, cap, dtype):
    """chip_smoke's cap-512 GPs (``tools_torch/states.py`` build_gps:
    the flagship pair, observations from ``default_rng(512)`` in
    [-4, 4]^2) on the CPU."""
    rng = np.random.default_rng(512)
    X = rng.uniform(-4.0, 4.0, size=(n_obs, 2))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
          + 0.05 * rng.normal(size=n_obs))[:, None]
    Yg = (1.0 - 0.1 * np.sum(X ** 2, axis=1)
          + 0.05 * rng.normal(size=n_obs))[:, None]
    return [pt.GPRegression(X, Y, pt.RBF(2, variance=v, lengthscale=ls),
                            noise_var=0.05 ** 2, capacity=cap, device="cpu",
                            dtype=dtype)
            for Y, v, ls in ((Yf, 2.0, 1.0), (Yg, 1.0, 1.5))]


def _context_gps(dtype):
    """chip_smoke's contextual GPs (``context_gps(2, 240, 256)``: the
    contextual kernel, 240 observations from ``default_rng(3)`` in
    [-3, 3] at context 0) on the CPU."""
    rng = np.random.default_rng(3)
    X = np.hstack([rng.uniform(-3.0, 3.0, size=(240, 1)),
                   np.zeros((240, 1))])
    base = np.exp(-0.5 * X[:, 0] ** 2) * np.exp(-0.5 * (X[:, 1] / 1.5) ** 2)
    out = []
    for scale in (2.0, 1.5):
        kern = (pt.RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0])
                * pt.RBF(1, variance=1.0, lengthscale=1.5, active_dims=[1]))
        out.append(pt.GPRegression(X, (scale * base)[:, None], kern,
                                   noise_var=0.05 ** 2, capacity=256,
                                   device="cpu", dtype=dtype))
    return out


def _grid(dtype):
    """Every 97th point of chip_smoke's 1000 x 1000 grid on [-5, 5]^2
    (10,310 points)."""
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2, 1000)[::97]
    return torch.tensor(grid, dtype=dtype)


def test_emulated_order_on_the_cap512_state():
    """K1-3p's float32 order within ``float32_bound`` of its plain version
    and under the slack in scaled |dQ| against the float64 rows."""
    ops = {}
    for dt in (torch.float64, torch.float32):
        gps = _state_gps(400, 512, dt)
        ops[dt] = fp.interval_operands([g.kern for g in gps],
                                       [g.state for g in gps], _grid(dt),
                                       2.0)
    zt, ils, xs, lm, w, scal, kind = ops[torch.float32]
    hi, lo = fp.split_limbs(lm, "bf16")
    got = torch.stack([
        emulate(fp.kernel_gram(kind, xs[g], zt * ils[g][:, None],
                               scal[g, 0]),
                hi[g], lo[g], w[g], int(scal[g, 3]), scal[g, 1], scal[g, 2])
        for g in range(2)])
    want = fp.fused_intervals3_plain(*ops[torch.float32])
    bound = ie.float32_bound(*ops[torch.float32], "split", limb="bf16")
    assert ((got.double() - want.double()).abs() / bound).max() <= 1.0
    ref = fp.fused_intervals_plain(*ops[torch.float64])
    scale = torch.tensor([math.sqrt(2.0), 1.0], dtype=torch.float64)
    dq = ((got.double() - ref).abs() / scale[:, None, None]).max().item()
    assert dq < _refine_slack(), dq


def test_emulated_order_on_the_contextual_state():
    """K2-3p's float32 order on one contextual GP, as
    ``test_emulated_order_on_the_cap512_state``; scaled by the prior
    standard deviation (scaling 'auto')."""
    ops = {}
    for dt in (torch.float64, torch.float32):
        gp = _context_gps(dt)[0]
        ops[dt] = fp.interval_plan_operands(gp.kern, gp.state, _grid(dt),
                                            2.0)
    zt, xs, lm, w, scales, pvar, plan, scal = ops[torch.float32]
    kinds, terms = plan.tolist()
    k = fp.kernel_plan_gram(xs, zt, scales.tolist(), pvar, kinds, terms)
    hi, lo = fp.split_limbs(lm, "bf16")
    got = emulate(k, hi, lo, w, int(scal[3]), scal[1], scal[2])
    want = fp.fused_intervals_plan3_plain(*ops[torch.float32])
    bound = ie.float32_bound_plan(*ops[torch.float32])
    assert ((got.double() - want.double()).abs() / bound).max() <= 1.0
    ref = fp.fused_intervals_plan_plain(*ops[torch.float64])
    dq = ((got.double() - ref).abs().max()
          / math.sqrt(float(ops[torch.float64][7][1]))).item()
    assert dq < _refine_slack(), dq


def test_emulated_order_sees_a_dropped_tile():
    """The emulation is no stand-in for the plain version: one row tile
    left out lands far past the float32 bound."""
    gps = _state_gps(400, 512, torch.float32)
    ops = fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                               _grid(torch.float32)[:2000], 2.0)
    zt, ils, xs, lm, w, scal, kind = ops
    k = fp.kernel_gram(kind, xs[0], zt * ils[0][:, None], scal[0, 0])
    hi, lo = fp.split_limbs(lm[0], "bf16")
    lm_drop = lm.clone()
    lm_drop[0, 64:128] = 0
    hi_d, lo_d = fp.split_limbs(lm_drop[0], "bf16")
    full = emulate(k, hi, lo, w[0], 400, scal[0, 1], scal[0, 2])
    dropped = emulate(k, hi_d, lo_d, w[0], 400, scal[0, 1], scal[0, 2])
    bound = ie.float32_bound(*ops, "split", limb="bf16")[0]
    assert ((full.double() - dropped.double()).abs() / bound).max() > 1.0

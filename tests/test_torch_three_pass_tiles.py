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
  shared among three warpgroups, in the resident body (the kernels'
  block past capacity 128; at and below it one warpgroup takes every
  tile) largest first, each to the one with less work so far
  (``tile_order``), in the tiled body past capacity 576 in bands of
  four tiles aligned to the last tile, one a warpgroup, bands in order
  (``band_order``); per point,
  each warp's two rows a thread, a butterfly over a warp's eight row
  pairs, each warp's tiles in its order and the warps in order. On the
  cap-512 state (chip_smoke's phase 11 and 12, two GPs of 400
  observations), the contextual one (240 observations, the contextual
  kernel, scaling 'auto') and, in the tiled body's order, the cap-1024
  state (600 observations) and the contextual GP at capacity 1024 (600
  observations over contexts in [-1, 1]) it lies within
  ``float32_bound`` of the plain version, and its scaled error against
  the float64 rows stays under the certified path's slack,
  ``refine_band - boundary_band``;
- the launchers' body rule (``fused_posterior.three_pass_body``) against
  the resident body's shared-memory arithmetic (``Iv3Layout``: every
  gram row resident up to capacity 576, not at 640), and the tiled
  body's layout within a block's shared memory at every grid width.

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


@pytest.mark.parametrize("G,cap", [(1, 64), (2, 100), (2, 512), (1, 1000),
                                   (1, 576), (1, 640), (1, 2048)])
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


# csrc/intervals3_tiled.cuh: warpgroups of the tiled body, one row tile
# of a band each
TILED_GROUPS = 4
# the warps whose sums per point the kernels add in order (the unused
# ones of the resident body's three warpgroups add zeros)
WARPS = 4 * max(GROUPS, TILED_GROUPS)


def band_order(n, groups=TILED_GROUPS):
    """``[(m, kend, group)]``: the tiled body's row tiles at count n in
    the order each warpgroup adds them: bands of ``groups`` tiles aligned
    to the last tile (band 0 short where the tiles are no multiple of a
    band), bands in order, tile w of a band to warpgroup w."""
    mt = -(-n // TILE)
    shift = groups * -(-mt // groups) - mt
    return [(m, min(TILE * (m + 1), n), (m + shift) % groups)
            for m in range(mt)]


# csrc/intervals3.cuh and intervals3_tiled.cuh: a block's shared memory
# (kSmemPerBlock), a factor chunk's bytes, rings and stages of the
# resident body, a tiled step's gram limb, K2-3p's static plan
# (PlanSmem<float>: 8 leaves over 64 columns)
SMEM, CHUNK, RESIDENT_STAGES = 227 * 1024, 8192, 3
STEP_BYTES, PLAN_SMEM = 96 * 128 * 2, 4 * (2 * 8 * 64 + 4 * 8)


def _resident_bytes(cap, d):
    """``Iv3Layout<3>(cap, d, cap_pad).bytes``: every gram row resident
    (hi and lo, 64 points), the rings, the points, the warps' sums and
    the barriers."""
    pad = -(-cap // TILE) * TILE
    return (GROUPS * RESIDENT_STAGES * CHUNK + 2 * pad * 64 * 2
            + 4 * d * 64 + 4 * 2 * 4 * GROUPS * 64
            + 8 * 2 * GROUPS * RESIDENT_STAGES)


def _tiled_bytes(d, stages):
    """``Iv3TiledLayout(d, stages).bytes``: the rings, two steps of gram
    limbs, the points, the warps' sums and the barriers."""
    return (TILED_GROUPS * stages * CHUNK + 4 * STEP_BYTES + 4 * d * 128
            + 4 * 2 * 4 * TILED_GROUPS * 128 + 8 * TILED_GROUPS * stages)


@pytest.mark.parametrize("cap", [64, 512, 576, 577, 640, 1024, 2048])
def test_three_pass_body_follows_the_resident_layout(cap):
    """The resident body keeps every gram row of a capacity up to 576
    (beside K2-3p's static plan, at d = 2); the launchers take the tiled
    body at the first capacity whose rows do not fit."""
    fits = _resident_bytes(cap, 2) + PLAN_SMEM <= SMEM
    assert fp.three_pass_body(cap) == ("resident" if fits else "tiled")
    assert fp.three_pass_body(cap) == (
        "resident" if cap <= fp.RESIDENT3_CAP else "tiled")


def test_tiled_layout_fits_every_grid_width():
    """``interval3_tiled_layout``: the most chunks in flight a ring, from a
    step's three and one more down to two, that fit beside K2-3p's static
    plan; three or more up to four grid columns, two at least at every
    width up to ``MAX_DIM``."""
    def stages(d):
        return max((s for s in range(2, 5)
                    if _tiled_bytes(d, s) + PLAN_SMEM <= SMEM), default=0)
    assert all(stages(d) >= 3 for d in range(1, 5))
    assert all(stages(d) >= 2 for d in range(1, fp.MAX_DIM + 1))


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


def emulate(k, hi, lo, w, n, kdiag, beta, order=tile_order):
    """(2, B) float32 rows of one GP as the float32 K1-3p/K2-3p add them:
    ``k`` (cap, B) the kernel's float32 gram, ``hi``/``lo`` (cap, cap) the
    factor's limbs, ``w`` (cap,) float32; ``order`` the body's tile order
    (``tile_order``, the resident body; ``band_order``, the tiled one)."""
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
    red_m = torch.zeros((WARPS, B), dtype=torch.float32)
    red_q = torch.zeros((WARPS, B), dtype=torch.float32)
    for m, kend, g in order(n):
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
            mm = fp._fma32(wt[r0 + 8, None], v1, _f32(wt[r0, None] * v0))
            qq = fp._fma32(v1, v1, _f32(v0 * v0))
            for o in (1, 2, 4):                    # lanes xor 4, 8, 16
                mm = mm + mm[torch.arange(8) ^ o]
                qq = qq + qq[torch.arange(8) ^ o]
            red_m[4 * g + warp] += mm[0]
            red_q[4 * g + warp] += qq[0]
    mu = torch.zeros(B, dtype=torch.float32)
    q = torch.zeros(B, dtype=torch.float32)
    for v in range(WARPS):
        mu, q = mu + red_m[v], q + red_q[v]
    spread = _f32(beta) * torch.sqrt(torch.clamp(_f32(kdiag) - q, min=0.0))
    return torch.stack([mu - spread, mu + spread])


def _state_gps(n_obs, cap, dtype, seed=512):
    """chip_smoke's cap-512 GPs (``tools_torch/states.py`` build_gps:
    the flagship pair, observations from ``default_rng(seed)`` in
    [-4, 4]^2) on the CPU; ``measure.py``'s cap1024 is GP 0 of seed 1024
    with 600 observations."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, size=(n_obs, 2))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
          + 0.05 * rng.normal(size=n_obs))[:, None]
    Yg = (1.0 - 0.1 * np.sum(X ** 2, axis=1)
          + 0.05 * rng.normal(size=n_obs))[:, None]
    return [pt.GPRegression(X, Y, pt.RBF(2, variance=v, lengthscale=ls),
                            noise_var=0.05 ** 2, capacity=cap, device="cpu",
                            dtype=dtype)
            for Y, v, ls in ((Yf, 2.0, 1.0), (Yg, 1.0, 1.5))]


def _context_gps(dtype, n_obs=240, cap=256, spread_contexts=False):
    """chip_smoke's contextual GPs (``context_gps(2, 240, 256)``: the
    contextual kernel, 240 observations from ``default_rng(3)`` in
    [-3, 3] at context 0; with ``spread_contexts`` contexts uniform in
    [-1, 1], as ``context1024``) on the CPU."""
    rng = np.random.default_rng(3)
    ctx = (rng.uniform(-1.0, 1.0, size=(n_obs, 1)) if spread_contexts
           else np.zeros((n_obs, 1)))
    X = np.hstack([rng.uniform(-3.0, 3.0, size=(n_obs, 1)), ctx])
    base = np.exp(-0.5 * X[:, 0] ** 2) * np.exp(-0.5 * (X[:, 1] / 1.5) ** 2)
    out = []
    for scale in (2.0, 1.5):
        kern = (pt.RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0])
                * pt.RBF(1, variance=1.0, lengthscale=1.5, active_dims=[1]))
        out.append(pt.GPRegression(X, (scale * base)[:, None], kern,
                                   noise_var=0.05 ** 2, capacity=cap,
                                   device="cpu", dtype=dtype))
    return out


def _grid(dtype, every=97):
    """Every 97th point of chip_smoke's 1000 x 1000 grid on [-5, 5]^2
    (10,310 points), or every ``every``-th."""
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2,
                                           1000)[::every]
    return torch.tensor(grid, dtype=dtype)


def _k1_order_case(n_obs, cap, seed, G, order, every=97):
    """The emulated K1-3p of ``_state_gps(n_obs, cap, seed=seed)[:G]`` in
    ``order`` over ``_grid(every=every)`` against its plain version's
    float32 bound and the float64 rows' slack."""
    ops = {}
    for dt in (torch.float64, torch.float32):
        gps = _state_gps(n_obs, cap, dt, seed=seed)[:G]
        ops[dt] = fp.interval_operands([g.kern for g in gps],
                                       [g.state for g in gps],
                                       _grid(dt, every), 2.0)
    zt, ils, xs, lm, w, scal, kind = ops[torch.float32]
    hi, lo = fp.split_limbs(lm, "bf16")
    got = torch.stack([
        emulate(fp.kernel_gram(kind, xs[g], zt * ils[g][:, None],
                               scal[g, 0]),
                hi[g], lo[g], w[g], int(scal[g, 3]), scal[g, 1], scal[g, 2],
                order)
        for g in range(G)])
    want = fp.fused_intervals3_plain(*ops[torch.float32])
    bound = ie.float32_bound(*ops[torch.float32], "split", limb="bf16")
    assert ((got.double() - want.double()).abs() / bound).max() <= 1.0
    ref = fp.fused_intervals_plain(*ops[torch.float64])
    scale = torch.tensor([math.sqrt(2.0), 1.0][:G], dtype=torch.float64)
    dq = ((got.double() - ref).abs() / scale[:, None, None]).max().item()
    assert dq < _refine_slack(), dq


def test_emulated_order_on_the_cap512_state():
    """K1-3p's float32 order within ``float32_bound`` of its plain version
    and under the slack in scaled |dQ| against the float64 rows."""
    _k1_order_case(400, 512, 512, 2, tile_order)


def test_emulated_tiled_order_on_the_cap1024_state():
    """The tiled body's order (``band_order``) past the resident rows, on
    ``measure.py``'s cap1024 (GP 0, 600 observations), as above."""
    assert fp.three_pass_body(1024) == "tiled"
    _k1_order_case(600, 1024, 1024, 1, band_order, every=389)


def _k2_order_case(n_obs, cap, spread, order, every=97):
    """The emulated K2-3p of one contextual GP in ``order`` over
    ``_grid(every=every)`` against its plain version's float32 bound;
    returns its scaled |dQ| against the float64 rows and the plain
    version's own, scaled by the prior standard deviation (scaling
    'auto')."""
    ops = {}
    for dt in (torch.float64, torch.float32):
        gp = _context_gps(dt, n_obs, cap, spread)[0]
        ops[dt] = fp.interval_plan_operands(gp.kern, gp.state,
                                            _grid(dt, every), 2.0)
    zt, xs, lm, w, scales, pvar, plan, scal = ops[torch.float32]
    kinds, terms = plan.tolist()
    k = fp.kernel_plan_gram(xs, zt, scales.tolist(), pvar, kinds, terms)
    hi, lo = fp.split_limbs(lm, "bf16")
    got = emulate(k, hi, lo, w, int(scal[3]), scal[1], scal[2], order)
    want = fp.fused_intervals_plan3_plain(*ops[torch.float32])
    bound = ie.float32_bound_plan(*ops[torch.float32])
    assert ((got.double() - want.double()).abs() / bound).max() <= 1.0
    ref = fp.fused_intervals_plan_plain(*ops[torch.float64])
    std = math.sqrt(float(ops[torch.float64][7][1]))
    return (((got.double() - ref).abs().max() / std).item(),
            ((want.double() - ref).abs().max() / std).item())


def test_emulated_order_on_the_contextual_state():
    """K2-3p's float32 order on one contextual GP, as
    ``test_emulated_order_on_the_cap512_state``."""
    dq, _ = _k2_order_case(240, 256, False, tile_order)
    assert dq < _refine_slack(), dq


def test_emulated_tiled_order_on_the_contextual_cap1024_state():
    """The tiled body's order on ``context1024``'s GP 0 (600 observations
    over contexts in [-1, 1], capacity 1024): its scaled |dQ| is the
    plain three-pass version's own to 1e-3. That one is past the
    certified path's slack at this state (2.27e-2 against 1.9e-2): the
    bf16 limbs of a long campaign's factor (max |Lm| near 20), not the
    kernels' order (ROADMAP Queue 3); pinned here."""
    dq, dq_plain = _k2_order_case(600, 1024, True, band_order)
    assert abs(dq - dq_plain) <= 1e-3 * dq_plain, (dq, dq_plain)
    assert dq_plain > _refine_slack(), dq_plain


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

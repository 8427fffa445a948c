"""The plain versions of the experiment kernels B1-B5 against the JAX side.

Both packages hold one model (``safeopt_torch.convert`` carries the host
factor across), float64 on the CPU. The JAX kernels run as the JAX
package's tests run Pallas on the CPU (interpret mode), or, where a
harness builds its kernel inside ``main()`` or at import time, as a
transcription of its kernel body with the JAX package's own helpers:

- B1 (K1 at a launch layout) and B3 (K1 with mu from the gram) are K1's
  function: against ``_fused_intervals_multi_impl``, atol 1e-10 as K1's
  own test (only summation order differs); B1-3p against it at
  ``three_pass=True``.
- B3-3p: ``benchmarks/bench_interval_mosaic4.py:80-82, 95-113``
  (``kern_mxu_emit`` and its prologue) transcribed: V from
  ``_tri_matmul(three_pass=True)``, ``u . G`` and ``sum V^2`` from
  HIGHEST products; atol 1e-10 in float64, ``lo`` unrounded as the JAX
  package's float64 3-pass product leaves it.
- B2: ``benchmarks/bench_interval_mosaic3.py:86-120`` (``gram_block``,
  ``kern_gram_only``, ``kern_solve_only``) transcribed, with
  ``_tri_matmul`` from ``safeopt_tpu.ops.fused_posterior``; B2-3p is
  ``kern_solve_only`` at ``three_pass=True``.
- B4: ``benchmarks/bench_interval_variants.py`` imports
  ``_split_hi_lo``, which the JAX package no longer has, so its kernel
  (``:92-118``) is transcribed with its product ``_tri3`` taken as
  ``_tri_matmul(three_pass=True)``, the same three limb products (``hi =
  bf16(x)``, ``lo = x - hi``). Without rounding ``lo`` the plain version
  agrees to 1e-10; rounding ``lo`` as a tensor core does moves V by at most
  2 e |Lm| |k| (e = 2^-16 for bf16, 2^-22 for tf32, the rounding of a lo
  limb relative to x), and the rows by what that gives through mu and
  sum V^2.
- B5: ``benchmarks/bench_interval_ablation.py:49-78`` transcribed (its
  module builds a capacity-512 GP and a 1e6-point grid when imported).

The port runs B2's sums and B5's ablations over each GP's active rows, as
K1 does, where the TPU kernels ran over the capacity; the transcriptions
get the active rows. On CPU tensors every wrapper runs its plain version
and counts no launch (neither ``launches`` nor ``three_pass_launches``).
Only ``solve_rank1`` of the ablations has a product, so only it takes
``three_pass``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safeopt_tpu as jt
from safeopt_torch.convert import gp_arrays, gp_from_arrays, kernel_from_params
from safeopt_torch.convert import kernel_params
from safeopt_torch.ops import fused_posterior as pfp
from safeopt_torch.ops import interval_experiments as ie
from safeopt_tpu.ops.fused_posterior import (_fused_intervals_multi_impl,
                                             _tri_matmul)

BETA = 2.0
BLOCK = 256


def _models(n_obs, cap, seed, n_gps=2, d=2):
    """JAX and port RBF GPs over [-3, 3]^d data and a 1024-point grid (GP
    g's lengthscales 1 and 1 + g in turn, GP 0's all 1)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n_obs, d))
    jgps = []
    for g in range(n_gps):
        Y = (np.exp(-0.5 * np.sum(X ** 2, axis=1)) * (2.0 - g)
             + 0.05 * rng.normal(size=n_obs))[:, None]
        kern = jt.RBF(d, variance=2.0 - 0.5 * g,
                      lengthscale=[1.0 + g * (k % 2) for k in range(d)],
                      ARD=True)
        jgps.append(jt.GPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                    capacity=cap))
    pgps = [gp_from_arrays(kernel_from_params(**kernel_params(g.kern)),
                           **gp_arrays(g), device="cpu") for g in jgps]
    grid = rng.uniform(-5.0, 5.0, size=(4 * BLOCK, d))
    return jgps, pgps, grid


@functools.lru_cache(maxsize=4)
def _gram_models(n_obs, cap, seed, d):
    """``_models`` for B2's and B5's transcription tests: one GP past
    capacity 512 (a build of seconds, kept for the other tests of the
    seed, which only read it), else two."""
    return _models(n_obs, cap, seed, n_gps=1 if cap > 512 else 2, d=d)


def _jax_operands(jgps, grid):
    """K1's operands as the harnesses assemble them (``scal`` = [variance,
    variance, beta, 0])."""
    ils, xs, lm, w, scal = [], [], [], [], []
    cap = jgps[0].state.capacity
    d = grid.shape[1]
    for g in jgps:
        ls = np.broadcast_to(np.asarray(g.kern.lengthscale), (d,))
        ils.append(1.0 / ls)
        xs.append(np.asarray(g.state.X) / ls)
        mask = (np.arange(cap) < int(g.state.count)).astype(float)
        lm.append(np.asarray(g.state.Linv) * mask[None, :])
        w.append(np.asarray(g.state.w))
        v = float(g.kern.variance)
        scal.append([v, v, BETA, 0.0])
    return tuple(jnp.asarray(np.stack(a)) for a in
                 (grid.T, ils, xs, lm, w, scal))


def _port_operands(pgps, grid):
    return pfp.interval_operands([g.kern for g in pgps],
                                 [g.state for g in pgps], torch.tensor(grid),
                                 BETA)


def _k1_jax(jops, three_pass=False):
    out = _fused_intervals_multi_impl(*jops, kind="rbf", block=BLOCK,
                                      num_gps=jops[2].shape[0],
                                      three_pass=three_pass)
    return np.asarray(out)


def _launches(fn):
    """A wrapper's launch counts: its FP32-product and three-pass kernels."""
    return fn.launches, fn.three_pass_launches


def _close(got, want, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


CASES = [(40, 64), (200, 256)]
# B2's sums and B5's modes (one kernel body, d = 1, 2 and 10 at compile
# time) also at the long campaigns' capacities, counts near them (one GP:
# its build takes seconds), and at d = 1 and 10, on the 1024-point grid
GRAM_CASES = ([pytest.param(n, cap, 2, id=f"{n}-{cap}") for n, cap in CASES]
              + [pytest.param(1000, 1024, 2, id="1000-1024"),
                 pytest.param(2000, 2048, 2, id="2000-2048"),
                 pytest.param(40, 64, 1, id="40-64-d1"),
                 pytest.param(200, 256, 10, id="200-256-d10")])
# the three-pass columns also past capacity RESIDENT3_CAP (576), where the
# float32 B2-3p and B3-3p run the tiled body
CASES_3P = ([(n, cap, tp) for n, cap in CASES for tp in (False, True)]
            + [(600, 640, True)])


@pytest.mark.parametrize("three_pass", [False, True])
@pytest.mark.parametrize("n_obs,cap", CASES)
def test_launch_variants_plain_match_pallas(n_obs, cap, three_pass):
    jgps, pgps, grid = _models(n_obs, cap, seed=cap)
    want = _k1_jax(_jax_operands(jgps, grid), three_pass)
    ops = _port_operands(pgps, grid)
    before = _launches(ie.intervals_launch)
    for slices, res, carveout in [(0, 0, -1), (1, 0, 100), (8, 64, 0)]:
        _close(ie.intervals_launch(*ops, slices=slices, res=res,
                                   carveout=carveout, three_pass=three_pass),
               want)
    assert _launches(ie.intervals_launch) == before   # CPU: plain version


def _float32(ops):
    return tuple(o.float() if torch.is_tensor(o) else o for o in ops)


@pytest.mark.parametrize("three_pass", [False, True])
def test_launch_variants_refuse_bad_layouts(three_pass):
    # B1 and the float64 B1-3p: slices and res; groups and stages are the
    # float32 B1-3p's knobs. The float32 B1-3p (K1-3p's wgmma bodies):
    # groups 1 or 3, stages 2 to 4, res a multiple of 32 up to the
    # capacity rounded to 64, no slices; past capacity 576 (the tiled
    # body) stages alone. 0 is K1-3p's own choice of each.
    _, pgps, grid = _models(20, 64, seed=1)
    ops = _port_operands(pgps, grid)
    for kw in (dict(slices=3), dict(slices=16), dict(res=8), dict(res=-16),
               dict(carveout=101), dict(carveout=-2), dict(groups=1),
               dict(stages=2)):
        with pytest.raises(ValueError):
            ie.intervals_launch(*ops, three_pass=three_pass, **kw)
    ops32 = _float32(ops)
    if not three_pass:             # B1 in float32: the same knobs
        with pytest.raises(ValueError, match="float32 B1-3p's knobs"):
            ie.intervals_launch(*ops32, groups=3)
        return
    for kw in (dict(slices=1), dict(slices=8, res=64), dict(groups=2),
               dict(groups=4), dict(stages=1), dict(stages=5),
               dict(res=16), dict(res=-32), dict(res=96), dict(carveout=101)):
        with pytest.raises(ValueError):
            ie.intervals_launch(*ops32, three_pass=True, **kw)
    want = pfp.fused_intervals3_plain(*ops32)
    for kw in (dict(groups=3, stages=4, res=32, carveout=0),
               dict(groups=1, stages=2, res=64), dict(stages=3)):
        assert torch.equal(ie.intervals_launch(*ops32, three_pass=True, **kw),
                           want)
    # past capacity 576: the tiled body takes no groups, no resident rows
    zt, ils, xs, lm, w, scal, kind = ops32
    G, _, d = xs.shape
    big = (zt, ils, xs.new_zeros(G, 640, d), lm.new_zeros(G, 640, 640),
           w.new_zeros(G, 640), scal, kind)
    assert pfp.three_pass_body(640) == "tiled"
    for kw in (dict(groups=3), dict(res=64)):
        with pytest.raises(ValueError, match="tiled body"):
            ie.intervals_launch(*big, three_pass=True, **kw)
    assert ie.intervals_launch(*big, three_pass=True, stages=2).shape == (
        2, 2, grid.shape[0])


# -- B3-3p: bench_interval_mosaic4.py:80-82, 95-113, transcribed --------------

def _hdot(a, b):
    """``hdot`` (:85-90): a product at HIGHEST."""
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=b.dtype)


def _mxu_emit(zt, ils, xs, lm, w, scal, three_pass):
    """``kern_mxu_emit`` (:95-113) on every GP, with the harness's
    prologue (:80-82): ``u`` at HIGHEST, padded to 8 rows, and a row of
    ones."""
    G, cap, d = xs.shape
    u = jnp.einsum("gij,gi->gj", lm, w, precision=jax.lax.Precision.HIGHEST)
    u8 = jnp.zeros((G, 8, cap), zt.dtype).at[:, 0, :].set(u)
    ones8 = jnp.zeros((8, cap), zt.dtype).at[0, :].set(1.0)
    out = []
    for g in range(G):
        r2 = jnp.zeros((cap, zt.shape[1]), zt.dtype)
        for k in range(d):
            diff = xs[g][:, k][:, None] - (zt[k, :] * ils[g, k])[None, :]
            r2 = r2 + diff * diff
        Gm = scal[g, 0] * jnp.exp(-0.5 * r2)
        V = _tri_matmul(lm[g], Gm, zt.dtype, three_pass=three_pass)
        mu = _hdot(u8[g], Gm)[0]
        v2 = _hdot(ones8, V * V)[0]
        var = jnp.maximum(scal[g, 1] - v2, 0.0)
        spread = scal[g, 2] * jnp.sqrt(var)
        out.append([mu - spread, mu + spread])
    return np.asarray(out)


@pytest.mark.parametrize("n_obs,cap,three_pass", CASES_3P)
def test_mu_from_gram_plain_matches_pallas(n_obs, cap, three_pass):
    # B3 against K1 (its function), B3-3p against kern_mxu_emit's 3pass
    # column (its own: mu from the gram, V from the 3-pass product)
    jgps, pgps, grid = _models(n_obs, cap, seed=cap + 1)
    jops = _jax_operands(jgps, grid)
    want = _mxu_emit(*jops, three_pass=True) if three_pass else _k1_jax(jops)
    ops = _port_operands(pgps, grid)
    u = ie.mu_weights(ops[3], ops[4])
    # past the count Lm's columns are zero, so u is too
    for g, jgp in enumerate(jgps):
        assert not u[g, int(jgp.state.count):].any()
    before = _launches(ie.intervals_mu_from_gram)
    _close(ie.intervals_mu_from_gram(*ops, three_pass=three_pass), want)
    assert _launches(ie.intervals_mu_from_gram) == before
    if three_pass:       # the limbs moved the rows: not B3's function
        assert (ie.intervals_mu_from_gram(*ops) - torch.tensor(want)
                ).abs().max().item() > 1e-9


# -- B2: bench_interval_mosaic3.py:86-120, transcribed ------------------------

def _gram_block(g, zt_b, ils, xs, scal):
    """``gram_block`` (:86-94)."""
    variance = scal[g, 0]
    xsg = xs[g]
    r2 = jnp.zeros((xsg.shape[0], zt_b.shape[1]))
    for k in range(zt_b.shape[0]):
        diff = xsg[:, k][:, None] - (zt_b[k, :] * ils[g, k])[None, :]
        r2 = r2 + diff * diff
    return variance * jnp.exp(-0.5 * r2)


def _gram_only(zt, ils, xs, lm, w, scal):
    """``kern_gram_only`` (:96-102)."""
    out = []
    for g in range(xs.shape[0]):
        G = _gram_block(g, zt, ils, xs, scal)
        out.append([jnp.sum(G, axis=0), jnp.sum(G * G, axis=0)])
    return np.asarray(out)


def _solve_only(zt, ils, xs, lm, w, scal, three_pass):
    """``kern_solve_only`` (:104-120)."""
    out = []
    for g in range(xs.shape[0]):
        G = xs[g][:, 0][:, None] * zt[0][None, :]
        V = _tri_matmul(lm[g], G, zt.dtype, three_pass=three_pass)
        mu = jnp.sum(w[g][:, None] * V, axis=0)
        var = jnp.maximum(scal[g, 1] - jnp.sum(V * V, axis=0), 0.0)
        spread = scal[g, 2] * jnp.sqrt(var)
        out.append([mu - spread, mu + spread])
    return np.asarray(out)


def _active(jops, jgps, g):
    """GP g's operands cut to its active rows."""
    zt, ils, xs, lm, w, scal = jops
    n = int(jgps[g].state.count)
    return (zt, ils[g:g + 1], xs[g:g + 1, :n], lm[g:g + 1, :n, :n],
            w[g:g + 1, :n], scal[g:g + 1])


@pytest.mark.parametrize("n_obs,cap,d", GRAM_CASES)
def test_gram_sums_plain_match_transcription(n_obs, cap, d):
    jgps, pgps, grid = _gram_models(n_obs, cap, cap + 2, d)
    jops = _jax_operands(jgps, grid)
    got = ie.interval_ablation(*_port_operands(pgps, grid), "gram_sums")
    for g in range(len(jgps)):
        _close(got[g], _gram_only(*_active(jops, jgps, g))[0])


@pytest.mark.parametrize("n_obs,cap,three_pass", CASES_3P)
def test_rank1_solve_plain_matches_transcription(n_obs, cap, three_pass):
    # over the capacity, as the TPU kernel ran: Lm is zero past the count
    jgps, pgps, grid = _models(n_obs, cap, seed=cap + 3)
    want = _solve_only(*_jax_operands(jgps, grid), three_pass=three_pass)
    before = _launches(ie.interval_ablation)
    _close(ie.interval_ablation(*_port_operands(pgps, grid), "solve_rank1",
                                three_pass=three_pass), want)
    assert _launches(ie.interval_ablation) == before


@pytest.mark.parametrize("mode", ["gram_sums", "no_product", "epilogue"])
def test_ablation_without_a_product_refuses_three_pass(mode):
    _, pgps, grid = _models(20, 64, seed=2)
    ops = _port_operands(pgps, grid)
    meta = tuple(o.to("meta") if torch.is_tensor(o) else o for o in ops)
    for args in (ops, meta):           # before any device is looked at
        with pytest.raises(ValueError, match="three-pass"):
            ie.interval_ablation(*args, mode, three_pass=True)
    with pytest.raises(ValueError, match="three-pass"):
        ie.interval_ablation_plain(*ops, mode, three_pass=True)


# -- B5: bench_interval_ablation.py:49-78, transcribed ------------------------

def _ablation(zt, xs, lm, w, scal, variant):
    """``_kernel`` (:49-78) on one GP (``xs`` and ``zt`` already scaled by
    the lengthscale, as the harness passes them)."""
    kdiag, beta = scal[0, 1], scal[0, 2]
    if variant == "epilogue":
        V = jnp.broadcast_to(zt[0][None, :] * 0.01,
                             (xs.shape[0], zt.shape[1]))
    else:
        r2 = jnp.zeros((xs.shape[0], zt.shape[1]))
        for k in range(zt.shape[0]):
            diff = xs[:, k][:, None] - zt[k, :][None, :]
            r2 = r2 + diff * diff
        kmat = scal[0, 0] * jnp.exp(-0.5 * r2)
        V = kmat if variant == "no_mxu" else _tri_matmul(
            lm, kmat, zt.dtype, three_pass=True)
    mu = jnp.sum(w[0][:, None] * V, axis=0)
    var = jnp.maximum(kdiag - jnp.sum(V * V, axis=0), 0.0)
    spread = beta * jnp.sqrt(var)
    return np.asarray([mu - spread, mu + spread])


@pytest.mark.parametrize("n_obs,cap,d", GRAM_CASES)
@pytest.mark.parametrize("mode,variant", [("no_product", "no_mxu"),
                                          ("epilogue", "epilogue")])
def test_ablation_plain_matches_transcription(n_obs, cap, d, mode, variant):
    # GP 0 has unit lengthscales, so its scaled grid is the raw grid that
    # the epilogue reads
    jgps, pgps, grid = _gram_models(n_obs, cap, cap + 4, d)
    zt, ils, xs, lm, w, scal = _active(_jax_operands(jgps, grid), jgps, 0)
    assert np.all(np.asarray(ils) == 1.0)
    want = _ablation(zt, xs[0], lm[0], w, scal, variant)
    got = ie.interval_ablation(*_port_operands(pgps, grid), mode)
    _close(got[0], want)


# -- B2/B5's gram-only body: its in-order reference and its bound -------------

def test_fma32_rounds_the_exact_sum_once():
    """``_fma32`` rounds a * b + c once, as the card's FMA: 1 + 2^-23 +
    2^-24 (1 - 2^-46) lies just below the tie between 1 + 2^-23 and 1 +
    2^-22, where a float64 sum rounded again to float32 lands."""
    a = torch.tensor([2.0 ** -24 * (1 + 2.0 ** -23)], dtype=torch.float32)
    b = torch.tensor([1 - 2.0 ** -23], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == (
        1 + 2.0 ** -22)
    assert pfp._fma32(a, b, c).item() == 1 + 2.0 ** -23
    assert pfp._fma32(-a, b, -c).item() == -(1 + 2.0 ** -23)
    assert pfp._fma32(a, b, c.double()).item() == 1 + 2.0 ** -23
    # sums that float64 holds exactly pass through
    x = torch.tensor([1.5, -3.0, 0.0], dtype=torch.float32)
    assert torch.equal(pfp._fma32(x, x, x), x * x + x)


@pytest.mark.parametrize("d", [1, 2, 10])
@pytest.mark.parametrize("mode", ["gram_sums", "no_product", "epilogue"])
def test_in_order_sums_lie_within_the_float32_bound(mode, d):
    """``ablation_in_order`` (B2/B5's float32 sums in the kernel's order,
    the bitwise reference of the kernel on the card) within
    ``float32_bound`` of the plain version in float64 on the same
    operands; float64 operands and a mode with a product refuse it."""
    _, pgps, grid = _models(60, 64, seed=11 + d, d=d)
    ops = tuple(o.float() if torch.is_tensor(o) else o
                for o in _port_operands(pgps, grid))
    up = tuple(o.double() if torch.is_tensor(o) else o for o in ops)
    got = ie.ablation_in_order(*ops, mode)
    assert got.dtype == torch.float32
    err = (got.double() - ie.interval_ablation_plain(*up, mode)).abs()
    assert bool((err <= ie.float32_bound(*ops, mode)).all())
    with pytest.raises(TypeError, match="float32"):
        ie.ablation_in_order(*up, mode)
    with pytest.raises(ValueError, match="not a sum"):
        ie.ablation_in_order(*ops, "solve_rank1")


def test_gram_bounds_count_the_mufu():
    """chip_smoke's bounds take the largest of the FP32 pipe's, the
    MUFU's (16 results a clock an SM, 4.18e12 a second) and the bytes'
    time: B2's gram sums at cap 512, G=2, d=2, N=1e6, RBF read 0.191 ms,
    bound by the MUFU, where the FP32 term alone reads 0.1552. A Matern32
    state's plan (``plan_leaves`` of its K2 operands, as chip_smoke's
    callers take it) counts a square root and an exponential an entry."""
    import chip_smoke as cs
    from safeopt_torch import GPRegression, Matern32

    f32, f64, N = torch.float32, torch.float64, 10 ** 6
    assert cs.PEAK_MUFU == pytest.approx(4.18e12, rel=1e-3)
    ms, by = cs.ablation_bound("gram_sums", f32, 2, N, 2, 512, 400)
    assert by == "mufu" and round(ms, 3) == 0.191
    assert ms == pytest.approx(2 * N * 400 / cs.PEAK_MUFU * 1e3)
    fp32 = 2 * N * 400 * (cs.gram_flops(2) + 3) / cs.PEAK_FLOPS[f32] * 1e3
    assert round(fp32, 4) == 0.1552
    # float64's exponential runs on the FP64 pipe
    assert cs.ablation_bound("gram_sums", f64, 2, N, 2, 512, 400)[1] == (
        "operations")
    # K1 stays bound by its product, B5's epilogue by its bytes
    assert cs.interval_bound(f32, 2, N, 2, 512, 400)[1] == "operations"
    assert cs.ablation_bound("epilogue", f32, 1, N, 2, 512, 400)[1] == (
        "bytes")
    # the MUFU term counts in the other bounds too: K3's grams at the
    # flagship
    t_mufu = 2 * 1000 * ((64 + 32) * 1 + 32) / cs.PEAK_MUFU * 1e3
    assert cs.expander_bound(f32, 2, N, 1000, 2, 64, 64, 32)[0] >= t_mufu
    # and the three-pass body's gram of a Matern32 state at count 64
    rng = np.random.default_rng(7)
    X = rng.uniform(-3.0, 3.0, size=(64, 2))
    gp = GPRegression(X, np.sin(X[:, :1]), Matern32(2, lengthscale=1.5),
                      noise_var=0.05 ** 2, capacity=64, device="cpu",
                      dtype=torch.float32)
    ops = pfp.interval_plan_operands(gp.kern, gp.state,
                                     torch.zeros((4, 2)), BETA)
    leaves = cs.plan_leaves(ops[4], ops[6])
    assert leaves == [(1, 2)] and cs.gram_mufu(f32, leaves) == 2
    assert cs.split_bound("bf16", N, 2, 64, 64, leaves=leaves) == (
        pytest.approx((N * (64 * 2 + 1) / cs.PEAK_MUFU * 1e3, "mufu")))
    assert cs.gram_mufu(f32, leaves=[(0, 1), (1, 1), (5, 0)]) == 3
    assert cs.json_bound_by("mufu") == "operations"


# -- B4: bench_interval_variants.py:92-118, its product as _tri_matmul --------

def _split_jax(zt, xs, lm, w, scal):
    """``_kernel`` (:92-118) on one GP, ``_tri3`` as ``_tri_matmul(
    three_pass=True)``."""
    r2 = jnp.zeros((xs.shape[0], zt.shape[1]))
    for k in range(zt.shape[0]):
        diff = xs[:, k][:, None] - zt[k, :][None, :]
        r2 = r2 + diff * diff
    kmat = scal[0, 0] * jnp.exp(-0.5 * r2)
    V = _tri_matmul(lm, kmat, zt.dtype, three_pass=True)
    mu = jnp.sum(w[0][:, None] * V, axis=0)
    var = jnp.maximum(scal[0, 1] - jnp.sum(V * V, axis=0), 0.0)
    spread = scal[0, 2] * jnp.sqrt(var)
    return np.asarray([mu - spread, mu + spread])


def _one(ops, g):
    zt, ils, xs, lm, w, scal, kind = ops
    return zt, ils[g], xs[g], lm[g], w[g], scal[g], kind


@pytest.mark.parametrize("n_obs,cap", CASES)
def test_split_plain_matches_three_pass_product(n_obs, cap):
    jgps, pgps, grid = _models(n_obs, cap, seed=cap + 5)
    zt, ils, xs, lm, w, scal = _jax_operands(jgps, grid)
    ops = _port_operands(pgps, grid)
    for g in range(len(jgps)):
        want = _split_jax(zt * ils[g][:, None], xs[g], lm[g], w[g:g + 1],
                          scal[g:g + 1])
        _close(ie.intervals_split_plain(*_one(ops, g), limb="bf16",
                                        round_lo=False), want)
    before = ie.intervals_split.launches
    _close(ie.intervals_split(*_one(ops, 0)),
           ie.intervals_split_plain(*_one(ops, 0), limb="bf16"), atol=0)
    assert ie.intervals_split.launches == before


@pytest.mark.parametrize("limb,e", [("bf16", 2.0 ** -16),
                                    ("tf32", 2.0 ** -22)])
def test_rounding_lo_moves_the_rows_within_its_bound(limb, e):
    _, pgps, grid = _models(200, 256, seed=9)
    ops = _port_operands(pgps, grid)
    zt, ils, xs, lm, w, scal, kind = _one(ops, 0)
    rounded = ie.intervals_split_plain(*_one(ops, 0), limb=limb)
    exact = ie.intervals_split_plain(*_one(ops, 0), limb=limb,
                                     round_lo=False)
    k = pfp.gram(kind, xs, zt * ils[:, None], scal[0])
    V = lm @ k
    dV = 2 * e * (lm.abs() @ k.abs()) * (1 + 2.0 ** -8)
    dmu = (w.abs()[:, None] * dV).sum(dim=0)
    dq = ((2 * V.abs() + dV) * dV).sum(dim=0)
    sd = torch.clamp(scal[1] - (V * V).sum(dim=0), min=0.0).sqrt()
    bound = dmu + BETA * torch.minimum(dq.sqrt(), dq / sd) + 1e-12
    diff = (rounded - exact).abs()
    assert bool((diff <= bound).all())
    assert diff.max() > 0                  # the rounding does move them


def test_split_limbs_rejoin():
    x = torch.tensor(np.random.default_rng(0).normal(size=4096),
                     dtype=torch.float32)
    for limb, e in (("bf16", 2.0 ** -16), ("tf32", 2.0 ** -22)):
        hi, lo = ie.split_limbs(x, limb, round_lo=False)
        assert torch.equal(hi + lo, x)               # lo = x - hi is exact
        hi, lo = ie.split_limbs(x, limb)
        assert torch.equal(ie.round_limb(lo, limb), lo)
        assert bool(((hi + lo - x).abs() <= e * x.abs()).all())


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def _bits(x):
    return x.numpy().view(np.uint32).tolist()


def test_bf16_limb_rounds_to_nearest_even():
    one = 0x3F800000
    x = _f32([one + 0x8000,            # 1 + 2^-8: tie, to even (1)
              one + 0x18000,           # 1 + 3 2^-8: tie, to even (1 + 2^-6)
              one + 0x8001,            # just past the tie: up
              0x80000000 | one + 0x8000,   # -(1 + 2^-8): to -1
              0x00008000,              # subnormal tie at 2^-134: to 0
              0x00018000,              # subnormal tie: to even (0x20000)
              0x007FFFFF,              # largest subnormal: to 2^-126
              0x7F7FFFFF,              # largest finite: overflows to inf
              0x7F800000, 0xFF800000])     # +-inf stay
    assert _bits(ie.round_limb(x, "bf16")) == [
        one, one + 0x20000, one + 0x10000, 0x80000000 | one, 0, 0x20000,
        0x00800000, 0x7F800000, 0x7F800000, 0xFF800000]


def test_tf32_limb_rounds_to_nearest_away():
    one = 0x3F800000
    x = _f32([one + 0x1000,            # 1 + 2^-11: tie, away (1 + 2^-10)
              one + 0x3000,            # tie again: away (1 + 2^-9)
              one + 0x0FFF,            # just short of the tie: down
              0x80000000 | one + 0x1000,   # -(1 + 2^-11): away from zero
              0x00000001,              # smallest subnormal: to 0
              0x00001000,              # subnormal tie: away (0x2000)
              0x007FFFFF,              # largest subnormal: to 2^-126
              0x7F7FFFFF,              # largest finite: overflows to inf
              0x7F800000, 0xFF800000])     # +-inf stay
    assert _bits(ie.round_limb(x, "tf32")) == [
        one + 0x2000, one + 0x4000, one, 0x80000000 | one + 0x2000, 0,
        0x2000, 0x00800000, 0x7F800000, 0x7F800000, 0xFF800000]
    assert bool(torch.isnan(ie.round_limb(torch.tensor([math.nan]),
                                          "tf32")).all())


def test_kernel_gram_rounds_once_per_column():
    # float32: each column's square joins the distance with one rounding
    # (a fused multiply-add); float64 is the plain gram
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(50, 3)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(3, 70)), dtype=torch.float32)
    r2 = torch.zeros((50, 70), dtype=torch.float32)
    for k in range(3):
        diff = (a[:, k, None] - b[k, None, :]).double()
        r2 = (r2.double() + diff * diff).float()
    var = torch.tensor(1.5, dtype=torch.float32)
    assert torch.equal(ie.kernel_gram(0, a, b, var),
                       var * torch.exp(-0.5 * r2))
    assert torch.equal(ie.kernel_gram(0, a.double(), b.double(), 1.5),
                       pfp.gram(0, a.double(), b.double(), 1.5))


def _unchunk(chunks):
    """(2, pad, pad) hi and lo limbs from B4's chunks (``split_factor``'s
    layout, or ``_cut_landing``'s), each value read where the kernel's
    descriptors address it: element (r, c) of chunk (m, q) at [m, q, limb,
    c // core, r // 8, r % 8, c % core]."""
    mt, qt, _, cg, _, _, core = chunks.shape
    t = chunks.float().permute(2, 0, 4, 5, 1, 3, 6)
    return t.reshape(2, mt * 64, qt * cg * core)


def _cut_landing(landed, limb):
    """The chunks the kernel's ``cut_chunk`` leaves from
    ``factor_landing``'s: each 16-byte core-matrix row's values read from
    that row's own bytes (bf16: its first 4 values at the hi row, its last
    4 at the lo row; tf32: its 4 values at the hi row), cut to (hi, lo) in
    the limb format and written to the hi row and the lo row."""
    if limb == "bf16":
        rows = torch.cat([landed[:, :, 0], landed[:, :, 1]], dim=-1)
    else:
        rows = landed
    limbs = ie.split_limbs(rows, limb)
    if limb == "bf16":
        limbs = [t.to(torch.bfloat16) for t in limbs]
    return torch.stack(limbs, dim=2)


def test_split_factor_pads_and_casts_the_limbs():
    # B4's hoisted limbs: chunks of 64 rows by 32 (bf16) or 16 (tf32)
    # columns, hi then lo, in the core-matrix order; bf16 is K1-3p's
    # factor_chunks. Each entry is split_limbs' bit for bit, zero past
    # the capacity; factor_landing, cut as the kernel cuts it, gives the
    # same chunks (in-kernel == hoisted)
    lm = torch.tensor(np.random.default_rng(4).normal(size=(40, 40)),
                      dtype=torch.float32)
    for limb, dtype in (("bf16", torch.bfloat16), ("tf32", torch.float32)):
        chunks = ie.split_factor(lm, limb)
        kc, core = ie.CHUNK_COLS[limb], ie.CORE_K[limb]
        assert chunks.shape == (1, 64 // kc, 2, kc // core, 8, 8, core)
        assert chunks.dtype == dtype
        assert chunks[0, 0, 0].numel() * chunks.element_size() == 4096
        hi, lo = _unchunk(chunks)
        want = ie.split_limbs(ie.padded_factor(lm), limb)
        assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
        assert not hi[40:].any() and not hi[:, 40:].any()
        landed = ie.factor_landing(lm, limb)
        assert landed.dtype == torch.float32
        assert landed.numel() * 4 == 64 * 64 * 4
        assert torch.equal(_cut_landing(landed, limb), chunks)
    assert torch.equal(ie.split_factor(lm, "bf16"),
                       pfp.factor_chunks(lm[None])[0])


# -- B4's body on the CPU: its chunk order and its summation order -----------
#
# csrc/intervals3.cuh and intervals3_tiled.cuh, the bodies B4 runs: rows
# of a row tile, consumer warpgroups of the resident body past capacity
# 128 (one at and below it), warpgroups of the tiled body (past capacity
# 576, bands of four row tiles aligned to the last one)
TILE, GROUPS, TILED_GROUPS = 64, 3, 4


def _tile_order(n, groups):
    """The resident body's row tiles at count n, largest first, each to
    the warpgroup with less work so far in k16 steps (``for_my_tiles``):
    [(tile, columns, warpgroup)]."""
    load, out = [0] * groups, []
    for m in range(-(-n // TILE) - 1, -1, -1):
        kend = min(TILE * (m + 1), n)
        g = min(range(groups), key=lambda q: (load[q], q))
        load[g] += -(-kend // 16)
        out.append((m, kend, g))
    return out


def _band_order(n):
    """The tiled body's: tile w of each band to warpgroup w, bands in
    order (``band_tile``)."""
    mt = -(-n // TILE)
    shift = TILED_GROUPS * -(-mt // TILED_GROUPS) - mt
    return [(m, min(TILE * (m + 1), n), (m + shift) % TILED_GROUPS)
            for m in range(mt)]


def _b4_order(cap, n):
    if pfp.three_pass_body(cap) == "tiled":
        return _band_order(n)
    return _tile_order(n, 1 if cap <= 128 else GROUPS)


def emulate_split(k, chunks, w, n, kdiag, beta, limb, order, dtype):
    """(2, B) rows of one GP as B4 computes them in ``dtype``: ``k`` (cap,
    B) the kernel's gram, ``chunks`` the factor's limbs as the kernel
    reads them (``split_factor``'s), ``order`` the body's tiles. Per row
    tile and k-step (``MMA_K[limb]`` columns) the three limb products,
    each added exactly to the accumulator and rounded once to ``dtype``;
    in float32 the epilogue in the kernels' order (each thread's two rows,
    a butterfly over a warp's 16, each warp's tiles in its order, the
    warps in order), in float64 ``_epilogue``'s (the plain version's)."""
    f = (lambda x: x.to(dtype))
    B, K = k.shape[1], ie.MMA_K[limb]
    nk = -(-n // 16) * 16
    kg = torch.zeros((nk, B), dtype=k.dtype)
    kg[:n] = k[:n]
    k_hi, k_lo = (t.double() for t in ie.split_limbs(kg, limb))
    a_hi, a_lo = (t.double() for t in _unchunk(chunks))
    wv = torch.zeros(a_hi.shape[0], dtype=dtype)
    wv[:n] = w[:n].to(dtype)
    V = torch.zeros((a_hi.shape[0], B), dtype=dtype)
    red = torch.zeros((2, 4 * TILED_GROUPS, B), dtype=dtype)
    for m, kend, g in order:
        rows = slice(TILE * m, TILE * (m + 1))
        acc = torch.zeros((TILE, B), dtype=dtype)
        for c in range(0, kend, K):
            cols = slice(c, c + K)
            for a, b in ((a_hi, k_hi), (a_hi, k_lo), (a_lo, k_hi)):
                acc = f(acc.double() + a[rows, cols] @ b[cols])
        V[rows] = acc
        for warp in range(4):
            r0 = torch.arange(8) + 16 * warp + TILE * m
            v0, v1 = V[r0], V[r0 + 8]
            mm = f((wv[r0, None] * v0).double()
                   + wv[r0 + 8, None].double() * v1.double())
            qq = f((v0 * v0).double() + v1.double() * v1.double())
            for o in (1, 2, 4):                    # lanes xor 4, 8, 16
                mm = mm + mm[torch.arange(8) ^ o]
                qq = qq + qq[torch.arange(8) ^ o]
            red[0, 4 * g + warp] += mm[0]
            red[1, 4 * g + warp] += qq[0]
    if dtype == torch.float64:
        return ie._epilogue(V[:n], wv[:n], float(kdiag), float(beta))
    mu, q = torch.zeros(B, dtype=dtype), torch.zeros(B, dtype=dtype)
    for v in range(red.shape[1]):
        mu, q = mu + red[0, v], q + red[1, v]
    spread = f(beta) * torch.sqrt(torch.clamp(f(kdiag) - q, min=0.0))
    return torch.stack([mu - spread, mu + spread])


def _dyadic(rng, shape, bits, scale=1.0):
    """Values of ``bits`` significant bits on one grid, in [-scale,
    scale): every sum of products of a few of them is exact in float64."""
    top = 2 ** bits
    return torch.tensor(rng.integers(-top, top, size=shape) / top * scale,
                        dtype=torch.float32)


@pytest.mark.parametrize("limb", ie.LIMBS)
@pytest.mark.parametrize("cap,n", [(64, 50), (200, 173), (640, 601)])
def test_split_emulation_exact_products_match_plain_bitwise(monkeypatch,
                                                            limb, cap, n):
    """B4's chunk order, its cut in the kernel and its k-steps over each
    body's tiles (the resident body with one warpgroup at capacity 64 and
    three at 200, the tiled body at 640) cover exactly the plain
    version's limb products: on operands whose every sum of limb products
    is exact in float64 (values of 13 bits on one grid, so that both
    limbs of each format are nonzero), the emulation's rows in float64
    equal ``intervals_split_plain``'s bit for bit, from the hoisted limbs
    and from the limbs the kernel cuts."""
    rng = np.random.default_rng(cap + n)
    lm = torch.zeros((cap, cap), dtype=torch.float32)
    lm[:n, :n] = torch.tril(_dyadic(rng, (n, n), 13))
    k = _dyadic(rng, (cap, 96), 13).abs()
    w = _dyadic(rng, (cap,), 13)
    # the gram as the kernel computes it, replaced by the exact one
    monkeypatch.setattr(ie, "kernel_gram", lambda *a: k)
    zt = torch.zeros((2, 96), dtype=torch.float32)
    scal = torch.tensor([1.0, 2.0 ** 20, 2.0, n], dtype=torch.float32)
    # float64 operands of the same values: the plain rows unrounded
    ops = (zt, torch.ones(2), torch.zeros((cap, 2)), lm, w, scal, 0)
    want = ie.intervals_split_plain(*(
        t.double() if torch.is_tensor(t) else t for t in ops), limb=limb)
    assert want.dtype == torch.float64
    hoisted = ie.split_factor(lm, limb)
    cut = _cut_landing(ie.factor_landing(lm, limb), limb)
    assert torch.equal(cut, hoisted)
    hi, lo = _unchunk(hoisted)
    assert lo[:n, :n].any() and hi[:n, :n].any()
    got = emulate_split(k, hoisted, w, n, scal[1], scal[2], limb,
                        _b4_order(cap, n), torch.float64)
    assert torch.equal(got, want)
    # a chunk left out is seen
    dropped = hoisted.clone()
    dropped[-(-n // TILE) - 1, 0] = 0
    assert not torch.equal(emulate_split(
        k, dropped, w, n, scal[1], scal[2], limb, _b4_order(cap, n),
        torch.float64), want)


def _b4_state(n_obs, cap, seed, dtype, every):
    """GP 0 of the flagship pair with ``n_obs`` observations from
    ``default_rng(seed)`` in [-4, 4]^2 at ``cap`` (``tools_torch/
    states.py``: chip_smoke's cap-512 state at seed 512, ``measure.py``'s
    cap1024 at 1024), over every ``every``-th point of the 1000 x 1000
    grid on [-5, 5]^2: K1's operands of one GP."""
    import safeopt_torch as pt
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, size=(n_obs, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=n_obs))[:, None]
    gp = pt.GPRegression(X, Y, pt.RBF(2, variance=2.0, lengthscale=1.0),
                         noise_var=0.05 ** 2, capacity=cap, device="cpu",
                         dtype=dtype)
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2, 1000)[::every]
    return pfp.interval_operands([gp.kern], [gp.state],
                                 torch.tensor(grid, dtype=dtype), BETA)


@pytest.mark.parametrize("limb", ie.LIMBS)
@pytest.mark.parametrize("n_obs,cap,seed,every", [(400, 512, 512, 97),
                                                  (600, 1024, 1024, 389)])
def test_split_emulated_order_within_the_float32_bound(limb, n_obs, cap, seed,
                                                       every):
    """B4's float32 order, from the hoisted chunks, on chip_smoke's
    cap-512 state (the resident body) and ``measure.py``'s cap1024 (the
    tiled body): within ``float32_bound(..., "split", limb)`` of
    ``intervals_split_plain``; its scaled error against the float64 rows
    printed beside the plain version's own."""
    one = _one(_b4_state(n_obs, cap, seed, torch.float32, every), 0)
    zt, ils, xs, lm, w, scal, kind = one
    n = int(scal[3])
    k = ie.kernel_gram(kind, xs, zt * ils[:, None], scal[0])
    got = emulate_split(k, ie.split_factor(lm, limb), w, n, scal[1],
                        scal[2], limb, _b4_order(cap, n), torch.float32)
    want = ie.intervals_split_plain(*one, limb=limb).double()
    bound = ie.float32_bound(*one, "split", limb=limb)
    assert ((got.double() - want).abs() / bound).max().item() <= 1.0
    ref = pfp.fused_intervals_plain(*_b4_state(n_obs, cap, seed,
                                               torch.float64, every))[0]
    dq = ((got.double() - ref).abs().max() / math.sqrt(2.0)).item()
    dq_plain = ((want - ref).abs().max() / math.sqrt(2.0)).item()
    print(f"B4 {limb} cap {cap}: emulated scaled |dQ| {dq:.3e}, plain "
          f"{dq_plain:.3e}")
    assert dq <= 2 * dq_plain + 1e-6


# -- B2-3p and B3-3p: the routes, and B3-3p's partition of u . k -------------


class _Library:
    """A stand-in for the kernel library: records each entry called with
    its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("what", ["solve_rank1", "mu_from_gram"])
def test_three_pass_routes_float32_to_the_wgmma_entries(monkeypatch, what):
    # off the CPU, float32 with three_pass goes to the wgmma entries
    # (safeopt_rank1_solve3_f32, safeopt_mu_from_gram3_f32) with the
    # factor as factor_chunks; float64 keeps the FP32 entries with
    # transposed_factor and three_pass 1; float32 without three_pass never
    # passes three_pass 1 to an FP32 entry, which refuses it
    lib, factors = _Library(), []
    monkeypatch.setattr(ie, "_library", lambda: lib)
    monkeypatch.setattr(ie, "_stream", lambda t: None)
    monkeypatch.setattr(ie, "ptr", lambda t: t)
    monkeypatch.setattr(ie, "k1_layout", lambda zt, ils, xs, *rest: (
        xs.shape[0], zt.shape[1], xs.shape[2], xs.shape[1], zt.dtype))
    for name in ("factor_chunks", "transposed_factor"):
        fn = getattr(pfp, name)
        monkeypatch.setattr(ie, name, lambda lm, fn=fn, name=name: (
            factors.append(name), fn(lm))[1])
    _, pgps, grid = _models(20, 64, seed=5)
    ops = _port_operands(pgps, grid)
    if what == "mu_from_gram":
        run, counter = ie.intervals_mu_from_gram, ie.intervals_mu_from_gram
        entry3, entry = "safeopt_mu_from_gram3_f32", (
            "safeopt_intervals_mu_from_gram")
    else:
        run = functools.partial(ie.interval_ablation, mode=what)
        counter = ie.interval_ablation
        entry3, entry = "safeopt_rank1_solve3_f32", (
            "safeopt_interval_ablation")
    for dtype, three_pass in ((torch.float32, True), (torch.float64, True),
                              (torch.float32, False)):
        meta = tuple(o.to("meta", dtype) if torch.is_tensor(o) else o
                     for o in ops)
        before = counter.three_pass_launches
        out = run(*meta, three_pass=three_pass)
        assert out.shape == (2, 2, grid.shape[0]) and out.dtype == dtype
        name, args = lib.calls[-1]
        assert counter.three_pass_launches == before + three_pass
        if dtype == torch.float32 and three_pass:
            assert name == entry3 and factors[-1] == "factor_chunks"
            assert args[2 if what == "solve_rank1" else 3].dtype == (
                torch.bfloat16)
            if what == "mu_from_gram":
                assert args[-2] == 0            # res: K1-3p's layout
            continue
        suffix = "_f32" if dtype == torch.float32 else "_f64"
        assert name == entry + suffix
        assert factors[-1] == "transposed_factor"
        assert args[-2] == int(three_pass)      # three_pass
    if what == "mu_from_gram":
        meta = tuple(o.to("meta") if torch.is_tensor(o) else o
                     for o in _float32(ops))
        ie.intervals_mu_from_gram(*meta, three_pass=True, res=32)
        assert lib.calls[-1][0] == entry3 and lib.calls[-1][1][-2] == 32


def test_mu_from_gram_res_knob_refusals():
    # res is the float32 B3-3p's: a multiple of 32 up to the capacity
    # rounded up to 64, none on the tiled body (past capacity 576) or
    # without three_pass or in float64; every res gives the plain version
    _, pgps, grid = _models(20, 64, seed=6)
    ops = _port_operands(pgps, grid)
    ops32 = _float32(ops)
    for bad in (16, -32, 96):
        with pytest.raises(ValueError, match="multiple of 32"):
            ie.intervals_mu_from_gram(*ops32, three_pass=True, res=bad)
    with pytest.raises(ValueError, match="knob"):
        ie.intervals_mu_from_gram(*ops32, res=32)
    with pytest.raises(ValueError, match="knob"):
        ie.intervals_mu_from_gram(*ops, three_pass=True, res=32)
    zt, ils, xs, lm, w, scal, kind = ops32
    G, _, d = xs.shape
    big = (zt, ils, xs.new_zeros(G, 640, d), lm.new_zeros(G, 640, 640),
           w.new_zeros(G, 640), scal, kind)
    with pytest.raises(ValueError, match="tiled body"):
        ie.intervals_mu_from_gram(*big, three_pass=True, res=64)
    want = ie.intervals_mu_from_gram_plain(*ops32, three_pass=True)
    for res in (0, 32, 64):
        assert torch.equal(ie.intervals_mu_from_gram(
            *ops32, three_pass=True, res=res), want)


# csrc/intervals3.cuh and intervals3_tiled.cuh with Mu (B3-3p): which
# thread adds u[c] k[c] for which column c of which point. Resident body:
# thread ct serves point ct % 64; the kCons = 128 C consumer threads fill
# the resident rows as tasks t = 64 j + p (rows 8 j .. 8 j + 7), thread
# t % kCons; past them warpgroup g computes chunk k0's 32 rows for each
# of its row tiles that reaches it, and adds them in the chunk's diagonal
# tile m = k0 // 64 only, task t to thread 128 g + t % 128. Tiled body:
# thread ct serves point ct % 128; only the last band's steps (96 columns
# each, k8 group g + 4 i of a step to the threads of warpgroup g, task i)
# add. A point's sum is its threads' registers added in thread order.
CORE = 8


def _resident_mu_tasks(n, cap, res=0, every_tile=False):
    """{thread: [(row, point) in the order it adds them]} of the resident
    body with Mu at count n, ``res`` resident rows (0: every row, the
    default layout up to capacity 576); ``every_tile``: a faulty body that
    adds a chunk's u k in each row tile that reaches it."""
    groups = 1 if cap <= 128 else GROUPS
    cons = 128 * groups
    pad = -(-cap // TILE) * TILE
    res = res or pad
    nk = -(-n // 16) * 16
    rows = min(nk, res)
    adds = {}
    for t in range(rows // CORE * TILE):
        j, p = divmod(t, TILE)
        for r in range(CORE * j, CORE * j + CORE):
            if r < n:
                adds.setdefault(t % cons, []).append((r, p))
    for m, kend, g in _tile_order(n, groups):
        for k0 in range(0, kend, 32):
            if k0 < res or (m != k0 // TILE and not every_tile):
                continue
            for t in range(32 // CORE * TILE):
                j, p = divmod(t, TILE)
                for r in range(k0 + CORE * j, k0 + CORE * j + CORE):
                    if r < n:
                        adds.setdefault(128 * g + t % 128, []).append((r, p))
    return adds, TILE


def _tiled_mu_tasks(n):
    """The same for the tiled body: the last band's steps (its columns end
    at n), each step's 12 k8 groups, group g + 4 i to warpgroup g's
    threads as task i."""
    P, adds = 128, {}
    for step in range(-(-n // 96)):
        for ct in range(128 * TILED_GROUPS):
            g, p = divmod(ct, P)
            for i in range(3):
                r0 = 96 * step + CORE * (g + TILED_GROUPS * i)
                for r in range(r0, r0 + CORE):
                    if r < n:
                        adds.setdefault(ct, []).append((r, p))
    return adds, P


def _mu_from_tasks(adds, P, u, k):
    """(P,) mu of each point as the kernel adds it, in float64: each
    thread's register over its (row, point) in order, then a point's
    threads in thread order."""
    mu = torch.zeros(P, dtype=torch.float64)
    for ct in sorted(adds):
        reg = {}
        for r, p in adds[ct]:
            reg[p] = reg.get(p, 0.0) + float(u[r]) * float(k[r, p])
        for p, v in reg.items():
            assert p == ct % P
            mu[p] += v
    return mu


@pytest.mark.parametrize("cap,n,res", [(64, 50, 0), (64, 50, 32),
                                       (200, 173, 0), (200, 173, 64),
                                       (512, 400, 0), (512, 400, 256),
                                       (512, 7, 480), (576, 576, 0),
                                       (640, 601, None), (2048, 1200, None),
                                       (1024, 40, None)])
def test_mu_partition_adds_every_active_column_once(cap, n, res):
    """B3-3p's partition of u . k over the threads, on the resident body
    (one warpgroup at capacity 64, three past 128; every row resident,
    or ``res`` rows and the chunks past them) and the tiled body (past
    capacity 576, ``res`` None): every point gets each active column
    exactly once, from threads that serve it, and the sum in the kernel's
    grouping equals u @ k within 1e-12. Adding u k in every row tile that
    reaches a chunk (not its diagonal one alone) is seen."""
    tiled = res is None
    assert (pfp.three_pass_body(cap) == "tiled") == tiled
    adds, P = _tiled_mu_tasks(n) if tiled else _resident_mu_tasks(n, cap,
                                                                  res)
    seen = {}
    for ct, pairs in adds.items():
        for r, p in pairs:
            seen[(r, p)] = seen.get((r, p), 0) + 1
    assert seen == {(r, p): 1 for r in range(n) for p in range(P)}
    rng = np.random.default_rng(cap + n)
    u = torch.tensor(rng.normal(size=n))
    k = torch.tensor(rng.uniform(0.0, 2.0, size=(n, P)))
    got = _mu_from_tasks(adds, P, u, k)
    np.testing.assert_allclose(got.numpy(), (u @ k).numpy(), rtol=0,
                               atol=1e-12)
    if not tiled:
        # a chunk's gram past res is computed by every tile reaching it:
        # adding it in each counts a column twice wherever a tile past the
        # chunk's diagonal one reaches it
        faulty, _ = _resident_mu_tasks(n, cap, res, every_tile=True)
        counts = {}
        for pairs in faulty.values():
            for rp in pairs:
                counts[rp] = counts.get(rp, 0) + 1
        below = bool(res) and res < n and -(-n // TILE) - 1 > res // TILE
        assert any(c > 1 for c in counts.values()) == below


# -- float32_bound: holds a float32 run, sees a dropped band -------------------

def _float32_ops(seed):
    """K1's operands of two GPs (200 observations, capacity 256) in
    float32, and the same values in float64."""
    _, pgps, grid = _models(200, 256, seed=seed)
    ops32 = tuple(o.float() if torch.is_tensor(o) else o
                  for o in _port_operands(pgps, grid))
    return ops32, tuple(o.double() if torch.is_tensor(o) else o
                        for o in ops32)


@pytest.mark.parametrize("what", ["gram_sums", "solve_rank1", "no_product",
                                  "epilogue", "mu_from_gram"])
def test_float32_bound_holds_a_float32_run_and_sees_a_dropped_band(what):
    ops32, up = _float32_ops(seed=11)
    plain = (ie.intervals_mu_from_gram_plain if what == "mu_from_gram"
             else functools.partial(ie.interval_ablation_plain, mode=what))
    want = plain(*up)
    bound = ie.float32_bound(*ops32, what)
    assert bool(((plain(*ops32).double() - want).abs() <= bound).all())
    fault = (plain(*ie.drop_band(up, what)) - want).abs()
    assert (fault / bound).max().item() > 1.0


@pytest.mark.parametrize("limb", ie.LIMBS)
def test_float32_bound_sees_a_dropped_band_of_the_split_product(limb):
    # each GP's first and its last 32 active rows
    ops32, _ = _float32_ops(seed=12)
    for g in range(2):
        one = _one(ops32, g)
        want = ie.intervals_split_plain(*one, limb=limb).double()
        bound = ie.float32_bound(*one, "split", limb=limb)
        for first in (True, False):
            fault = (ie.intervals_split_plain(
                *ie.drop_band(one, "split", first), limb=limb).double()
                - want).abs()
            assert (fault / bound).max().item() > 1.0, (g, first)


@pytest.mark.parametrize("limb", ie.LIMBS)
def test_split_error_counts_each_rows_steps(limb):
    """The three-pass product's |dV| bound (``_split_error``): a row's
    k-steps run to its tile's end, each rounding within the running sum:
    at most the per-step worst case over all n columns, (6 ceil(n / K) +
    2) u |Lm| |k|, and for the first tile's rows far below it."""
    rng = np.random.default_rng(21)
    n, K = 300, ie.MMA_K[limb]
    La = torch.tensor(np.tril(rng.uniform(0.5, 1.0, size=(n, n))))
    ka = torch.tensor(rng.uniform(0.5, 1.0, size=(n, 7)))
    A = La @ ka
    dV = ie._split_error(La, ka, n, limb)
    worst = (6 * -(-n // K) + 2) * ie.U32 * A
    assert bool((dV <= worst).all())
    assert (dV[:64] / worst[:64]).max().item() < 0.25
    # row r's own steps and running sums, summed step by step
    r = 200
    steps = -(-min(64 * (r // 64 + 1), n) // K)
    running = sum((La[r, :K * (j + 1)] @ ka[:K * (j + 1)])
                  for j in range(steps))
    assert torch.allclose(dV[r], ie.U32 * (6 * running + 2 * A[r]),
                          rtol=1e-12)


@pytest.mark.parametrize("what", ["solve_rank1", "mu_from_gram"])
def test_three_pass_float32_bound_sees_a_dropped_band(what):
    """B2-3p's and B3-3p's float32 bound: a plain version that drops each
    GP's first or last 32 active rows of Lm lands past it."""
    ops32, _ = _float32_ops(seed=14)
    plain = (functools.partial(ie.intervals_mu_from_gram_plain,
                               three_pass=True) if what == "mu_from_gram"
             else functools.partial(ie.interval_ablation_plain,
                                    mode=what, three_pass=True))
    want = plain(*ops32).double()
    bound = ie.float32_bound(*ops32, what, three_pass=True)
    assert bound.shape == want.shape
    for first in (True, False):
        fault = (plain(*ie.drop_band(ops32, what, first)).double()
                 - want).abs()
        assert (fault / bound).max().item() > 1.0, first
    with pytest.raises(ValueError, match="three-pass"):
        ie.float32_bound(*ops32, "gram_sums", three_pass=True)


@pytest.mark.parametrize("first", [True, False])
def test_float32_bound_plan_sees_a_dropped_band(first):
    """K2-3p's float32 bound against a plain version that drops the GP's
    first (last) 32 active rows of Lm (``drop_band`` on K2's operands):
    past the bound somewhere, and only those rows of Lm zeroed."""
    import safeopt_torch as pt
    rng = np.random.default_rng(13)
    X = np.hstack([rng.uniform(-3.0, 3.0, size=(60, 1)), np.zeros((60, 1))])
    Y = np.exp(-0.5 * X[:, :1] ** 2)
    kern = (pt.RBF(1, variance=2.0, active_dims=[0])
            * pt.RBF(1, lengthscale=1.5, active_dims=[1]))
    gp = pt.GPRegression(X, Y, kern, noise_var=0.05 ** 2, capacity=64,
                         device="cpu", dtype=torch.float32)
    grid = torch.tensor(rng.uniform(-3.0, 3.0, size=(500, 2)),
                        dtype=torch.float32)
    ops = pfp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    faulty = ie.drop_band(ops, "split", first)
    rows = slice(0, 32) if first else slice(28, 60)
    kept = torch.ones(64, dtype=torch.bool)
    kept[rows] = False
    assert not faulty[2][rows].any()
    assert torch.equal(faulty[2][kept], ops[2][kept])
    want = pfp.fused_intervals_plan3_plain(*ops).double()
    fault = (pfp.fused_intervals_plan3_plain(*faulty).double() - want).abs()
    assert (fault / ie.float32_bound_plan(*ops)).max().item() > 1.0


@pytest.mark.parametrize("first", [True, False])
def test_float32_bound_plan_of_k2_sees_a_dropped_band(first):
    """K2's own float32 bound (``limb=None``: V in FMA chains of n
    products) against ``plan_rows_on_kernel_gram``, K2's function in
    float64 on the float32 kernel's gram: the float32 plain version lies
    within it, and a version that drops the GP's first (last) 32 active
    rows of Lm lands past it."""
    import safeopt_torch as pt
    rng = np.random.default_rng(17)
    X = np.hstack([rng.uniform(-3.0, 3.0, size=(60, 1)),
                   rng.uniform(-1.0, 1.0, size=(60, 1))])
    Y = np.exp(-0.5 * X[:, :1] ** 2)
    kern = (pt.RBF(1, variance=2.0, active_dims=[0])
            * pt.RBF(1, lengthscale=1.5, active_dims=[1]))
    gp = pt.GPRegression(X, Y, kern, noise_var=0.05 ** 2, capacity=64,
                         device="cpu", dtype=torch.float32)
    grid = torch.tensor(rng.uniform(-3.0, 3.0, size=(500, 2)),
                        dtype=torch.float32)
    ops = pfp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    bound = ie.float32_bound_plan(*ops, limb=None)
    want = ie.plan_rows_on_kernel_gram(*ops)
    assert want.dtype == torch.float64 and bound.shape == want.shape
    got = pfp.fused_intervals_plan_plain(*ops).double()
    assert ((got - want).abs() / bound).max().item() <= 1.0
    fault = (ie.plan_rows_on_kernel_gram(*ie.drop_band(ops, "split", first))
             - want).abs()
    assert (fault / bound).max().item() > 1.0


def test_padded_factor():
    # to whole row tiles of 64: a capacity that is one already passes as
    # it is
    lm = torch.arange(40 * 40, dtype=torch.float32).reshape(40, 40)
    p = ie.padded_factor(lm)
    assert p.shape == (64, 64) and torch.equal(p[:40, :40], lm)
    assert not p[40:].any() and not p[:, 40:].any()
    assert ie.padded_factor(p).data_ptr() == p.data_ptr()
    assert ie.padded_factor(lm[:32, :32]).shape == (64, 64)


def test_wrappers_raise_off_cpu_and_cuda():
    _, pgps, grid = _models(20, 64, seed=2)
    ops = _port_operands(pgps, grid)
    meta = tuple(o.to("meta") if torch.is_tensor(o) else o for o in ops)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ie.intervals_launch(*meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ie.interval_ablation(*meta, "gram_sums")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ie.intervals_mu_from_gram(*meta)
    for three_pass in (False, True):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            ie.intervals_launch(*meta, three_pass=three_pass)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            ie.interval_ablation(*meta, "solve_rank1", three_pass=three_pass)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            ie.intervals_mu_from_gram(*meta, three_pass=three_pass)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ie.intervals_split(*_one(meta, 0))
    with pytest.raises(ValueError, match="ablation"):
        ie.interval_ablation(*ops, "no_gram")
    with pytest.raises(ValueError, match="limb"):
        ie.intervals_split(*_one(ops, 0), limb="fp16")

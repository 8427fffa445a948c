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


def _models(n_obs, cap, seed, n_gps=2):
    """JAX and port RBF GPs over [-3, 3]^2 data and a 1024-point grid."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n_obs, 2))
    jgps = []
    for g in range(n_gps):
        Y = (np.exp(-0.5 * np.sum(X ** 2, axis=1)) * (2.0 - g)
             + 0.05 * rng.normal(size=n_obs))[:, None]
        kern = jt.RBF(2, variance=2.0 - 0.5 * g, lengthscale=[1.0, 1.0 + g],
                      ARD=True)
        jgps.append(jt.GPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                    capacity=cap))
    pgps = [gp_from_arrays(kernel_from_params(**kernel_params(g.kern)),
                           **gp_arrays(g), device="cpu") for g in jgps]
    grid = rng.uniform(-5.0, 5.0, size=(4 * BLOCK, 2))
    return jgps, pgps, grid


def _jax_operands(jgps, grid):
    """K1's operands as the harnesses assemble them (``scal`` = [variance,
    variance, beta, 0])."""
    ils, xs, lm, w, scal = [], [], [], [], []
    cap = jgps[0].state.capacity
    for g in jgps:
        ls = np.broadcast_to(np.asarray(g.kern.lengthscale), (2,))
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


@pytest.mark.parametrize("three_pass", [False, True])
def test_launch_variants_refuse_bad_layouts(three_pass):
    _, pgps, grid = _models(20, 64, seed=1)
    ops = _port_operands(pgps, grid)
    for kw in (dict(slices=3), dict(slices=16), dict(res=8), dict(res=-16),
               dict(carveout=101), dict(carveout=-2)):
        with pytest.raises(ValueError):
            ie.intervals_launch(*ops, three_pass=three_pass, **kw)


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


@pytest.mark.parametrize("three_pass", [False, True])
@pytest.mark.parametrize("n_obs,cap", CASES)
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


@pytest.mark.parametrize("n_obs,cap", CASES)
def test_gram_sums_plain_match_transcription(n_obs, cap):
    jgps, pgps, grid = _models(n_obs, cap, seed=cap + 2)
    jops = _jax_operands(jgps, grid)
    got = ie.interval_ablation(*_port_operands(pgps, grid), "gram_sums")
    for g in range(len(jgps)):
        _close(got[g], _gram_only(*_active(jops, jgps, g))[0])


@pytest.mark.parametrize("three_pass", [False, True])
@pytest.mark.parametrize("n_obs,cap", CASES)
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


@pytest.mark.parametrize("n_obs,cap", CASES)
@pytest.mark.parametrize("mode,variant", [("no_product", "no_mxu"),
                                          ("epilogue", "epilogue")])
def test_ablation_plain_matches_transcription(n_obs, cap, mode, variant):
    # GP 0 has unit lengthscales, so its scaled grid is the raw grid that
    # the epilogue reads
    jgps, pgps, grid = _models(n_obs, cap, seed=cap + 4)
    zt, ils, xs, lm, w, scal = _active(_jax_operands(jgps, grid), jgps, 0)
    assert np.all(np.asarray(ils) == 1.0)
    want = _ablation(zt, xs[0], lm[0], w, scal, variant)
    got = ie.interval_ablation(*_port_operands(pgps, grid), mode)
    _close(got[0], want)


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


def test_split_factor_pads_and_casts_the_limbs():
    lm = torch.tensor(np.random.default_rng(4).normal(size=(40, 40)),
                      dtype=torch.float32)
    for limb, dtype in (("bf16", torch.bfloat16), ("tf32", torch.float32)):
        hi, lo = ie.split_factor(lm, limb)
        assert hi.shape == lo.shape == (64, 64)
        assert hi.dtype == lo.dtype == dtype
        want = ie.split_limbs(ie.padded_factor(lm), limb)
        assert torch.equal(hi.float(), want[0])
        assert torch.equal(lo.float(), want[1])


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
    ops32, _ = _float32_ops(seed=12)
    for g in range(2):
        one = _one(ops32, g)
        want = ie.intervals_split_plain(*one, limb=limb).double()
        bound = ie.float32_bound(*one, "split", limb=limb)
        fault = (ie.intervals_split_plain(*ie.drop_band(one, "split"),
                                          limb=limb).double() - want).abs()
        assert (fault / bound).max().item() > 1.0


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


def test_padded_factor():
    lm = torch.arange(40 * 40, dtype=torch.float32).reshape(40, 40)
    p = ie.padded_factor(lm)
    assert p.shape == (64, 64) and torch.equal(p[:40, :40], lm)
    assert not p[40:].any() and not p[:, 40:].any()
    assert ie.padded_factor(lm[:32, :32]).shape == (32, 32)


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

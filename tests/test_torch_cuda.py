"""K1-K4 and the exact top-k on the card, against their plain versions.

Needs an NVIDIA GPU with ``nvcc``: every test is marked ``gpu`` and
skips when ``torch.cuda.is_available()`` is false. Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports jax, which the card's machine need not have).

Tolerances: in float64 the kernel and the plain version differ only in
summation order, so intervals agree to 1e-9 and predicates exactly. In
float32 the intervals are held against the float64 plain version to
1e-3 (f32 round-off through factors with entries up to ~1e2 at these
sizes), and decisions must agree outside a 1e-3 band. K3 runs at
thresholds raised far enough that its plain predicate is false for some
candidates, and with a padding slot that must come back false; K4
likewise, and both tests assert that the plain predicate was mixed.
The K1/K2 cases past the resident gram, far below capacity and with
unequal counts check float32 by its decisions: no ``l > fmin`` decision
differs from the float64 plain one outside a band of 1e-3 times the
prior std (fmin at two quantiles of l). The K3/K4 cases past the
resident M2, far below capacity, with several candidate passes and (K3)
unequal counts in one launch hold the kernel against the float64 plain
predicate: identical in float64, differing in float32 only where the
plain one changes within 1e-3 of the threshold. K1-3p and K2-3p agree
with their plain versions to 1e-9 in float64 and, in float32, within the
worst-case bound of their arithmetic (``float32_bound(..., "split")``,
``float32_bound_plan``) on the same operands. So do the experiment
kernels' three-pass forms B2-3p and B3-3p (``float32_bound(...,
three_pass=True)``), which in float32 run K1-3p's wgmma bodies (named by
the profiler, resident to capacity 576 and tiled past it; B3-3p also
with resident gram rows short of the capacity), give the same bits
twice and sit at the tiled capacities within 1e-9 in float64; their FP32
entries refuse ``three_pass`` in float32. B1-3p runs K1-3p's bodies at
the caller's layout:
it gives K1-3p's bits at every layout that keeps K1-3p's summation order
and lies within the split bound of K1-3p's plain version at the others.
B4 runs them in bf16 and tf32 limbs, cut in the kernel or hoisted (the
same bits; in bf16 hoisted K1-3p's own for the GP), within the split
bound of its plain version, through the tiled body past capacity 576.
The float32 K1-3p and K2-3p (``csrc/fused_intervals3.cu``) give the same
bits on every launch, take grids of any length and capacities past the
resident gram, and their SASS holds HGMMA; past capacity 576 they run the
tiled body (``fused_posterior.three_pass_body``, checked by kernel name),
held at capacities 640 to 2048, counts that are no multiple of a row
tile, a small count at a large capacity, unequal counts in one launch and
the wide plan. B2's gram sums and B5's
no-product and epilogue modes run one gram-only body
(``csrc/gram_rows.cuh``) at widths 1, 2, 10 and 64, every stationary
kind, counts 0 to 2000 and capacities to 2048, held against the plain
version (float64 1e-9; float32 RBF within ``float32_bound``, the other
kinds within 1e-4 (|.| + 1)) and, in float32 RBF, bit for bit against
the in-order sums of ``kernel_gram``'s entries (``ablation_in_order``).
K1-K4's ``torch.library``
operators give their launchers' bits and count their launches, and a
step exported and loaded on the card gives the live step's bits,
launching K1 once and K3 once a walk round.
"""

import math
import time

import numpy as np
import pytest
import torch

import safeopt_torch as pt
from safeopt_torch.algorithms import safe_opt_core as core
from safeopt_torch.ops import fused_expander as fe
from safeopt_torch.ops import fused_posterior as fp
from safeopt_torch.ops.topk import top_k

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gps(family, n_gps, cap, device, dtype, n_obs=20, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_obs, 2))
    gps = []
    for g in range(n_gps):
        Y = (1.0 - 0.2 * g + np.cos(X.sum(axis=1))
             + 0.05 * rng.normal(size=n_obs))[:, None]
        kern = getattr(pt, family)(2, variance=1.0 + 0.5 * g,
                                   lengthscale=[0.8 + 0.3 * g, 1.3],
                                   ARD=True)
        gps.append(pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=cap,
                                   device=device, dtype=dtype))
    grid = torch.tensor(rng.uniform(-3.0, 3.0, size=(5000, 2)),
                        dtype=dtype, device=device)
    return gps, grid


# capacities below, at and above one row tile, and one (100) that is no
# multiple of the kernels' 32-row chunks
CASES = [("RBF", 2, 64), ("Matern32", 1, 32), ("Matern52", 3, 128),
         ("Exponential", 2, 512), ("RBF", 1, 100)]


@pytest.mark.parametrize("family,n_gps,cap", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_intervals_kernel_matches_plain(cuda, family, n_gps, cap, dtype):
    gps, grid = _gps(family, n_gps, cap, cuda, dtype)
    ops = fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                               grid, 2.0)
    out = fp.fused_intervals(*ops)
    torch.cuda.synchronize()
    ref = fp.fused_intervals_plain(*[o.double() if torch.is_tensor(o)
                                     else o for o in ops])
    err = (out.double() - ref).abs().max().item()
    assert err <= (1e-9 if dtype == torch.float64 else 1e-3), err


@pytest.mark.parametrize("family,n_gps,cap", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_expander_kernel_matches_plain(cuda, family, n_gps, cap, dtype):
    gps, grid = _gps(family, n_gps, cap, cuda, dtype)
    kerns, states = [g.kern for g in gps], [g.state for g in gps]
    fmin = torch.tensor([0.4, 0.6, 0.5][:n_gps], dtype=dtype, device=cuda)
    beta = 2.0
    out = fp.fused_intervals_plain(*fp.interval_operands(kerns, states, grid,
                                                         beta))
    l, u = out[:, 0], out[:, 1]
    mu, sigma = (l + u) / 2, (u - l) / (2 * beta)
    safe = torch.all(l > fmin[:, None], dim=0)
    assert bool(safe.any()) and bool((~safe).any())
    # 37 candidates (two candidate tiles) spread over the safe set; the
    # last slot is padding
    safe_idx = torch.nonzero(safe).squeeze(1)
    cand = safe_idx[torch.linspace(0, safe_idx.numel() - 1, 37,
                                   device=cuda).long()]
    valid = torch.ones(cand.numel(), dtype=torch.bool, device=cuda)
    valid[-1] = False
    ops = fe.expander_operands(kerns, states, grid, ~safe, mu, sigma,
                               grid[cand], u[:, cand], valid, beta, fmin)

    def at(shift):       # the operands with every fmin raised by ``shift``
        scal = ops[9].clone()
        scal[:, 3] += shift
        return ops[:9] + (scal, ops[10])

    seen = set()
    # raised thresholds turn some predicates false
    for shift in (0.0, 0.3, 1.0):
        got = fe.fused_expander(*at(shift))
        want = fe.fused_expander_plain(*at(shift))
        torch.cuda.synchronize()
        assert not bool(got[:, -1].any())               # the padding slot
        seen.update(want[:, :-1].flatten().tolist())
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            # f32: the same operands, only summation order differs, so a
            # predicate may flip only where the plain one changes within
            # 1e-3 of the threshold
            decided = (fe.fused_expander_plain(*at(shift - 1e-3))
                       == fe.fused_expander_plain(*at(shift + 1e-3)))
            assert not bool(((got != want) & decided).any())
    assert seen == {True, False}


def _product_of(n_leaves, d=2):
    kern = pt.RBF(d, lengthscale=3.0)
    for _ in range(n_leaves - 1):
        kern = kern * pt.RBF(d, lengthscale=3.0)
    return kern


def _algebra_gp(name, cap, device, dtype, n_obs=40, seed=1):
    """One GP with a kernel algebra over 2 columns (K2/K4)."""
    kern = {
        "context": lambda: (pt.RBF(1, variance=2.0, active_dims=[0])
                            * pt.RBF(1, variance=1.0, lengthscale=1.5,
                                     active_dims=[1])),
        "sum_bias": lambda: (pt.RBF(2, variance=1.5, lengthscale=[0.8, 1.2],
                                    ARD=True) + pt.Bias(2, variance=0.5)),
        "cosine": lambda: (pt.Cosine(1, lengthscale=2.0, active_dims=[1])
                           * pt.Matern52(1, variance=1.5, active_dims=[0])),
        # one leaf past the plan K2/K4 stage in static shared memory: their
        # wide instances
        "nine": lambda: _product_of(fp.MAX_LEAVES + 1),
    }[name]()
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_obs, 2))
    Y = (1.0 + np.cos(X.sum(axis=1)) + 0.05 * rng.normal(size=n_obs))[:, None]
    gp = pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=cap,
                         device=device, dtype=dtype)
    grid = torch.tensor(rng.uniform(-3.0, 3.0, size=(5000, 2)), dtype=dtype,
                        device=device)
    return gp, grid


PLAN_CASES = [("context", 64), ("sum_bias", 100), ("cosine", 256),
              ("nine", 64)]


@pytest.mark.parametrize("name,cap", PLAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_intervals_kernel_matches_plain(cuda, name, cap, dtype):
    gp, grid = _algebra_gp(name, cap, cuda, dtype)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    before = fp.fused_intervals_plan.launches
    out = fp.fused_intervals_plan(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals_plan.launches == before + 1
    ref = fp.fused_intervals_plan_plain(*[o.double() if o.is_floating_point()
                                          else o for o in ops])
    err = (out.double() - ref).abs().max().item()
    assert err <= (1e-9 if dtype == torch.float64 else 1e-3), err


@pytest.mark.parametrize("name,cap", PLAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_expander_kernel_matches_plain(cuda, name, cap, dtype):
    gp, grid = _algebra_gp(name, cap, cuda, dtype)
    beta = 2.0
    out = fp.fused_intervals_plan_plain(*fp.interval_plan_operands(
        gp.kern, gp.state, grid, beta))
    l, u = out[0], out[1]
    mu, sigma = (l + u) / 2, (u - l) / (2 * beta)
    fmin = torch.quantile(l.double(), 0.4).to(dtype)
    safe = l > fmin
    safe_idx = torch.nonzero(safe).squeeze(1)
    cand = safe_idx[torch.linspace(0, safe_idx.numel() - 1, 37,
                                   device=cuda).long()]
    valid = torch.ones(cand.numel(), dtype=torch.bool, device=cuda)
    valid[-1] = False
    ops = fe.expander_plan_operands(gp.kern, gp.state, grid, ~safe, mu,
                                    sigma, grid[cand], u[cand], valid, beta,
                                    fmin)

    def at(shift):       # the operands with fmin raised by ``shift``
        scal = ops[11].clone()
        scal[3] += shift
        return ops[:11] + (scal,)

    seen = set()
    for shift in (0.0, 0.3, 1.0):
        got = fe.fused_expander_plan(*at(shift))
        want = fe.fused_expander_plan_plain(*at(shift))
        torch.cuda.synchronize()
        assert not bool(got[-1])                        # the padding slot
        seen.update(want[:-1].tolist())
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            decided = (fe.fused_expander_plan_plain(*at(shift - 1e-3))
                       == fe.fused_expander_plan_plain(*at(shift + 1e-3)))
            assert not bool(((got != want) & decided).any())
    assert seen == {True, False}


def _decisions_differ(out, ref, kdiag, band=1e-3):
    """Rows of ``out`` (float32) whose ``l > fmin`` decision differs from
    the float64 plain ``ref`` where the plain margin, scaled by the prior
    std, exceeds ``band``; fmin at the 30 % and 60 % quantiles of l."""
    wrong = 0
    l32, l64 = out[0].double(), ref[0]
    for q in (0.3, 0.6):
        fmin = torch.quantile(l64[::7], q)
        outside = ((l64 - fmin) / kdiag ** 0.5).abs() > band
        wrong += int((((l32 > fmin) != (l64 > fmin)) & outside).sum())
    return wrong


def _check_rows(out, ref, dtype, kdiag):
    if dtype == torch.float64:
        err = (out - ref).abs().max().item()
        assert err <= 1e-9, err
    else:
        assert bool(torch.isfinite(out).all())
        assert _decisions_differ(out, ref, kdiag) == 0


# K1 and K2 past their resident gram (capacity 1024; float64 already at
# 512), past the 32 bands a block adds at once (1100 rows at capacity
# 2048), far below capacity, at counts that are no multiple of 32, at
# capacities whose last band reaches past cap (100) or whose factor rows
# are not 16-byte aligned (50 in float32), and (K1) GPs of different
# counts in one launch. K1's tiled body (past the resident rows) at the
# exact GP's 2000 of 2048, at counts that are no multiple of its 256-row
# tiles, 16-column steps or 32-row warps (1999, 1025), and two GPs of
# counts 300 and 1500 in one launch
ACTIVE_CASES = [((600,), 1024), ((1100,), 2048), ((400,), 512),
                ((20,), 512), ((77, 45), 128), ((20, 300), 512),
                ((97,), 100), ((47, 45), 50), ((2000,), 2048),
                ((1999,), 2048), ((1025,), 2048), ((300, 1500), 2048)]


@pytest.mark.parametrize("counts,cap", ACTIVE_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_intervals_kernel_active_rows(cuda, counts, cap, dtype):
    rng = np.random.default_rng(sum(counts) + cap)
    gps = []
    for g, n in enumerate(counts):
        X = rng.uniform(-4.0, 4.0, size=(n, 2))
        Y = (np.cos(X.sum(axis=1)) + 0.05 * rng.normal(size=n))[:, None]
        kern = pt.RBF(2, variance=1.0 + 0.5 * g, lengthscale=[0.8 + 0.3 * g,
                                                              1.3], ARD=True)
        gps.append(pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=cap,
                                   device=cuda, dtype=dtype))
    grid = torch.tensor(rng.uniform(-5.0, 5.0, size=(20000, 2)), dtype=dtype,
                        device=cuda)
    ops = fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                               grid, 2.0)
    assert ops[5][:, 3].tolist() == list(counts)
    before = fp.fused_intervals.launches
    out = fp.fused_intervals(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals.launches == before + 1
    ref = fp.fused_intervals_plain(*[o.double() if torch.is_tensor(o)
                                     else o for o in ops])
    for g in range(len(counts)):
        _check_rows(out[g], ref[g], dtype, ops[5][g, 1].item())


def _one_gp(n, cap, device, dtype, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, size=(n, 2))
    Y = (np.cos(X.sum(axis=1)) + 0.05 * rng.normal(size=n))[:, None]
    kern = pt.RBF(2, variance=1.5, lengthscale=[0.9, 1.3], ARD=True)
    return pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=cap,
                           device=device, dtype=dtype), rng


# K1's tiled body on grids whose length is no multiple of its 64 points a
# block, down to one point
@pytest.mark.parametrize("N", [1, 63, 65, 20037])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_intervals_tiled_grid_edges(cuda, N, dtype):
    gp, rng = _one_gp(700, 1024, cuda, dtype, seed=N)
    grid = torch.tensor(rng.uniform(-5.0, 5.0, size=(N, 2)), dtype=dtype,
                        device=cuda)
    ops = fp.interval_operands([gp.kern], [gp.state], grid, 2.0)
    out = fp.fused_intervals(*ops)
    torch.cuda.synchronize()
    ref = fp.fused_intervals_plain(*[o.double() if torch.is_tensor(o)
                                     else o for o in ops])
    assert out.shape == (1, 2, N)
    _check_rows(out[0], ref[0], dtype, ops[5][0, 1].item())


def _kernel_names(launch, attempts=4):
    """The ``safeopt::`` kernels one call of ``launch`` ran, from
    torch.profiler; a window that recorded no kernel at all (CUPTI drops
    a record now and then) is profiled again, up to ``attempts``."""
    from torch.profiler import ProfilerActivity, profile

    launch()                    # loaded before the profiler starts
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            launch()
            torch.cuda.synchronize()
            time.sleep(0.01)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "safeopt::" in e.name]
        if names:
            break
    return names


# the launcher's rule: the resident body while its rows cover the
# capacity (float32 to 512, float64 to 256), the tiled body past it
@pytest.mark.parametrize("dtype,cap,body", [
    (torch.float32, 512, "intervals_kernel"),
    (torch.float32, 1024, "intervals_tiled_kernel"),
    (torch.float64, 256, "intervals_kernel"),
    (torch.float64, 512, "intervals_tiled_kernel")])
def test_intervals_body_by_capacity(cuda, dtype, cap, body):
    gp, rng = _one_gp(200, cap, cuda, dtype, seed=cap)
    grid = torch.tensor(rng.uniform(-5.0, 5.0, size=(1000, 2)), dtype=dtype,
                        device=cuda)
    ops = fp.interval_operands([gp.kern], [gp.state], grid, 2.0)
    names = _kernel_names(lambda: fp.fused_intervals(*ops))
    assert len(names) == 1 and f"safeopt::{body}<" in names[0], names


PLAN_ACTIVE_CASES = [("context", 600, 1024), ("sum_bias", 1100, 2048),
                     ("cosine", 400, 512), ("sum_bias", 20, 512),
                     ("context", 77, 128), ("context", 97, 100),
                     ("cosine", 47, 50), ("nine", 600, 1024)]


# K2's launcher takes K1's rule: the resident body while its rows cover
# the capacity (float32 to 512, float64 to 256), the tiled body past it;
# a plan past the static leaves (nine) takes the wide instance of each
@pytest.mark.parametrize("dtype,cap,name,body", [
    (torch.float32, 512, "context", "intervals_plan_kernel"),
    (torch.float32, 1024, "context", "intervals_plan_tiled_kernel"),
    (torch.float64, 256, "context", "intervals_plan_kernel"),
    (torch.float64, 512, "context", "intervals_plan_tiled_kernel"),
    (torch.float32, 512, "nine", "intervals_plan_wide_kernel"),
    (torch.float32, 1024, "nine", "intervals_plan_wide_tiled_kernel")])
def test_plan_intervals_body_by_capacity(cuda, dtype, cap, name, body):
    gp, grid = _algebra_gp(name, cap, cuda, dtype, n_obs=200)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    names = _kernel_names(lambda: fp.fused_intervals_plan(*ops))
    assert len(names) == 1 and f"safeopt::{body}<" in names[0], names
    out = fp.fused_intervals_plan(*ops)
    ref = fp.fused_intervals_plan_plain(*[o.double() if o.is_floating_point()
                                          else o for o in ops])
    _check_rows(out, ref, dtype, ops[7][1].item())


@pytest.mark.parametrize("name,n_obs,cap", PLAN_ACTIVE_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_intervals_kernel_active_rows(cuda, name, n_obs, cap, dtype):
    gp, grid = _algebra_gp(name, cap, cuda, dtype, n_obs=n_obs)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    assert ops[7][3].item() == n_obs
    out = fp.fused_intervals_plan(*ops)
    torch.cuda.synchronize()
    ref = fp.fused_intervals_plan_plain(*[o.double() if o.is_floating_point()
                                          else o for o in ops])
    _check_rows(out, ref, dtype, ops[7][1].item())


def _expander_seen(run, plain, dtype, shifts=(0.0, 0.3, 1.0)):
    """Hold ``run(shift)`` (the kernel's predicate with every fmin raised
    by ``shift``) against ``plain(shift)`` (the float64 plain one) at each
    shift: float64 predicates identical, float32 ones differing only where
    the plain one changes within 1e-3 of the threshold, the last (padding)
    slot never hit. Returns the plain values seen on valid slots."""
    seen = set()
    for shift in shifts:
        got, want = run(shift), plain(shift)
        torch.cuda.synchronize()
        assert not bool(got[..., -1].any())
        seen.update(want[..., :-1].flatten().tolist())
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            decided = plain(shift - 1e-3) == plain(shift + 1e-3)
            assert not bool(((got != want) & decided).any())
    return seen


# K3 past its resident M2 (1000 rows at capacity 1024: streamed in f32
# past 512 rows, in f64 past 256), at n = 400 of 512, at counts that are
# no multiple of 32, with several candidate passes' worth of candidates
# (64, 100) and GPs of counts 20 and 300 in one launch
# fmin raises at which these states' plain predicates turn mixed
ACTIVE_SHIFTS = (0.0, 0.3, 1.0, 2.0)
EXPANDER_ACTIVE_CASES = [((1000,), 1024, 32), ((400, 400), 512, 32),
                         ((77, 45), 128, 32), ((300,), 512, 64),
                         ((97,), 100, 100), ((20, 300), 512, 32)]


@pytest.mark.parametrize("counts,cap,C", EXPANDER_ACTIVE_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_expander_kernel_active_rows(cuda, counts, cap, C, dtype):
    rng = np.random.default_rng(sum(counts) + cap + C)
    gps = []
    for g, n in enumerate(counts):
        X = rng.uniform(-4.0, 4.0, size=(n, 2))
        Y = (np.cos(X.sum(axis=1)) + 0.05 * rng.normal(size=n))[:, None]
        kern = pt.RBF(2, variance=1.0 + 0.5 * g, lengthscale=[0.8 + 0.3 * g,
                                                              1.3], ARD=True)
        gps.append(pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=cap,
                                   device=cuda, dtype=dtype))
    grid = torch.tensor(rng.uniform(-5.0, 5.0, size=(20000, 2)), dtype=dtype,
                        device=cuda)
    kerns, states = [g.kern for g in gps], [g.state for g in gps]
    beta = 2.0
    out = fp.fused_intervals_plain(*fp.interval_operands(kerns, states, grid,
                                                         beta))
    l, u = out[:, 0], out[:, 1]
    fmin = torch.quantile(l.double(), 0.5, dim=1).to(dtype)
    safe = torch.all(l > fmin[:, None], dim=0)
    safe_idx = torch.nonzero(safe).squeeze(1)
    cand = safe_idx[torch.linspace(0, safe_idx.numel() - 1, C,
                                   device=cuda).long()]
    valid = torch.ones(C, dtype=torch.bool, device=cuda)
    valid[-1] = False
    ops = fe.expander_operands(kerns, states, grid, ~safe, (l + u) / 2,
                               (u - l) / (2 * beta), grid[cand], u[:, cand],
                               valid, beta, fmin)
    assert ops[9][:, 1].tolist() == list(counts)
    ref = [o.double() if torch.is_tensor(o) and o.is_floating_point() else o
           for o in ops]

    def at(o, shift):        # the operands with every fmin raised by shift
        scal = o[9].clone()
        scal[:, 3] += shift
        return tuple(o[:9]) + (scal, o[10])

    before = fe.fused_expander.launches
    seen = _expander_seen(lambda s: fe.fused_expander(*at(ops, s)),
                          lambda s: fe.fused_expander_plain(*at(ref, s)),
                          dtype, ACTIVE_SHIFTS)
    assert fe.fused_expander.launches == before + len(ACTIVE_SHIFTS)
    assert seen == {True, False}


PLAN_EXPANDER_ACTIVE_CASES = [("context", 1000, 1024, 32),
                              ("sum_bias", 400, 512, 32),
                              ("cosine", 97, 100, 100),
                              ("context", 77, 128, 64)]


@pytest.mark.parametrize("name,n_obs,cap,C", PLAN_EXPANDER_ACTIVE_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_expander_kernel_active_rows(cuda, name, n_obs, cap, C, dtype):
    gp, grid = _algebra_gp(name, cap, cuda, dtype, n_obs=n_obs)
    beta = 2.0
    out = fp.fused_intervals_plan_plain(*fp.interval_plan_operands(
        gp.kern, gp.state, grid, beta))
    l, u = out[0], out[1]
    fmin = torch.quantile(l.double(), 0.4).to(dtype)
    safe = l > fmin
    safe_idx = torch.nonzero(safe).squeeze(1)
    cand = safe_idx[torch.linspace(0, safe_idx.numel() - 1, C,
                                   device=cuda).long()]
    valid = torch.ones(C, dtype=torch.bool, device=cuda)
    valid[-1] = False
    ops = fe.expander_plan_operands(gp.kern, gp.state, grid, ~safe,
                                    (l + u) / 2, (u - l) / (2 * beta),
                                    grid[cand], u[cand], valid, beta, fmin)
    assert ops[11][1].item() == n_obs
    ref = [o.double() if o.is_floating_point() else o for o in ops]

    def at(o, shift):        # the operands with fmin raised by shift
        scal = o[11].clone()
        scal[3] += shift
        return tuple(o[:11]) + (scal,)

    seen = _expander_seen(lambda s: fe.fused_expander_plan(*at(ops, s)),
                          lambda s: fe.fused_expander_plan_plain(*at(ref, s)),
                          dtype, ACTIVE_SHIFTS)
    assert seen == {True, False}


def test_expander_rejects_unknown_kind(cuda):
    # K3's stationary gram has no cosine branch: kinds past the four
    # stationary families must not reach it
    gps, grid = _gps("RBF", 1, 32, cuda, torch.float32)
    kerns, states = [g.kern for g in gps], [g.state for g in gps]
    out = fp.fused_intervals_plain(*fp.interval_operands(kerns, states, grid,
                                                         2.0))
    l, u = out[:, 0], out[:, 1]
    valid = torch.ones(4, dtype=torch.bool, device=cuda)
    ops = fe.expander_operands(kerns, states, grid, l[0] < 0.4, (l + u) / 2,
                               (u - l) / 4, grid[:4], u[:, :4], valid, 2.0,
                               torch.tensor([0.4], device=cuda))
    with pytest.raises(ValueError, match="kind"):
        fe.fused_expander(*ops[:10], fp.LEAF_KINDS[pt.Cosine])


def test_models_default_to_the_card(cuda):
    gp = pt.GPRegression(np.zeros((1, 2)), np.ones((1, 1)))
    assert gp.state.X.device.type == "cuda"
    assert gp.state.X.dtype == torch.float32


def test_topk_on_cuda(cuda):
    key = torch.tensor(np.random.default_rng(5).integers(0, 5, 200_000),
                       dtype=torch.float32, device=cuda)
    v, i = top_k(key, 64)
    vs, is_ = torch.sort(key.cpu(), descending=True, stable=True)
    assert torch.equal(v.cpu(), vs[:64]) and torch.equal(i.cpu(), is_[:64])
    ninf = torch.full((70_000,), float("-inf"), device=cuda)
    v, i = top_k(ninf, 32)
    assert torch.equal(i.cpu(), torch.arange(32))


def test_step_on_cuda_matches_cpu_float64(cuda):
    gps_c, grid_c = _gps("RBF", 2, 64, cuda, torch.float64, seed=3)
    gps_h, grid_h = _gps("RBF", 2, 64, "cpu", torch.float64, seed=3)
    args = dict(fmin=[0.3, 0.5], scaling=[np.sqrt(2.0), np.sqrt(1.5)],
                threshold=[0.0, 0.0])

    def step(gps, grid):
        t = {k: torch.tensor(v, dtype=torch.float64, device=grid.device)
             for k, v in args.items()}
        return core.safeopt_step(tuple(g.kern for g in gps),
                                 tuple(g.state for g in gps), grid,
                                 t["fmin"], 2.0, t["scaling"],
                                 t["threshold"], chunk=16)

    launches = fp.fused_intervals.launches
    r_c, r_h = step(gps_c, grid_c), step(gps_h, grid_h)
    assert fp.fused_intervals.launches == launches + 1
    for name in ("S", "M", "G"):
        assert torch.equal(getattr(r_c, name).cpu(), getattr(r_h, name))
    assert int(r_c.next_idx) == int(r_h.next_idx)


# -- B1-B5: the interval stage's experiment kernels ---------------------------
#
# B1 must give K1's bits at every launch layout. B2, B3 and B5 agree with
# their plain versions to 1e-9 in float64; in float32 they are held
# against the plain version run in float64 on the same (float32)
# operands, B4 against its plain version (the limbs bit for bit, the
# products in float64), within ``float32_bound``, the worst case of their
# float32 arithmetic. B4 must give the same bits with Lm's limbs split in
# the kernel and passed pre-split.

def _experiment_ops(counts, cap, device, dtype, family="RBF", d=2):
    """K1's operands of GPs of ``family`` with the given counts (a count
    of 0: a GP of one observation whose count is set to 0), data in
    [-4, 4]^d and a 20000-point grid on [-5, 5]^d, both scaled by
    sqrt(2 / d) so that wide grams are not all 0."""
    rng = np.random.default_rng(sum(counts) + 7 * cap)
    spread = math.sqrt(2.0 / d)
    gps = []
    for g, n in enumerate(counts):
        m = max(n, 1)
        X = rng.uniform(-4.0, 4.0, size=(m, d)) * spread
        Y = (np.cos(X.sum(axis=1)) + 0.05 * rng.normal(size=m))[:, None]
        kern = getattr(pt, family)(d, variance=1.0 + 0.5 * g,
                                   lengthscale=[0.8 + 0.3 * g] + [1.3] * (
                                       d - 1), ARD=True)
        gps.append(pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=cap,
                                   device=device, dtype=dtype))
    grid = torch.tensor(rng.uniform(-5.0, 5.0, size=(20000, d)) * spread,
                        dtype=dtype, device=device)
    ops = fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                               grid, 2.0)
    for g, n in enumerate(counts):
        if n == 0:
            ops[5][g, 3] = 0
    return ops


def _upcast(ops):
    return tuple(o.double() if torch.is_tensor(o) else o for o in ops)


def _within(got, want, bound):
    err = (got.double() - want.double()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), (err - bound).max().item()


EXPERIMENT_CASES = [((45, 50), 64), ((400, 400), 512), ((20, 300), 512),
                    ((97,), 100)]
# (slices, resident rows, carveout) that fit the card at these capacities
LAUNCH_VARIANTS = [(0, 0, -1), (1, 0, -1), (1, 64, 100), (2, 64, -1),
                   (4, 32, 0), (8, 16, -1), (0, 0, -1)]
# the float32 B1-3p's (groups, stages, resident rows, carveout) that keep
# K1-3p's summation order: ring stages, resident rows and the carveout
LAUNCH_VARIANTS3 = [(0, 0, 0, -1), (0, 2, 0, -1), (0, 4, 0, -1),
                    (0, 0, 64, 100), (0, 2, 32, 0), (0, 0, 0, -1)]


@pytest.mark.parametrize("counts,cap", EXPERIMENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("three_pass", [False, True])
def test_launch_variants_give_k1_bits(cuda, counts, cap, dtype, three_pass):
    """B1 gives K1's bits at every layout; B1-3p K1-3p's at every layout
    that keeps K1-3p's order (float64: every layout of its
    ThreePassProduct body; float32: ``LAUNCH_VARIANTS3``). Past the
    resident body's rows (float64 at capacity 512) K1 runs its tiled body,
    and B1, the resident body at other layouts, gives its automatic
    layout's bits there, within 1e-9 of K1's."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, dtype)
    variants = [dict(slices=s, res=r, carveout=c)
                for s, r, c in LAUNCH_VARIANTS]
    if three_pass:
        k1 = fp.fused_intervals3(*ops)
        if dtype == torch.float32:
            variants = [dict(groups=g, stages=s, res=r, carveout=c)
                        for g, s, r, c in LAUNCH_VARIANTS3]
    elif cap <= (512 if dtype == torch.float32 else 256):
        k1 = fp.fused_intervals(*ops)
    else:
        k1 = ie.intervals_launch(*ops)
        assert (k1 - fp.fused_intervals(*ops)).abs().max().item() <= 1e-9
    count = "three_pass_launches" if three_pass else "launches"
    before = getattr(ie.intervals_launch, count)
    for kw in variants:
        got = ie.intervals_launch(*ops, three_pass=three_pass, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, k1), kw
    assert getattr(ie.intervals_launch, count) == before + len(variants)


@pytest.mark.parametrize("counts,cap", EXPERIMENT_CASES)
def test_launch_three_pass_groups_within_the_bound(cuda, counts, cap):
    """The float32 B1-3p at the other count of consumer warpgroups than
    K1-3p's (which warp adds which row tile: another order) within the
    split bound of K1-3p's plain version."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, torch.float32)
    groups = 3 if cap <= 128 else 1
    got = ie.intervals_launch(*ops, three_pass=True, groups=groups,
                              stages=2)
    _within(got, fp.fused_intervals3_plain(*ops),
            ie.float32_bound(*ops, "split", limb="bf16"))


def _faults_past(plain, ops, bound):
    """The plain rows with each GP's first, then last, 32 active rows
    dropped (``drop_band``) land past ``bound``."""
    from safeopt_torch.ops import interval_experiments as ie
    want = plain(*ops).double()
    for first in (True, False):
        fault = plain(*ie.drop_band(ops, "split", first)).double()
        assert ((fault - want).abs() / bound).max().item() > 1.0, first


@pytest.mark.parametrize("counts,cap", EXPERIMENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launch_three_pass_matches_plain(cuda, counts, cap, dtype):
    """B1-3p against K1-3p's plain version: float64 to 1e-9, float32
    within the split bound, which both planted faults pass."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, dtype)
    got = ie.intervals_launch(*ops, three_pass=True)
    want = fp.fused_intervals3_plain(*ops)
    if dtype == torch.float64:
        assert (got - want).abs().max().item() <= 1e-9
    else:
        bound = ie.float32_bound(*ops, "split", limb="bf16")
        _within(got, want, bound)
        _faults_past(fp.fused_intervals3_plain, ops, bound)


def test_launch_refuses_a_layout_past_shared_memory(cuda):
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops((400,), 512, cuda, torch.float32)
    with pytest.raises(RuntimeError, match="B1"):
        ie.intervals_launch(*ops, slices=8, res=512)


# B2's gram sums and B5's modes on the gram-only body (csrc/gram_rows.cuh):
# its RBF instances of 1, 2 and 10 columns, its runtime-d instance (64
# columns, and every other kind), counts 0, 1, 33 and 400 and near the
# capacity, capacities 1024 and 2048; the 20000-point grid is no whole
# number of a block's points (512, 256 at d = 10, 128 at run time)
GRAM_ROWS_CASES = [((33, 1), 64, "RBF", 1), ((400, 0), 512, "RBF", 10),
                   ((33,), 64, "RBF", 64), ((1000,), 1024, "RBF", 2),
                   ((2000,), 2048, "RBF", 2), ((400,), 512, "Matern32", 2),
                   ((33, 400), 1024, "Matern52", 10),
                   ((1, 400), 2048, "Exponential", 1),
                   ((0, 33), 64, "Matern52", 64),
                   ((400,), 512, "Exponential", 2),
                   ((33,), 64, "Matern32", 1)]
GRAM_MODES = ("gram_sums", "no_product", "epilogue")
ABLATION_CASES = ([(counts, cap, "RBF", 2, mode)
                   for mode in ("gram_sums", "solve_rank1", "no_product",
                                "epilogue")
                   for counts, cap in EXPERIMENT_CASES]
                  + [(counts, cap, family, d, mode) for mode in GRAM_MODES
                     for counts, cap, family, d in GRAM_ROWS_CASES])


@pytest.mark.parametrize("counts,cap,family,d,mode", ABLATION_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ablation_kernel_matches_plain(cuda, counts, cap, family, d, mode,
                                       dtype):
    """B2/B5 against the plain version: float64 within 1e-9; float32
    within ``float32_bound`` of the float64 plain rows on the same
    operands for RBF, and under ``epilogue`` (no gram: its bound holds
    for every kind), the gram modes of the other kinds (no float32 bound
    is derived for their grams) within 1e-4 (|.| + 1)."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, dtype, family, d)
    got = ie.interval_ablation(*ops, mode)
    want = ie.interval_ablation_plain(*_upcast(ops), mode)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        assert (got - want).abs().max().item() <= 1e-9
    elif family == "RBF" or mode == "epilogue":
        _within(got, want, ie.float32_bound(*ops[:6], 0, mode))
    else:
        _within(got, want, 1e-4 * (want.abs() + 1.0))


@pytest.mark.parametrize("counts,cap,d", [((400, 400), 512, 2),
                                          ((20, 300), 512, 2),
                                          ((2000,), 2048, 2),
                                          ((97,), 100, 1),
                                          ((33, 400), 512, 10),
                                          ((45, 0), 64, 64)])
@pytest.mark.parametrize("beta", [2.0, 1.7])
@pytest.mark.parametrize("mode", list(GRAM_MODES))
def test_gram_rows_float32_bits_are_the_in_order_sums(cuda, counts, cap, d,
                                                      beta, mode):
    """The float32 B2/B5 bit for bit the in-order float32 sums of
    ``kernel_gram``'s entries (``ablation_in_order``: a point's rows in
    ascending order, one accumulator a sum, an FMA wherever nvcc
    contracts) on the same operands, RBF at every instance's width; a
    beta that is no power of two tells the epilogue's contraction
    apart."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, torch.float32, d=d)
    ops[5][:, 2] = beta
    got = ie.interval_ablation(*ops, mode)
    want = ie.ablation_in_order(*ops, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("counts,cap", EXPERIMENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("three_pass", [False, True])
def test_mu_from_gram_kernel_matches_plain(cuda, counts, cap, dtype,
                                           three_pass):
    """B3 and B3-3p; B3-3p's plain version runs on the float32 operands
    themselves (it cuts the kernel's limbs)."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, dtype)
    before = ie.intervals_mu_from_gram.three_pass_launches
    got = ie.intervals_mu_from_gram(*ops, three_pass=three_pass)
    want = ie.intervals_mu_from_gram_plain(
        *(ops if three_pass else _upcast(ops)), three_pass=three_pass)
    torch.cuda.synchronize()
    assert (ie.intervals_mu_from_gram.three_pass_launches
            == before + three_pass)
    if dtype == torch.float64:
        assert (got - want).abs().max().item() <= 1e-9
    else:
        _within(got, want, ie.float32_bound(*ops, "mu_from_gram",
                                            three_pass=three_pass))


@pytest.mark.parametrize("counts,cap", EXPERIMENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rank1_solve_three_pass_kernel_matches_plain(cuda, counts, cap,
                                                     dtype):
    """B2-3p against its plain version on the same operands."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, dtype)
    before = ie.interval_ablation.three_pass_launches
    got = ie.interval_ablation(*ops, "solve_rank1", three_pass=True)
    want = ie.interval_ablation_plain(*ops, "solve_rank1", three_pass=True)
    torch.cuda.synchronize()
    assert ie.interval_ablation.three_pass_launches == before + 1
    if dtype == torch.float64:
        assert (got - want).abs().max().item() <= 1e-9
    else:
        _within(got, want, ie.float32_bound(*ops, "solve_rank1",
                                            three_pass=True))


@pytest.mark.parametrize("counts,cap", EXPERIMENT_CASES + [((600,), 1024)])
@pytest.mark.parametrize("limb", ["bf16", "tf32"])
def test_split_kernel_matches_plain(cuda, counts, cap, limb):
    """B4 in both limb formats, cut in the kernel and hoisted: the same
    bits, within the split bound of its plain version; in bf16 with the
    limbs hoisted, K1-3p's rows for the GP alone."""
    from safeopt_torch.ops import interval_experiments as ie
    zt, ils, xs, lm, w, scal, kind = _experiment_ops(counts, cap, cuda,
                                                     torch.float32)
    for g in range(len(counts)):
        one = (zt, ils[g], xs[g], lm[g], w[g], scal[g], kind)
        before = ie.intervals_split.launches
        inkernel = ie.intervals_split(*one, limb=limb)
        hoisted = ie.intervals_split(*one, limb=limb,
                                     limbs=ie.split_factor(lm[g], limb))
        torch.cuda.synchronize()
        assert ie.intervals_split.launches == before + 2
        assert torch.equal(inkernel, hoisted)
        _within(inkernel, ie.intervals_split_plain(*one, limb=limb),
                ie.float32_bound(*one, "split", limb=limb))
        if limb == "bf16":
            alone = (zt, ils[g:g + 1], xs[g:g + 1], lm[g:g + 1],
                     w[g:g + 1], scal[g:g + 1], kind)
            assert torch.equal(hoisted, fp.fused_intervals3(*alone)[0])


def test_split_kernel_takes_float32_only(cuda):
    from safeopt_torch.ops import interval_experiments as ie
    zt, ils, xs, lm, w, scal, kind = _experiment_ops((20,), 64, cuda,
                                                     torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ie.intervals_split(zt, ils[0], xs[0], lm[0], w[0], scal[0], kind)


def test_split_kernel_refuses_limbs_of_another_format(cuda):
    from safeopt_torch.ops import interval_experiments as ie
    zt, ils, xs, lm, w, scal, kind = _experiment_ops((97,), 100, cuda,
                                                     torch.float32)
    one = (zt, ils[0], xs[0], lm[0], w[0], scal[0], kind)
    with pytest.raises(ValueError, match="split_factor"):
        ie.intervals_split(*one, limb="bf16",
                           limbs=ie.split_factor(lm[0], "tf32"))
    with pytest.raises(ValueError, match="split_factor"):
        ie.intervals_split(*one, limb="tf32",
                           limbs=(lm[0].contiguous(), lm[0].contiguous()))


# -- K1-3p and K2-3p: the three-pass product ---------------------------------

THREE_PASS_CASES = EXPERIMENT_CASES + [((600,), 1024)]


@pytest.mark.parametrize("counts,cap", THREE_PASS_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_three_pass_kernel_matches_plain(cuda, counts, cap, dtype):
    """K1-3p against its plain version: float64 (lo unrounded, FP64 FMAs)
    to 1e-9; float32 (bf16 tensor cores) within ``float32_bound``'s
    split bound of the plain version on the same operands."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, dtype)
    before = fp.fused_intervals3.launches
    got = fp.fused_intervals3(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals3.launches == before + 1
    want = fp.fused_intervals3_plain(*ops)
    if dtype == torch.float64:
        assert (got - want).abs().max().item() <= 1e-9
    else:
        _within(got, want, ie.float32_bound(*ops, "split", limb="bf16"))


PLAN_THREE_PASS_CASES = PLAN_CASES + [("context", 1024)]


@pytest.mark.parametrize("name,cap", PLAN_THREE_PASS_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_three_pass_kernel_matches_plain(cuda, name, cap, dtype):
    from safeopt_torch.ops import interval_experiments as ie
    gp, grid = _algebra_gp(name, cap, cuda, dtype,
                           n_obs=600 if cap == 1024 else 40)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    before = fp.fused_intervals_plan3.launches
    got = fp.fused_intervals_plan3(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals_plan3.launches == before + 1
    want = fp.fused_intervals_plan3_plain(*ops)
    if dtype == torch.float64:
        assert (got - want).abs().max().item() <= 1e-9
    else:
        _within(got, want, ie.float32_bound_plan(*ops))


def test_three_pass_kernels_give_the_same_bits_twice(cuda):
    """The float32 K1-3p and K2-3p add their partial sums in a fixed
    order: two launches give the same bits (the certified path compares
    runs)."""
    ops = _experiment_ops((400, 400), 512, cuda, torch.float32)
    assert torch.equal(fp.fused_intervals3(*ops), fp.fused_intervals3(*ops))
    gp, grid = _algebra_gp("context", 256, cuda, torch.float32, n_obs=240)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    assert torch.equal(fp.fused_intervals_plan3(*ops),
                       fp.fused_intervals_plan3(*ops))


@pytest.mark.parametrize("N", [5, 64 * 37 + 13])
def test_three_pass_kernels_take_a_grid_of_any_length(cuda, N):
    """Grids shorter than, and not a multiple of, a work item's 64
    points: every row is written and within the split bound."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops((400, 300), 512, cuda, torch.float32)
    ops = (ops[0][:, :N].contiguous(),) + ops[1:]
    got = fp.fused_intervals3(*ops)
    _within(got, fp.fused_intervals3_plain(*ops),
            ie.float32_bound(*ops, "split", limb="bf16"))
    gp, grid = _algebra_gp("cosine", 256, cuda, torch.float32, n_obs=200)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid[:N], 2.0)
    _within(fp.fused_intervals_plan3(*ops),
            fp.fused_intervals_plan3_plain(*ops), ie.float32_bound_plan(*ops))


@pytest.mark.parametrize("counts,cap", [((1200,), 2048), ((3000,), 4096)])
def test_three_pass_kernel_past_the_resident_gram(cuda, counts, cap):
    """Capacities whose gram is not all resident at 64 points a block:
    the warpgroups compute the chunks past the resident rows as they
    come to them; float32 within the split bound."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, torch.float32)
    before = fp.fused_intervals3.launches
    got = fp.fused_intervals3(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals3.launches == before + 1
    _within(got, fp.fused_intervals3_plain(*ops),
            ie.float32_bound(*ops, "split", limb="bf16"))


def test_three_pass_kernels_run_on_wgmma(cuda):
    """The float32 K1-3p and K2-3p instances (K2-3p's static and wide
    plans, each with three consumer warpgroups a block and with one, for
    capacities up to 128) hold Hopper's warpgroup product in their
    SASS."""
    from safeopt_torch.ops._build import sass_opcodes
    counts = {k: v for k, v in sass_opcodes("HGMMA").items()
              if "wg_kernel" in k}
    assert len(counts) == 6 and min(counts.values()) > 0, counts


# -- K1-3p and K2-3p past the resident gram: the tiled body ------------------

# capacities past the resident body's 576 rows, counts that are no
# multiple of a 64-row tile, a small count at a large capacity and unequal
# counts in one launch
TILED_THREE_PASS_CASES = [((600,), 640), ((700,), 1024), ((1000, 333), 1024),
                          ((2000,), 2048), ((40,), 2048), ((50, 1500), 2048)]


@pytest.mark.parametrize("counts,cap", TILED_THREE_PASS_CASES)
def test_tiled_three_pass_kernel_matches_plain(cuda, counts, cap):
    """The float32 K1-3p past capacity 576 runs the tiled body and lies
    within the split bound of its plain version, the same bits twice."""
    from safeopt_torch.ops import interval_experiments as ie
    assert fp.three_pass_body(cap) == "tiled"
    ops = _experiment_ops(counts, cap, cuda, torch.float32)
    before = fp.fused_intervals3.launches
    got = fp.fused_intervals3(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals3.launches == before + 1
    _within(got, fp.fused_intervals3_plain(*ops),
            ie.float32_bound(*ops, "split", limb="bf16"))
    assert torch.equal(got, fp.fused_intervals3(*ops))


@pytest.mark.parametrize("N", [1, 127, 129, 128 * 37 + 13])
def test_tiled_three_pass_kernels_take_a_grid_of_any_length(cuda, N):
    """Grids shorter than, and not a multiple of, the tiled body's 128
    points an item: every row is written and within the split bound."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops((700,), 1024, cuda, torch.float32)
    ops = (ops[0][:, :N].contiguous(),) + ops[1:]
    _within(fp.fused_intervals3(*ops), fp.fused_intervals3_plain(*ops),
            ie.float32_bound(*ops, "split", limb="bf16"))
    gp, grid = _algebra_gp("context", 1024, cuda, torch.float32, n_obs=600)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid[:N], 2.0)
    _within(fp.fused_intervals_plan3(*ops),
            fp.fused_intervals_plan3_plain(*ops), ie.float32_bound_plan(*ops))


@pytest.mark.parametrize("name,n_obs,cap", [
    ("context", 600, 640), ("context", 1500, 2048), ("sum_bias", 97, 1024),
    ("cosine", 700, 1024), ("nine", 600, 1024)])
def test_tiled_plan_three_pass_kernel_matches_plain(cuda, name, n_obs, cap):
    """The float32 K2-3p past capacity 576, its wide plan (nine leaves)
    included: within ``float32_bound_plan`` of the plain version, the same
    bits twice."""
    from safeopt_torch.ops import interval_experiments as ie
    gp, grid = _algebra_gp(name, cap, cuda, torch.float32, n_obs=n_obs)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    before = fp.fused_intervals_plan3.launches
    got = fp.fused_intervals_plan3(*ops)
    torch.cuda.synchronize()
    assert fp.fused_intervals_plan3.launches == before + 1
    _within(got, fp.fused_intervals_plan3_plain(*ops),
            ie.float32_bound_plan(*ops))
    assert torch.equal(got, fp.fused_intervals_plan3(*ops))


# the launchers' rule (fused_posterior.three_pass_body): the resident body
# up to capacity 576, the tiled body past it; a plan past the static
# leaves (nine) takes the wide instance of each
@pytest.mark.parametrize("cap,body", [(512, "intervals3_wg_kernel"),
                                      (576, "intervals3_wg_kernel"),
                                      (640, "intervals3_tiled_kernel"),
                                      (2048, "intervals3_tiled_kernel")])
def test_three_pass_body_by_capacity(cuda, cap, body):
    ops = _experiment_ops((300,), cap, cuda, torch.float32)
    names = _kernel_names(lambda: fp.fused_intervals3(*ops))
    assert len(names) == 1 and f"safeopt::{body}" in names[0], names


@pytest.mark.parametrize("cap,name,body", [
    (512, "context", "intervals_plan3_wg_kernel<3, false>"),
    (1024, "context", "intervals_plan3_tiled_kernel<false>"),
    (512, "nine", "intervals_plan3_wg_kernel<3, true>"),
    (1024, "nine", "intervals_plan3_tiled_kernel<true>")])
def test_plan_three_pass_body_by_capacity(cuda, cap, name, body):
    gp, grid = _algebra_gp(name, cap, cuda, torch.float32, n_obs=200)
    ops = fp.interval_plan_operands(gp.kern, gp.state, grid, 2.0)
    names = _kernel_names(lambda: fp.fused_intervals_plan3(*ops))
    assert len(names) == 1 and f"safeopt::{body}" in names[0], names


def test_tiled_three_pass_kernels_run_on_wgmma(cuda):
    """The tiled K1-3p and K2-3p instances (K2-3p's static and wide
    plans) hold Hopper's warpgroup product in their SASS."""
    from safeopt_torch.ops._build import sass_opcodes
    counts = {k: v for k, v in sass_opcodes("HGMMA").items()
              if "intervals3_tiled_kernel" in k
              or "intervals_plan3_tiled_kernel" in k}
    assert len(counts) == 3 and min(counts.values()) > 0, counts


# -- B2-3p and B3-3p on K1-3p's wgmma bodies ---------------------------------

# the resident body (one consumer warpgroup up to capacity 128, three past
# it) and the tiled body past capacity 576, with unequal counts, a count
# that is no multiple of a row tile and a small count at a large capacity
EXPERIMENT3_CASES = EXPERIMENT_CASES + [((600,), 640), ((1000, 333), 1024),
                                        ((40,), 2048)]
# the body of each float32 kernel, by the capacity (three_pass_body)
EXPERIMENT3_BODY = {
    "solve_rank1": {"resident": "rank1_wg3_kernel<",
                    "tiled": "rank1_tiled3_kernel"},
    "mu_from_gram": {"resident": "mu_wg3_kernel<",
                     "tiled": "mu_tiled3_kernel"}}


def _experiment3(what):
    """B2-3p's or B3-3p's wrapper and plain version."""
    import functools

    from safeopt_torch.ops import interval_experiments as ie
    if what == "mu_from_gram":
        return (functools.partial(ie.intervals_mu_from_gram, three_pass=True),
                functools.partial(ie.intervals_mu_from_gram_plain,
                                  three_pass=True))
    return (functools.partial(ie.interval_ablation, mode=what,
                              three_pass=True),
            functools.partial(ie.interval_ablation_plain, mode=what,
                              three_pass=True))


@pytest.mark.parametrize("counts,cap", EXPERIMENT3_CASES)
@pytest.mark.parametrize("what", ["solve_rank1", "mu_from_gram"])
def test_experiment_three_pass_on_the_wgmma_bodies(cuda, counts, cap, what):
    """The float32 B2-3p and B3-3p run K1-3p's wgmma bodies (the profiler's
    kernel name: resident up to capacity 576, tiled past it), within
    ``float32_bound(..., three_pass=True)`` of their plain versions on the
    same operands, which a kernel dropping each GP's first or last 32
    active rows would pass; two launches give the same bits."""
    from safeopt_torch.ops import interval_experiments as ie
    kernel, plain = _experiment3(what)
    ops = _experiment_ops(counts, cap, cuda, torch.float32)
    count = (ie.intervals_mu_from_gram if what == "mu_from_gram"
             else ie.interval_ablation)
    before = count.three_pass_launches
    got = kernel(*ops)
    torch.cuda.synchronize()
    assert count.three_pass_launches == before + 1
    bound = ie.float32_bound(*ops, what, three_pass=True)
    want = plain(*ops).double()
    _within(got, want, bound)
    for first in (True, False):
        fault = plain(*ie.drop_band(ops, what, first)).double()
        assert ((fault - want).abs() / bound).max().item() > 1.0, first
    assert torch.equal(got, kernel(*ops))
    names = _kernel_names(lambda: kernel(*ops))
    body = EXPERIMENT3_BODY[what][fp.three_pass_body(cap)]
    assert len(names) == 1 and f"safeopt::{body}" in names[0], names


@pytest.mark.parametrize("counts,cap", [((600,), 640), ((40,), 2048)])
@pytest.mark.parametrize("what", ["solve_rank1", "mu_from_gram"])
def test_experiment_three_pass_float64_past_the_resident_body(cuda, counts,
                                                              cap, what):
    """The float64 B2-3p and B3-3p (ThreePassProduct at every capacity)
    at the tiled body's capacities: within 1e-9 of the plain version."""
    kernel, plain = _experiment3(what)
    ops = _experiment_ops(counts, cap, cuda, torch.float64)
    assert (kernel(*ops) - plain(*ops)).abs().max().item() <= 1e-9


@pytest.mark.parametrize("counts,cap,res", [
    ((400, 400), 512, 64), ((400, 400), 512, 256), ((20, 300), 512, 480),
    ((173,), 200, 64), ((45, 50), 64, 32)])
def test_mu_from_gram_three_pass_past_the_resident_rows(cuda, counts, cap,
                                                        res):
    """The float32 B3-3p with ``res`` resident gram rows: past them each
    warpgroup computes a chunk's gram for every row tile that reaches it,
    and only the chunk's diagonal tile adds its u k. Within the float32
    bound of the plain version, the same bits twice."""
    from safeopt_torch.ops import interval_experiments as ie
    ops = _experiment_ops(counts, cap, cuda, torch.float32)
    got = ie.intervals_mu_from_gram(*ops, three_pass=True, res=res)
    _within(got, ie.intervals_mu_from_gram_plain(*ops, three_pass=True),
            ie.float32_bound(*ops, "mu_from_gram", three_pass=True))
    assert torch.equal(got, ie.intervals_mu_from_gram(*ops, three_pass=True,
                                                      res=res))


def test_experiment_three_pass_kernels_run_on_wgmma(cuda):
    """The float32 B2-3p and B3-3p instances (the resident body with one
    and three consumer warpgroups, the tiled body) hold Hopper's
    warpgroup product in their SASS."""
    from safeopt_torch.ops._build import sass_opcodes
    counts = {k: v for k, v in sass_opcodes("HGMMA").items()
              if any(name in k for name in ("rank1_wg3_kernel",
                                            "rank1_tiled3_kernel",
                                            "mu_wg3_kernel",
                                            "mu_tiled3_kernel"))}
    assert len(counts) == 6 and min(counts.values()) > 0, counts


def test_float32_experiment_entries_refuse_three_pass(cuda):
    """The float32 B2-3p and B3-3p are the wgmma entries'
    (``safeopt_rank1_solve3_f32``, ``safeopt_mu_from_gram3_f32``): the
    FP32 entries refuse ``three_pass = 1`` with cudaErrorInvalidValue (1),
    and the wgmma entry refuses resident rows past the capacity or on the
    tiled body."""
    from safeopt_torch.ops import interval_experiments as ie
    from safeopt_torch.ops._build import library
    lib = library()
    ops = _experiment_ops((40,), 64, cuda, torch.float32)
    zt, ils, xs, lm, w, scal, kind = ops
    G, cap, d = xs.shape
    N = zt.shape[1]
    out = torch.empty((G, 2, N), device=cuda)
    stream = ie._stream(zt)
    lmt = fp.transposed_factor(lm)
    args = [fp.ptr(t) for t in (zt, ils, xs, lmt, w, scal, out)]
    assert lib.safeopt_interval_ablation_f32(
        *args, G, N, d, cap, kind, ie.ABLATIONS["solve_rank1"], 1,
        stream) == 1
    assert lib.safeopt_intervals_mu_from_gram_f32(
        *args, G, N, d, cap, kind, 1, stream) == 1
    chunks = fp.factor_chunks(lm)
    args3 = [fp.ptr(t) for t in (zt, ils, xs, chunks, w, scal, out)]
    for res in (16, 96, -32):
        assert lib.safeopt_mu_from_gram3_f32(*args3, G, N, d, cap, kind, res,
                                             stream) == 1
    big = _experiment_ops((40,), 640, cuda, torch.float32)
    with pytest.raises(ValueError, match="tiled body"):
        ie.intervals_mu_from_gram(*big, three_pass=True, res=64)


# -- past the static plan's leaves and the kernels' columns; the certified
# path ----------------------------------------------------------------------

def test_plan_past_the_static_leaf_count_runs_the_wide_kernels(cuda):
    """A 9-leaf product (one leaf past the plan K2/K4 stage in static
    shared memory; ``PLAN_CASES``' "nine" holds their wide instances
    against the plain versions): the step launches K2 and K4 on it and
    decides like the float64 plain step on the CPU."""
    X = np.array([[0.0, 0.0], [0.5, -0.5], [-0.4, 0.3]])
    Y = np.array([[1.5], [1.4], [1.45]])
    grid = pt.linearly_spaced_combinations([(-2.0, 2.0)] * 2, 40)
    opts = [pt.SafeOpt(pt.GPRegression(X, Y, _product_of(fp.MAX_LEAVES + 1),
                                       noise_var=1e-3, device=dev,
                                       dtype=dt), grid, fmin=[1.0])
            for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64))]
    before = (fp.fused_intervals_plan.launches,
              fe.fused_expander_plan.launches)
    opts[0].optimize()
    torch.cuda.synchronize()
    assert fp.fused_intervals_plan.launches == before[0] + 1
    assert (fe.fused_expander_plan.launches > before[1]
            or opts[0].stats.last.walk_chunks == 0)
    opts[1].optimize()
    l64 = opts[1].Q[:, 0]
    far = np.abs(l64 - 1.0) / opts[0].scaling[0] >= 1e-3
    np.testing.assert_array_equal(opts[0].S[far], opts[1].S[far])


def test_grid_past_the_column_limit_raises_on_cuda(cuda):
    """MAX_DIM: the CUDA kernels refuse a grid one column wider, and
    so does a step on the card (CPU tensors take the plain versions,
    tests/test_torch_ops.py)."""
    d = fp.MAX_DIM + 1
    rng = np.random.default_rng(0)
    X = rng.uniform(-0.2, 0.2, size=(3, d))
    gp = pt.GPRegression(X, np.full((3, 1), 1.5), pt.RBF(d, lengthscale=3.0),
                         noise_var=1e-3)
    grid = rng.uniform(-0.5, 0.5, size=(500, d))
    ops = fp.interval_operands([gp.kern], [gp.state],
                               torch.tensor(grid, device=cuda,
                                            dtype=torch.float32), 2.0)
    with pytest.raises(ValueError, match="grid columns"):
        fp.fused_intervals(*ops)
    with pytest.raises(ValueError, match="grid columns"):
        pt.SafeOpt(gp, grid, fmin=[0.0]).optimize()


@pytest.mark.parametrize("oracle", ["host", "device"])
@pytest.mark.parametrize("planned", [False, True])
def test_certified_step_launches_three_pass_then_full(cuda, oracle, planned):
    """A certified step at interval_precision='high' runs the grid pass
    on K1-3p (K2-3p for a plan GP) and the refined rows on K1 (K2), and
    decides like the float64 plain step on the CPU."""
    if planned:
        gp, _ = _algebra_gp("context", 64, cuda, torch.float32)
        gp64, _ = _algebra_gp("context", 64, "cpu", torch.float64)
    else:
        gp, gp64 = (_gps("RBF", 1, 64, dev, dt)[0][0]
                    for dev, dt in ((cuda, torch.float32),
                                    ("cpu", torch.float64)))
    grid = pt.linearly_spaced_combinations([(-3.0, 3.0)] * 2, 200)
    fmin = [0.8]
    counts = (fp.fused_intervals3, fp.fused_intervals,
              fp.fused_intervals_plan3, fp.fused_intervals_plan)
    before = [f.launches for f in counts]
    opt = pt.SafeOpt(gp, grid, fmin=fmin, exact_boundaries=True,
                     interval_precision="high", oracle=oracle)
    x = opt.optimize()
    torch.cuda.synchronize()
    launched = [f.launches - b for f, b in zip(counts, before)]
    assert launched == ([0, 0, 1, 1] if planned else [1, 1, 0, 0])
    ref = pt.SafeOpt(gp64, grid, fmin=fmin)
    xr = ref.optimize()
    l64 = ref.Q[:, 0]
    far = np.abs(l64 - fmin[0]) / opt.scaling[0] >= 1e-9
    np.testing.assert_array_equal(opt.S[far], ref.S[far])
    w = (ref.Q[:, 1] - ref.Q[:, 0]) / opt.scaling[0]
    i, j = opt.stats.last.next_index, ref.stats.last.next_index
    assert i == j or abs(w[i] - w[j]) <= 1e-3, (x, xr)


# -- the eager route, asynchronous steps, the device loop ---------------------

def _mixed_gps(device, dtype):
    """The flagship's GPs at a small size: GP 0 RBF (K1/K3), GP 1 RBF +
    White (the eager route)."""
    rng = np.random.default_rng(11)
    X = rng.uniform(-1.5, 1.5, size=(30, 2))
    Yf = 2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))[:, None]
    Yg = (1.0 - 0.1 * np.sum(X ** 2, axis=1))[:, None]
    kerns = (pt.RBF(2, variance=2.0),
             pt.RBF(2, variance=1.0, lengthscale=1.5)
             + pt.White(2, variance=1e-2))
    return [pt.GPRegression(X, Y, k, noise_var=0.05 ** 2, capacity=64,
                            device=device, dtype=dtype)
            for Y, k in zip((Yf, Yg), kerns)]


def _launch_counts():
    return [f.launches for f in (fp.fused_intervals, fe.fused_expander,
                                 fp.fused_intervals_plan,
                                 fe.fused_expander_plan)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mixed_routes_on_cuda(cuda, dtype):
    """GP 0 launches K1 (and K3 per walk chunk) alone, GP 1 takes the
    eager route and launches nothing; the decisions are the float64 CPU
    step's (outside the 1e-3 band in float32)."""
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2, 150)
    kw = dict(fmin=[0.2, 0.5], scaling=[np.sqrt(2.0), 1.0],
              expander_chunk=32)
    opt = pt.SafeOpt(_mixed_gps(cuda, dtype), grid, **kw)
    ref = pt.SafeOpt(_mixed_gps("cpu", torch.float64), grid, **kw)
    groups = core._gp_groups([g.kern for g in opt.gps],
                             [g.state for g in opt.gps], 2)
    assert [r for _, r in groups] == ["batched", "eager"]
    before = _launch_counts()
    opt.optimize()
    torch.cuda.synchronize()
    k1, k3, k2, k4 = (a - b for a, b in zip(_launch_counts(), before))
    assert (k1, k2, k4) == (1, 0, 0)
    assert k3 == opt.stats.last.walk_chunks
    assert opt.stats.last.eager_gps == 1
    ref.optimize()
    if dtype == torch.float64:
        for name in ("S", "M", "G"):
            np.testing.assert_array_equal(getattr(opt, name),
                                          getattr(ref, name))
        assert opt.stats.last.next_index == ref.stats.last.next_index
        np.testing.assert_allclose(opt.Q, ref.Q, rtol=0, atol=1e-9)
    else:
        l64 = ref.Q[:, 0::2]
        margin = np.min(np.abs(l64 - np.array(kw["fmin"]))
                        / np.array(kw["scaling"]), axis=1)
        far = margin >= 1e-3
        np.testing.assert_array_equal(opt.S[far], ref.S[far])


def test_async_step_on_cuda_reads_a_pinned_copy(cuda):
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2, 150)
    kw = dict(fmin=[0.2, 0.5], scaling=[np.sqrt(2.0), 1.0])
    a = pt.SafeOpt(_mixed_gps(cuda, torch.float32), grid, **kw)
    b = pt.SafeOpt(_mixed_gps(cuda, torch.float32), grid, **kw)
    pending = b.optimize_async()
    assert pending._diag.is_pinned() and pending._event is not None
    np.testing.assert_array_equal(pending.result(), a.optimize())
    assert b.stats.last.host_syncs == a.stats.last.host_syncs >= 1
    for oracle in ("host", "device"):
        xs = [pt.run_lagged_campaign(
            pt.SafeOpt(_mixed_gps(cuda, torch.float32), grid,
                       exact_boundaries=True, oracle=oracle, **kw),
            lambda x: np.array([2.0 * np.exp(-0.5 * np.sum(x ** 2)),
                                1.0 - 0.1 * np.sum(x ** 2)]),
            n_iter=4, pipelined=p)[0] for p in (False, True)]
        np.testing.assert_array_equal(xs[0], xs[1])


def test_functional_append_on_cuda_matches_the_host(cuda):
    gp = _mixed_gps(cuda, torch.float32)[1]
    st = gp.factor_state()
    assert st.L.device.type == "cuda" and st.L.dtype == torch.float64
    x = np.array([0.3, -0.7])
    grown = pt.gp.gp_append(gp.kern, st, torch.tensor(x, device=cuda), 0.4)
    gp.append_data(x, 0.4)
    for name in ("L", "Linv", "w"):
        np.testing.assert_allclose(getattr(grown, name).cpu().numpy(),
                                   getattr(gp._host, name), rtol=0,
                                   atol=1e-12)


def test_device_loop_on_cuda_matches_the_cpu_loop(cuda):
    """run_safeopt_loop on the card (float32 step, float64 factors) and on
    the CPU (float64): the same queries up to a first divergence, allowed
    only where the two queries' scaled widths agree within 1e-3."""
    from safeopt_torch.algorithms.runner import run_safeopt_loop

    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2, 120)

    def f(x):
        return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    def g(x):
        return 1.0 - 0.1 * torch.sum(x * x)

    def run(device, dtype):
        gps = _mixed_gps(device, torch.float64)
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa
        return run_safeopt_loop(
            tuple(p.kern for p in gps), tuple(p.factor_state() for p in gps),
            torch.tensor(grid, device=device), t([0.2, 0.5]), 2.0,
            t([np.sqrt(2.0), 1.0]), t([0.0, 0.0]), objectives=(f, g),
            n_iter=6, chunk=32, dtype=dtype)

    on_card, on_cpu = run(cuda, torch.float32), run("cpu", torch.float64)
    assert bool(on_card.has_safe.all())
    assert [int(s.count) for s in on_card.states] == [36, 36]
    agree = (on_card.next_idx.cpu() == on_cpu.next_idx).long().cumprod(0)
    n = int(agree.sum())
    assert n >= 1
    if n < 6:
        # the first divergence is a near-tie of the float64 step's widths
        opt = pt.SafeOpt(_mixed_gps("cpu", torch.float64), grid,
                         fmin=[0.2, 0.5], scaling=[np.sqrt(2.0), 1.0],
                         expander_chunk=32)
        for x in on_cpu.xs[:n].numpy():
            opt.optimize()
            opt.add_new_data_point(x, np.array([[float(f(torch.tensor(x))),
                                                 float(g(torch.tensor(x)))]]))
        opt.optimize()
        w = np.max((opt.Q[:, 1::2] - opt.Q[:, 0::2])
                   / np.array([np.sqrt(2.0), 1.0]), axis=1)
        i, j = int(on_card.next_idx[n]), int(on_cpu.next_idx[n])
        assert abs(w[i] - w[j]) <= 1e-3


# -- the sparse model and hyperparameter fits on the card ------------------

def _sparse_gps(m, device, dtype, n=600, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, size=(n, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=n))[:, None]
    return pt.SparseGPRegression(X, Y, pt.RBF(2, variance=2.0),
                                 noise_var=0.05 ** 2, inducing=m,
                                 device=device, dtype=dtype)


@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sparse_full_capacity_state_on_k1_k3(cuda, m, dtype):
    """The sparse pseudo-factor fills its buffer (count == capacity, which
    no exact state does): K1 against its plain version (float64 to 1e-9,
    float32 decisions outside a band of 1e-3 of the prior std) and K3
    against its plain predicate (float64 identical, float32 outside the
    band) at raised thresholds that leave it mixed."""
    gp = _sparse_gps(m, cuda, dtype)
    st = gp.state
    assert int(st.count) == st.capacity == m
    assert not bool(torch.triu(st.Linv, 1).any())
    grid = torch.tensor(np.random.default_rng(2).uniform(
        -5.0, 5.0, size=(20000, 2)), dtype=dtype, device=cuda)
    ops = fp.interval_operands([gp.kern], [st], grid, 2.0)
    out = fp.fused_intervals(*ops)
    ops64 = [o.double() if torch.is_tensor(o) and o.is_floating_point()
             else o for o in ops]
    ref = fp.fused_intervals_plain(*ops64)
    torch.cuda.synchronize()
    l, l64 = out[0, 0].double(), ref[0, 0]
    if dtype == torch.float64:
        assert (out - ref).abs().max().item() <= 1e-9
    band = 1e-3 * np.sqrt(2.0)
    for fmin in torch.quantile(l64, torch.tensor([0.5, 0.9], device=cuda,
                                                 dtype=torch.float64)):
        outside = (l64 - fmin).abs() > band
        assert torch.equal((l > fmin)[outside], (l64 > fmin)[outside])
    # K3 on 32 safe candidates, 4 padding slots
    fmin = torch.tensor([0.2], dtype=dtype, device=cuda)
    lq, uq = ref[:, 0].to(dtype), ref[:, 1].to(dtype)
    safe = lq[0] > fmin[0]
    safe_idx = torch.nonzero(safe).squeeze(1)
    cand = safe_idx[torch.linspace(0, safe_idx.numel() - 1, 32,
                                   device=cuda).long()]
    valid = torch.ones(32, dtype=torch.bool, device=cuda)
    valid[-4:] = False
    eops = fe.expander_operands([gp.kern], [st], grid, ~safe, (lq + uq) / 2,
                                (uq - lq) / 4, grid[cand], uq[:, cand],
                                valid, 2.0, fmin)
    mixed = False
    for shift in (0.0, 0.003, 0.01, 0.03, 0.1, 0.3):
        scal = eops[9].clone()
        scal[:, 3] += shift
        at = eops[:9] + (scal, eops[10])
        got, want = fe.fused_expander(*at), fe.fused_expander_plain(*at)
        torch.cuda.synchronize()
        assert not bool(got[:, -4:].any())
        hits = want[:, :-4]
        mixed |= bool(hits.any()) and not bool(hits.all())
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            lo, hi = scal.clone(), scal.clone()
            lo[:, 3] -= 1e-3 * np.sqrt(2.0)
            hi[:, 3] += 1e-3 * np.sqrt(2.0)
            decided = (fe.fused_expander_plain(*eops[:9], lo, eops[10])
                       == fe.fused_expander_plain(*eops[:9], hi, eops[10]))
            assert torch.equal(got[decided], want[decided])
    assert mixed


def test_sparse_certified_device_oracle_on_cuda(cuda):
    """The certified path with the device oracle's 'sparse' kind, float64
    on the card against float64 on the CPU: the same S and queries."""
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)] * 2, 100)

    def run(device):
        opt = pt.SafeOpt(_sparse_gps(64, device, torch.float64), grid,
                         fmin=[0.2], scaling=[np.sqrt(2.0)],
                         exact_boundaries=True, oracle="device")
        out = []
        for _ in range(3):
            x = opt.optimize()
            out.append((x, opt.S.copy()))
            opt.add_new_data_point(x, 2.0 * np.exp(-0.5 * np.sum(x ** 2)))
        return out

    for (x_c, s_c), (x_h, s_h) in zip(run(cuda), run("cpu")):
        np.testing.assert_array_equal(s_c, s_h)
        np.testing.assert_array_equal(x_c, x_h)


def test_fit_with_restarts_on_the_card(cuda):
    """device='accel' with restarts runs on the card (the JAX package
    refuses it: a TPU runtime fault), and its Adam steps equal the CPU
    fit's to 1e-8 relative from the same draws."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-3.0, 3.0, size=(60, 2))
    Y = (1.5 * np.exp(-0.5 * np.sum((X / [1.0, 1.8]) ** 2, axis=1))
         + 0.05 * rng.normal(size=60))[:, None]

    def fit(device):
        return pt.gp.fit_hyperparameters(
            pt.RBF(2, variance=0.6, lengthscale=[0.4, 0.4], ARD=True), X, Y,
            0.02, steps=50, restarts=4, seed=3, polish=False, device=device)

    k_c, nv_c, lml_c = fit("accel")
    k_h, nv_h, lml_h = fit("cpu")
    assert k_c.lengthscale.device.type == "cpu"
    np.testing.assert_allclose(lml_c, lml_h, rtol=1e-8)
    np.testing.assert_allclose(k_c.lengthscale.numpy(),
                               k_h.lengthscale.numpy(), rtol=1e-8)
    np.testing.assert_allclose(nv_c, nv_h, rtol=1e-8)
    gp = pt.GPRegression(X, Y, pt.RBF(2, ARD=True), noise_var=0.02)
    lml0 = gp.log_likelihood()
    assert gp.optimize_restarts(num_restarts=2, max_iters=30) > lml0
    sp = pt.SparseGPRegression(X, Y, pt.RBF(2), noise_var=0.02, inducing=16)
    lml0 = sp.log_likelihood()
    assert sp.optimize(max_iters=30) > lml0


# -- SafeOptSwarm: the fused iteration as a CUDA graph ------------------------

def _swarm_streams(opt, rng):
    from safeopt_torch.algorithms.swarm_opt_fused import stream_layout

    return {name: rng.uniform(size=shape) for name, shape in stream_layout(
        opt.swarm_size, opt.max_iters, opt.gp.input_dim)}


class _SeededSwarm(pt.SafeOptSwarm):
    def feed(self, seed):
        self._rng = np.random.default_rng(seed)
        return self

    def _fused_streams(self, ucb=False):
        return _swarm_streams(self, self._rng)


def _swarm_gps(sparse=False, capacity=4, dtype=torch.float32):
    rng = np.random.default_rng(2)
    X = rng.uniform(-0.5, 0.5, size=(3, 3))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    Yg = (1.0 - 0.05 * np.sum(X ** 2, axis=1))[:, None]
    if sparse:
        return [pt.SparseGPRegression(X, Yf, pt.RBF(3, variance=2.0),
                                      noise_var=0.01, inducing=3,
                                      dtype=dtype)]
    return [pt.GPRegression(X, Yf, pt.RBF(3, variance=2.0, lengthscale=2.0),
                            noise_var=0.01, capacity=capacity, dtype=dtype),
            pt.GPRegression(X, Yg, pt.Matern32(3, lengthscale=3.0),
                            noise_var=0.01, capacity=capacity, dtype=dtype)]


def _swarm_plant(x, n_gps):
    r2 = float(np.sum(x ** 2))
    return np.array([[2.0 * np.exp(-0.5 * r2), 1.0 - 0.05 * r2][:n_gps]])


@pytest.mark.parametrize("sparse", [False, True], ids=["exact", "sparse"])
def test_swarm_graph_equals_eager_across_appends_and_growth(cuda, sparse):
    """The replayed graph and the eager fused iteration, fed the same
    uniforms, give the same query and the same diagnostics at every step:
    after each append (written in place into the exact model's state, or
    a sparse model's whole new state) and after the exact models'
    capacity grows (4 -> 8 -> 16, each a new graph). Every
    dispatch runs under set_sync_debug_mode('error')."""
    kw = dict(fmin=[0.0] if sparse else [-np.inf, 0.0],
              bounds=[(-2.0, 2.0)] * 3, swarm_size=10, max_iters=20)
    twins = [_SeededSwarm(_swarm_gps(sparse), graph=graph, **kw).feed(5)
             for graph in (True, False)]
    for step in range(6):
        outs = []
        for opt in twins:
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = opt.optimize_async()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            outs.append((pending.result(), pending._diag.clone()))
        (x_g, d_g), (x_e, d_e) = outs
        np.testing.assert_array_equal(x_g, x_e, err_msg=f"step {step}")
        torch.testing.assert_close(d_g, d_e, rtol=1e-6, atol=0)
        for opt in twins:
            opt.add_new_data_point(x_g, _swarm_plant(x_g, len(opt.gps)))
    graph = twins[0]
    assert graph.graph_replays == 6 and graph.graph_captures >= 1
    assert all(s.host_syncs == 1 and s.graph for s in graph.stats.history)
    if not sparse:
        assert graph.gps[0].state.capacity > 4 and graph.graph_captures >= 2
    np.testing.assert_array_equal(twins[0].S, twins[1].S)


def test_swarm_graph_reads_the_models_current_factor(cuda):
    """A graph replayed on a model that changed since its capture gives the
    eager iteration's output on the new model, not the old one's: a graph
    that read a stale factor would give the old output."""
    from safeopt_torch.algorithms.swarm_opt_fused import (
        FusedSwarmGraph, fused_swarm_optimize)

    opt = _SeededSwarm(_swarm_gps(capacity=16), fmin=[-np.inf, 0.0],
                       bounds=[(-2.0, 2.0)] * 3, swarm_size=10,
                       max_iters=20).feed(3)
    args, kw = opt._fused_args()
    graph = FusedSwarmGraph(*args, **kw)
    old = fused_swarm_optimize(*args, **kw).diag.clone()
    torch.testing.assert_close(graph.replay(*args).diag, old, rtol=1e-6,
                               atol=0)
    x = old[:3].cpu().numpy().astype(float)
    opt.add_new_data_point(x, _swarm_plant(x, 2))      # rows in place
    kernels, states = opt._model_args()
    args = (kernels, states) + args[2:]
    new = fused_swarm_optimize(*args, **kw).diag
    assert not torch.equal(new, old)
    torch.testing.assert_close(graph.replay(*args).diag, new, rtol=1e-6,
                               atol=0)


def test_swarm_float64_card_matches_cpu(cuda):
    """The same uniforms in float64: the card's replayed graph and the
    CPU's eager iteration give the same queries to 1e-9."""
    kw = dict(fmin=[-np.inf, 0.0], bounds=[(-2.0, 2.0)] * 3, swarm_size=10,
              max_iters=20)
    runs = {}
    for device in (cuda, "cpu"):
        gps = _swarm_gps(dtype=torch.float64)
        if device == "cpu":
            gps = [pt.GPRegression(g.X_host, g.Y_host, g.kern, noise_var=0.01,
                                   capacity=4, device="cpu") for g in gps]
        opt = _SeededSwarm(gps, **kw).feed(8)
        xs = []
        for _ in range(4):
            x = opt.optimize()
            xs.append(x)
            opt.add_new_data_point(x, _swarm_plant(x, 2))
        runs[str(device)] = np.array(xs)
    np.testing.assert_allclose(runs[str(cuda)], runs["cpu"], atol=1e-9)


def test_swarm_loop_runs_sync_free_and_matches_eager(cuda):
    """run_swarmopt_loop with its graph under set_sync_debug_mode('error')
    gives the eager loop's queries on the same uniforms and normals."""
    from safeopt_torch.algorithms.runner import run_swarmopt_loop
    from safeopt_torch.algorithms.swarm_opt_fused import stream_layout

    gps = _swarm_gps(capacity=16)
    opt = pt.SafeOptSwarm(gps, fmin=[-np.inf, 0.0], bounds=[(-2.0, 2.0)] * 3,
                          swarm_size=10, max_iters=20)
    opt.reserve(5)
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(10, 20, 3))
    flat = torch.rand((5, n_u), generator=torch.Generator(cuda).manual_seed(1),
                      device=cuda)
    objectives = (lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x)),
                  lambda x: 1.0 - 0.05 * torch.sum(x * x))

    states = {graph: tuple(g.factor_state() for g in gps)
              for graph in (True, False)}

    def run(graph):
        return run_swarmopt_loop(
            tuple(g.kern for g in gps), states[graph], opt._S_dev,
            opt.optimal_velocities, opt._bounds_arr, opt.fmin, opt.scaling,
            [0.0, 0.0], [2.0] * 5, opt.greedy_point, -np.inf, flat,
            torch.Generator(cuda).manual_seed(2),
            objectives=objectives, n_iter=5, swarm_size=10, max_iters=20,
            noise_std=0.01, graph=graph)

    torch.cuda.set_sync_debug_mode("error")
    try:
        with_graph = run(True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = run(False)
    torch.testing.assert_close(with_graph.xs, eager.xs, rtol=0, atol=1e-6)
    assert with_graph.host_syncs.tolist() == [0] * 5
    assert [int(s.count) for s in with_graph.states] == [8, 8]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_expander_fleet_launch_matches_plain_and_solo_launches(cuda, dtype):
    """K3 with a mask per campaign: three campaigns of two RBF GPs, the
    second campaign's mask a random half of the first's and the third's
    all False. The fleet launch equals the three single-mask launches
    bitwise, its plain version in float64 (in float32 outside the 1e-3
    band), and the all-False campaign's rows are all False."""
    gps, grid = _gps("RBF", 2, 64, cuda, dtype)
    kerns, states = [g.kern for g in gps], [g.state for g in gps]
    fmin = torch.tensor([0.4, 0.6], dtype=dtype, device=cuda)
    beta = 2.0
    out = fp.fused_intervals_plain(*fp.interval_operands(kerns, states, grid,
                                                         beta))
    l, u = out[:, 0], out[:, 1]
    mu, sigma = (l + u) / 2, (u - l) / (2 * beta)
    safe = torch.all(l > fmin[:, None], dim=0)
    half = torch.rand(safe.shape, generator=torch.Generator(cuda)
                      .manual_seed(0), device=cuda) < 0.5
    masks = torch.stack([~safe, ~safe & half, torch.zeros_like(safe)])
    safe_idx = torch.nonzero(safe).squeeze(1)
    cand = safe_idx[torch.linspace(0, safe_idx.numel() - 1, 37,
                                   device=cuda).long()]
    valid = torch.ones(cand.numel(), dtype=torch.bool, device=cuda)
    valid[-1] = False
    solo = [fe.expander_operands(kerns, states, grid, m, mu, sigma,
                                 grid[cand], u[:, cand], valid, beta, fmin)
            for m in masks]
    fleet = tuple(torch.cat([o[i] for o in solo]) if 2 <= i <= 9
                  else solo[0][i] for i in range(11))
    fleet = fleet[:1] + (masks,) + fleet[2:]

    def at(ops, shift):
        scal = ops[9].clone()
        scal[:, 3] += shift
        return ops[:9] + (scal, ops[10])

    seen = set()
    for shift in (0.0, 0.3, 1.0):
        got = fe.fused_expander(*at(fleet, shift))
        each = torch.cat([fe.fused_expander(*at(o, shift)) for o in solo])
        want = fe.fused_expander_plain(*at(fleet, shift))
        torch.cuda.synchronize()
        assert torch.equal(got, each)
        assert not bool(got[4:].any()) and not bool(got[:, -1].any())
        seen.update(want[:4, :-1].flatten().tolist())
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            decided = (fe.fused_expander_plain(*at(fleet, shift - 1e-3))
                       == fe.fused_expander_plain(*at(fleet, shift + 1e-3)))
            assert not bool(((got != want) & decided).any())
    assert seen == {True, False}


def test_swarm_fleet_graph_equals_eager_sync_free(cuda):
    """run_swarmopt_campaigns replaying one CUDA graph per fleet step, under
    set_sync_debug_mode('error'), gives its batched eager run's queries
    and safe sets bitwise, captures one graph and launches no grid
    kernel."""
    from safeopt_torch.algorithms.swarm_opt_fused import stream_layout
    from safeopt_torch.parallel import (run_swarmopt_campaigns,
                                        stack_campaign_states)

    K, n_iter = 3, 4
    per, iters, greedy = [], [], []
    for k in range(K):
        gps = _swarm_gps(capacity=16)
        opt = pt.SafeOptSwarm(gps, fmin=[-np.inf, 0.0],
                              bounds=[(-2.0, 2.0)] * 3, swarm_size=10,
                              max_iters=20)
        opt.reserve(n_iter)
        per.append(tuple(g.factor_state() for g in gps))
        iters.append(opt._S_dev)
        greedy.append(torch.as_tensor(opt.greedy_point, dtype=torch.float32))
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(10, 20, 3))
    flat = torch.rand((K, n_iter, n_u),
                      generator=torch.Generator(cuda).manual_seed(4),
                      device=cuda)
    objectives = (lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x)),
                  lambda x: 1.0 - 0.05 * torch.sum(x * x))
    graphs = {}

    def run(graph):
        return run_swarmopt_campaigns(
            tuple(g.kern for g in gps), stack_campaign_states(per),
            stack_campaign_states(iters), opt.optimal_velocities,
            opt._bounds_arr, opt.fmin, opt.scaling, [0.0, 0.0],
            [2.0] * n_iter, torch.stack(greedy), torch.full((K,), -np.inf),
            flat, objectives=objectives, n_iter=n_iter, swarm_size=10,
            max_iters=20, graph=graph, graph_cache=graphs)

    before = (fp.fused_intervals.launches, fe.fused_expander.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with_graph = run(True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = run(False)
    assert torch.equal(with_graph.xs, eager.xs)
    assert torch.equal(with_graph.iter_state.S, eager.iter_state.S)
    assert len(graphs) == 1 and with_graph.host_syncs.tolist() == [0] * n_iter
    assert (fp.fused_intervals.launches, fe.fused_expander.launches) == before
    assert [c.tolist() for c in (s.count for s in with_graph.states)] == \
        [[3 + n_iter] * K] * 2


# -- K1-K4 as torch.library operators, and a loaded artifact ------------------
#
# The operators' implementation is each kernel's wrapper: on the same
# operands they give the launcher's bits and count their launches. An
# artifact exported on the card launches the kernels through them and
# gives the live step's decisions and intervals bit for bit.

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_library_ops_match_their_launchers(cuda, dtype):
    from safeopt_torch.ops import library

    gps, grid = _gps("RBF", 2, 64, cuda, dtype)
    kerns, states = [g.kern for g in gps], [g.state for g in gps]
    k1 = fp.interval_operands(kerns, states, grid, 2.0)
    Q = fp.fused_intervals(*k1)
    mu, sigma = (Q[:, 0] + Q[:, 1]) * 0.5, (Q[:, 1] - Q[:, 0]) / 4.0
    unsafe = Q[:, 0].amin(dim=0) < 0.4
    Xc, ucs = grid[:32], Q[:, 1, :32]
    valid = torch.ones(32, dtype=torch.bool, device=cuda)
    fmin = torch.tensor([0.4, 0.6], dtype=dtype, device=cuda)
    k3 = fe.expander_operands(kerns, states, grid, unsafe, mu, sigma, Xc,
                              ucs, valid, 2.0, fmin)
    cgps = [pt.GPRegression(g.X_host, g.Y_host,
                            pt.RBF(1, active_dims=[0])
                            * pt.RBF(1, active_dims=[1]),
                            noise_var=0.01, capacity=64, device=cuda,
                            dtype=dtype) for g in gps[:1]]
    k2 = fp.interval_plan_operands(cgps[0].kern, cgps[0].state, grid, 2.0)
    k4 = fe.expander_plan_operands(cgps[0].kern, cgps[0].state, grid, unsafe,
                                   mu[0], sigma[0], Xc, ucs[0], valid, 2.0,
                                   fmin[0])
    pairs = [(library.fused_intervals, fp.fused_intervals, k1),
             (library.fused_intervals_plan, fp.fused_intervals_plan, k2),
             (library.fused_expander, fe.fused_expander, k3),
             (library.fused_expander_plan, fe.fused_expander_plan, k4)]
    for op, launcher, ops in pairs:
        before = launcher.launches
        assert torch.equal(op(*ops), launcher(*ops))
        assert launcher.launches == before + 2     # the op's launch counts


def test_loaded_step_matches_the_live_step_on_cuda(cuda, tmp_path):
    from safeopt_torch.utils.deployment import (device_kernels, export_step,
                                                load_step)

    gps, grid = _gps("RBF", 2, 64, cuda, torch.float32, seed=3)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda)  # noqa
    kernels = tuple(g.kern for g in gps)
    args = [kernels, tuple(g.state for g in gps), grid, t([0.3, 0.5]),
            t(2.0), t([np.sqrt(2.0), np.sqrt(1.5)]), t([0.0, 0.0])]
    live = core.safeopt_step(*args[:4], 2.0, *args[5:], chunk=16)
    args[0] = device_kernels(kernels, cuda)
    export_step(*args, chunk=16, path=str(tmp_path / "step.pt2"))
    served = load_step(tmp_path / "step.pt2")
    k1, k3 = fp.fused_intervals.launches, fe.fused_expander.launches
    out = served(*args)
    torch.cuda.synchronize()
    for name in ("Q", "S", "M", "G", "next_idx"):
        assert torch.equal(getattr(out, name), getattr(live, name)), name
    assert fp.fused_intervals.launches == k1 + 1
    assert fe.fused_expander.launches == k3 + int(out.walk_chunks)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padded_step_on_cuda_matches_the_unpadded_step(cuda, dtype):
    """``num_valid`` on the card: a grid with 3 copies of its last row
    appended gives the unpadded step's S, M, G and next_idx on K1/K3, and
    no padding row is safe or chosen."""
    gps, grid = _gps("RBF", 2, 64, cuda, dtype, seed=5)
    t = lambda v: torch.tensor(v, dtype=dtype, device=cuda)  # noqa: E731
    args = (tuple(g.kern for g in gps), tuple(g.state for g in gps))
    consts = (t([0.3, 0.5]), 2.0, t([np.sqrt(2.0), np.sqrt(1.5)]),
              t([0.0, 0.0]))
    ref = core.safeopt_step(*args, grid, *consts, chunk=16)
    N = grid.shape[0]
    padded = torch.cat([grid, grid[-1:].expand(3, -1)])
    k1 = fp.fused_intervals.launches
    res = core.safeopt_step(*args, padded, *consts, None, N, chunk=16)
    assert fp.fused_intervals.launches == k1 + 1
    for name in ("S", "M", "G"):
        assert torch.equal(getattr(res, name)[:N], getattr(ref, name)), name
    assert not res.S[N:].any() and int(res.next_idx) == int(ref.next_idx)


def test_native_engine_builds_on_the_card_host(cuda):
    """The card's host builds the native float64 engine, and a model on
    the card factors through it."""
    from safeopt_torch import native

    assert native.available()
    gps, _ = _gps("RBF", 1, 32, cuda, torch.float64)
    assert gps[0]._host._use_native and gps[0]._host._kind() == "rbf"

"""The PyTorch port's SafeOpt against safeopt_tpu and the NumPy reference.

Float64 on the CPU throughout. ``safeopt_step`` must give the JAX
step's S/M/G masks and ``next_idx`` exactly, and its intervals to
round-off (atol 1e-10), when both packages hold the identical host
factor (carried across with ``safeopt_torch.convert``). The golden
configurations of ``tests/test_safeopt.py`` that the port's slice covers
run three-way in lockstep — port, ``safeopt_tpu.SafeOpt`` and
``reference_impl.RefSafeOpt`` — and must query identical points (atol
1e-9, as the JAX golden tests require).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import safe_opt as psafe
from safeopt_torch.algorithms import safe_opt_core as pcore
from safeopt_torch.convert import (gp_arrays, gp_from_arrays,
                                   kernel_from_params, kernel_params)
from safeopt_torch.ops import fused_posterior as pfp
from safeopt_tpu.algorithms import safe_opt_core as jcore

from reference_impl import RefGP, RefMatern32, RefRBF, RefSafeOpt

import torch


def rkhs_fn(kern_eval, centers, weights):
    """Deterministic test function f(x) = sum_j w_j k(x, c_j)."""
    centers = np.atleast_2d(np.asarray(centers, dtype=float))
    weights = np.asarray(weights, dtype=float)

    def f(x):
        return kern_eval(np.atleast_2d(np.asarray(x, dtype=float)),
                         centers) @ weights

    return f


def _triple(kerns, x0, fns, noise_var, grid, capacity=None, **opt_kw):
    """The same problem as (port, JAX, reference) optimizers."""
    def gps(pkg):
        where = dict(device="cpu") if pkg is pt else {}
        out = []
        for (cls, kw), fn in zip(kerns, fns):
            kern = getattr(pkg, cls)(x0.shape[1], **kw)
            out.append(pkg.GPRegression(x0, fn(x0)[:, None], kern,
                                        noise_var=noise_var,
                                        capacity=capacity, **where))
        return out

    ref_cls = {"RBF": RefRBF, "Matern32": RefMatern32}
    rgps = [RefGP(x0, fn(x0)[:, None], ref_cls[cls](x0.shape[1], **kw),
                  noise_var=noise_var) for (cls, kw), fn in zip(kerns, fns)]
    return (pt.SafeOpt(gps(pt), grid, **opt_kw),
            jt.SafeOpt(gps(jt), grid, **opt_kw),
            RefSafeOpt(rgps, grid, **opt_kw))


def _golden_1d():
    kw = dict(variance=2.0, lengthscale=1.0, ARD=True)
    f = rkhs_fn(RefRBF(1, **kw).K, [[-4.0], [-1.0], [0.0], [2.0], [5.0]],
                [1.5, -1.0, 2.0, 1.0, -2.0])
    grid = pt.linearly_spaced_combinations([(-10.0, 10.0)], 500)
    return _triple([("RBF", kw)], np.array([[0.0]]), [f], 0.05 ** 2, grid,
                   fmin=[0.0], threshold=0.2), [f], 10


def _golden_lipschitz():
    kw = dict(variance=2.0, lengthscale=1.0, ARD=True)
    f = rkhs_fn(RefRBF(1, **kw).K, [[-4.0], [-1.0], [0.0], [2.0], [5.0]],
                [1.5, -1.0, 2.0, 1.0, -2.0])
    grid = pt.linearly_spaced_combinations([(-10.0, 10.0)], 500)
    return _triple([("RBF", kw)], np.array([[0.0]]), [f], 0.05 ** 2, grid,
                   fmin=[0.0], lipschitz=1.5, threshold=0.2), [f], 8


def _golden_multi_constraint():
    kf, kg = dict(variance=2.0), dict(variance=1.5)
    f = rkhs_fn(RefRBF(1, **kf).K, [[-3.0], [0.0], [3.0]], [1.0, 1.5, -1.0])
    g = rkhs_fn(RefMatern32(1, **kg).K, [[-2.0], [0.0], [4.0]],
                [-0.5, 2.0, -1.5])
    grid = pt.linearly_spaced_combinations([(-8.0, 8.0)], 400)
    return _triple([("RBF", kf), ("Matern32", kg)], np.array([[0.0]]),
                   [f, g], 1e-5, grid, fmin=[-np.inf, 0.0],
                   threshold=0.1), [f, g], 10


def _golden_2d():
    kw = dict(variance=2.0, lengthscale=1.0, ARD=True)
    f = rkhs_fn(RefRBF(2, **kw).K,
                [[0.0, 0.0], [2.0, 1.0], [-2.0, -1.5], [1.0, -2.0]],
                [2.0, 1.2, -1.0, -1.5])
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 25)
    return _triple([("RBF", kw)], np.array([[0.0, 0.0]]), [f], 0.05 ** 2,
                   grid, fmin=[0.0], threshold=0.2), [f], 8


def _golden_matern_objective():
    kw = dict(variance=2.0, lengthscale=1.2)
    f = rkhs_fn(RefMatern32(1, **kw).K, [[-2.0], [0.0], [3.0]],
                [1.0, 1.8, -0.8])
    grid = pt.linearly_spaced_combinations([(-6.0, 6.0)], 250)
    return _triple([("Matern32", kw)], np.array([[0.0]]), [f], 1e-3, grid,
                   fmin=[0.0], threshold=0.1), [f], 8


def _golden_three_gps():
    kws = [("RBF", dict(variance=2.0)),
           ("RBF", dict(variance=1.0, lengthscale=1.5)),
           ("Matern32", dict(variance=1.5))]
    f = rkhs_fn(RefRBF(1, variance=2.0).K, [[0.0], [2.0]], [2.0, 1.0])
    g1 = rkhs_fn(RefRBF(1, variance=1.0, lengthscale=1.5).K,
                 [[0.0], [-3.0]], [1.5, 1.0])
    g2 = rkhs_fn(RefMatern32(1, variance=1.5).K, [[0.5], [4.0]],
                 [1.8, -1.0])
    grid = pt.linearly_spaced_combinations([(-6.0, 6.0)], 200)
    return _triple(kws, np.array([[0.0]]), [f, g1, g2], 1e-4, grid,
                   fmin=[-np.inf, 0.0, 0.0], threshold=0.1), [f, g1, g2], 6


def _golden_long_trajectory():
    kw = dict(variance=2.0)
    f = rkhs_fn(RefRBF(1, **kw).K, [[-4.0], [-1.5], [0.0], [1.5], [4.0]],
                [1.0, -0.8, 2.0, 1.2, -1.5])
    grid = pt.linearly_spaced_combinations([(-8.0, 8.0)], 160)
    # capacity 16 forces two capacity growths over 30 observations
    return _triple([("RBF", kw)], np.array([[0.0]]), [f], 1e-3, grid,
                   capacity=16, fmin=[0.0], threshold=0.05), [f], 30


def _golden_nine_leaves():
    """Test2D's problem with its kernel written as a product of nine
    RBF(2) leaves of lengthscale 3 (one leaf past K2's static plan: the
    wide kernel instances on the card), the same function as one RBF of
    lengthscale 1: the port and safeopt_tpu take the product, the
    reference the single RBF."""
    kw = dict(variance=2.0, lengthscale=1.0, ARD=True)
    f = rkhs_fn(RefRBF(2, **kw).K,
                [[0.0, 0.0], [2.0, 1.0], [-2.0, -1.5], [1.0, -2.0]],
                [2.0, 1.2, -1.0, -1.5])
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 25)
    # off the grid's symmetry axes: from (0, 0) the second query is an
    # exact tie of mirrored widths, which the product's rounding breaks
    # one way and the single RBF's the other
    x0 = np.array([[0.3, -0.1]])

    def product(pkg):
        kern = pkg.RBF(2, variance=2.0, lengthscale=3.0)
        for _ in range(pfp.MAX_LEAVES):
            kern = kern * pkg.RBF(2, lengthscale=3.0)
        return kern

    opt_kw = dict(fmin=[0.0], threshold=0.2)
    port = pt.SafeOpt(pt.GPRegression(x0, f(x0)[:, None], product(pt),
                                      noise_var=0.05 ** 2, device="cpu"),
                      grid, **opt_kw)
    jax_opt = jt.SafeOpt(jt.GPRegression(x0, f(x0)[:, None], product(jt),
                                         noise_var=0.05 ** 2), grid, **opt_kw)
    ref = RefSafeOpt(RefGP(x0, f(x0)[:, None], RefRBF(2, **kw),
                           noise_var=0.05 ** 2), grid, **opt_kw)
    return (port, jax_opt, ref), [f], 8


GOLDEN = {
    "Test1D": _golden_1d,
    "Test1D_lipschitz": _golden_lipschitz,
    "TestMultiConstraint": _golden_multi_constraint,
    "Test2D": _golden_2d,
    "TestMaternObjective": _golden_matern_objective,
    "TestThreeGPs": _golden_three_gps,
    "TestLongTrajectory": _golden_long_trajectory,
    "TestNineLeafProduct": _golden_nine_leaves,
}


@pytest.mark.parametrize("config", sorted(GOLDEN))
def test_golden_trajectory_three_way(config):
    (port, jax_opt, ref), fns, iters = GOLDEN[config]()
    for it in range(iters):
        x = np.asarray(port.optimize())
        xj = np.asarray(jax_opt.optimize())
        xr = np.asarray(ref.optimize())
        assert_allclose(x, xr, atol=1e-9,
                        err_msg=f"port vs reference at iteration {it}")
        assert_allclose(x, xj, atol=1e-9,
                        err_msg=f"port vs safeopt_tpu at iteration {it}")
        y = np.array([[float(fn(x)[0]) for fn in fns]])
        for opt in (port, jax_opt, ref):
            opt.add_new_data_point(x, y)
    np.testing.assert_array_equal(port.S, ref.S)
    np.testing.assert_array_equal(port.S, jax_opt.S)
    np.testing.assert_array_equal(port.M, ref.M)
    np.testing.assert_array_equal(port.G, ref.G)
    assert_allclose(port.Q, ref.Q, rtol=1e-7, atol=1e-9)
    if config == "TestLongTrajectory":
        assert port.gp.num_data == 31
        assert port.gp.state.capacity >= 32


def test_get_maximum_and_ucb_parity():
    (port, _, ref), fns, _ = _golden_1d()
    for _ in range(3):
        x = np.asarray(port.optimize(ucb=True))
        assert_allclose(x, ref.optimize(ucb=True), atol=1e-9)
        y = float(fns[0](x)[0])
        port.add_new_data_point(x, y)
        ref.add_new_data_point(x, y)
    x, lb = port.get_maximum()
    xr, lbr = ref.get_maximum()
    assert_allclose(x, xr, atol=1e-9)
    assert_allclose(lb, lbr, rtol=1e-8)


def test_full_sets_parity():
    (port, _, ref), fns, _ = _golden_1d()
    for _ in range(4):
        x = np.asarray(port.optimize())
        y = float(fns[0](x)[0])
        ref.optimize()
        port.add_new_data_point(x, y)
        ref.add_new_data_point(x, y)
    port.update_confidence_intervals()
    port.compute_sets(full_sets=True)
    ref.update_confidence_intervals()
    ref.compute_sets(full_sets=True)
    np.testing.assert_array_equal(port.S, ref.S)
    np.testing.assert_array_equal(port.M, ref.M)
    np.testing.assert_array_equal(port.G, ref.G)
    assert port.G.sum() >= 1


# -- contextual golden configs (tests/test_safeopt.py) -----------------------

def _context_kernel(pkg, ctx_dims):
    """The context_example kernel: RBF on the parameter column times RBF
    on the context columns (K2/K4 on the port)."""
    rbf = RefRBF if pkg is None else pkg.RBF
    return (rbf(1, variance=2.0, active_dims=[0])
            * rbf(len(ctx_dims), variance=1.0, lengthscale=2.0,
                  active_dims=ctx_dims))


def _context_triple(ctx_dims, centers, weights, params, noise_var, **kw):
    """(port, JAX, reference) contextual optimizers and the function."""
    f = rkhs_fn(_context_kernel(None, ctx_dims).K, centers, weights)
    x0 = np.zeros((1, 1 + len(ctx_dims)))      # parameter 0 at context 0
    assert f(x0)[0] > 0.5
    y0 = f(x0)[:, None]
    port = pt.SafeOpt(pt.GPRegression(x0, y0, _context_kernel(pt, ctx_dims),
                                      noise_var=noise_var, device="cpu"),
                      params, fmin=[0.0], num_contexts=len(ctx_dims), **kw)
    jax_opt = jt.SafeOpt(jt.GPRegression(x0, y0,
                                         _context_kernel(jt, ctx_dims),
                                         noise_var=noise_var),
                         params, fmin=[0.0], num_contexts=len(ctx_dims), **kw)
    ref = RefSafeOpt(RefGP(x0, y0, _context_kernel(None, ctx_dims),
                           noise_var=noise_var),
                     params, fmin=[0.0], num_contexts=len(ctx_dims), **kw)
    return (port, jax_opt, ref), f


def _context_steps(opts, f, context, iters):
    for it in range(iters):
        x = np.asarray(opts[0].optimize(context=context))
        for other, name in zip(opts[1:], ("safeopt_tpu", "reference")):
            assert_allclose(x, np.asarray(other.optimize(context=context)),
                            atol=1e-9, err_msg=f"port vs {name} at {it}")
        y = float(f(np.concatenate([x, np.atleast_1d(context)])[None])[0])
        for opt in opts:
            opt.add_new_data_point(x, y, context=context)


def test_context_switch_three_way():
    """TestContext.test_trajectory_parity: context 0 for 4 iterations,
    then 0.1 for 4, then the safe maximum at 0.1."""
    opts, f = _context_triple([1], [[0.0, 0.0], [2.0, 0.5], [-3.0, 0.0]],
                              [2.0, 1.0, -1.0],
                              pt.linearly_spaced_combinations(
                                  [(-5.0, 5.0)], 200),
                              0.05 ** 2, threshold=0.1)
    before = pfp.fused_intervals_plan.launches
    _context_steps(opts, f, 0.0, 4)
    _context_steps(opts, f, 0.1, 4)
    assert pfp.fused_intervals_plan.launches == before     # plain on CPU
    (xm, ym), (xj, yj), (xr, yr) = (o.get_maximum(context=0.1)
                                    for o in opts)
    assert_allclose(np.asarray(xm), xr, atol=1e-9)
    assert_allclose(np.asarray(xm), np.asarray(xj), atol=1e-9)
    assert_allclose(ym, yr, rtol=1e-8)
    assert_allclose(opts[0].scaling, [np.sqrt(2.0)])   # prior std at 0


def test_two_context_columns_three_way():
    """TestMultipleContexts.test_two_context_columns."""
    opts, f = _context_triple([1, 2], [[0.0, 0.0, 0.0], [1.5, 0.3, -0.2]],
                              [2.0, 1.0],
                              pt.linearly_spaced_combinations(
                                  [(-3.0, 3.0)], 120), 1e-3)
    ctx = np.array([0.2, -0.1])
    _context_steps(opts, f, ctx, 4)
    assert opts[0].inputs.shape[1] == 3
    assert_allclose(opts[0].context, ctx)


def test_compute_sets_after_contextual_optimize_three_way():
    """TestAdvisorRegressions.test_compute_sets_after_contextual_optimize:
    compute_sets keeps the current context."""
    opts, _ = _context_triple([1], [[0.0, 0.0], [2.0, 0.5]], [2.0, 1.0],
                              pt.linearly_spaced_combinations(
                                  [(-5.0, 5.0)], 100),
                              0.05 ** 2, threshold=0.1)
    for opt in opts:
        opt.optimize(context=0.3)
        opt.compute_sets()
    port, jax_opt, ref = opts
    assert_allclose(port.context, [0.3])
    for name in ("S", "M", "G"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(jax_opt, name)),
                                      err_msg=name)
    with pytest.raises(ValueError):
        port.optimize(context=None)


# -- safeopt_step against the JAX step on random problems -----------------

def _random_problem(seed, d, n_obs, n_grid):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_obs, d))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
          + 0.05 * rng.normal(size=n_obs))[:, None]
    Yg = (1.2 - 0.15 * np.sum(X ** 2, axis=1)
          + 0.05 * rng.normal(size=n_obs))[:, None]
    grid = rng.uniform(-4.0, 4.0, size=(n_grid, d))
    kerns = [jt.RBF(d, variance=2.0, lengthscale=0.8),
             jt.Matern52(d, variance=1.0, lengthscale=1.2)
             if seed % 2 else jt.RBF(d, variance=1.0, lengthscale=1.2)]
    jgps = [jt.GPRegression(X, Y, k, noise_var=0.05 ** 2)
            for Y, k in zip((Yf, Yg), kerns)]
    pgps = [gp_from_arrays(kernel_from_params(**kernel_params(g.kern)),
                           **gp_arrays(g), device="cpu") for g in jgps]
    return jgps, pgps, grid


@pytest.mark.parametrize("seed,d", [(0, 1), (1, 1), (2, 2), (3, 2)])
def test_safeopt_step_matches_jax(seed, d):
    jgps, pgps, grid = _random_problem(seed, d, n_obs=12, n_grid=600)
    fmin, beta, scaling = [0.0, 0.3], 2.0, [np.sqrt(2.0), 1.0]
    rj = jcore.safeopt_step(
        tuple(g.kern for g in jgps), tuple(g.state for g in jgps),
        jnp.asarray(grid), jnp.asarray(fmin), jnp.asarray(beta),
        jnp.asarray(scaling), jnp.asarray([0.0, 0.0]), chunk=8)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    rp = pcore.safeopt_step(
        tuple(g.kern for g in pgps), tuple(g.state for g in pgps), t(grid),
        t(fmin), beta, t(scaling), t([0.0, 0.0]), chunk=8)
    assert_allclose(rp.Q.numpy(), np.asarray(rj.Q), rtol=0, atol=1e-10)
    for name in ("S", "M", "G"):
        np.testing.assert_array_equal(getattr(rp, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    assert int(rp.next_idx) == int(rj.next_idx)
    np.testing.assert_array_equal(rp.diag.numpy(), np.asarray(rj.diag))


@pytest.mark.parametrize("chunk", [1, 4])
def test_expander_walk_past_first_chunk_matches_jax(chunk):
    """Small chunks make the walk run many rounds (62 at chunk 1 on this
    problem): the full visit order, computed once after round 0, must
    pick the JAX walk's expander."""
    jgps, pgps, grid = _random_problem(1, 1, n_obs=12, n_grid=600)
    fmin, scaling = [0.0, 0.6], [np.sqrt(2.0), 1.0]
    args_j = (tuple(g.kern for g in jgps), tuple(g.state for g in jgps),
              jnp.asarray(grid), jnp.asarray(fmin), jnp.asarray(2.0),
              jnp.asarray(scaling), jnp.asarray([0.0, 0.0]))
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    args_p = (tuple(g.kern for g in pgps), tuple(g.state for g in pgps),
              t(grid), t(fmin), 2.0, t(scaling), t([0.0, 0.0]))
    rj = jcore.safeopt_step(*args_j, chunk=chunk)
    rp = pcore.safeopt_step(*args_p, chunk=chunk)
    np.testing.assert_array_equal(rp.G.numpy(), np.asarray(rj.G))
    assert rp.G.any() and rp.walk_chunks >= 2
    assert int(rp.next_idx) == int(rj.next_idx)


# -- error probes ------------------------------------------------------------

def _port_opt(y0=1.5, **kw):
    gp = pt.GPRegression(np.array([[0.0]]), np.array([[y0]]),
                         pt.RBF(1, variance=2.0), noise_var=1e-3,
                         device="cpu")
    grid = pt.linearly_spaced_combinations([(-4.0, 4.0)], 100)
    return pt.SafeOpt(gp, grid, fmin=[0.0], **kw)


def test_unsafe_seed_raises():
    with pytest.raises(EnvironmentError):
        _port_opt(y0=-5.0).optimize()


def test_scaling_length_mismatch_raises():
    with pytest.raises(ValueError):
        _port_opt(scaling=[1.0, 2.0])


def test_lipschitz_without_constants_raises():
    opt = _port_opt()
    with pytest.raises(ValueError):
        opt.use_lipschitz = True


def test_add_then_remove_gives_same_query():
    opt = _port_opt()
    x1 = np.asarray(opt.optimize())
    opt.add_new_data_point(x1, 1.0)
    opt.optimize()
    opt.remove_last_data_point()
    assert_allclose(np.asarray(opt.optimize()), x1, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(exact_boundaries=True),
                                dict(interval_precision="high"),
                                dict(oracle="device"),
                                dict(boundary_band=1e-2),
                                dict(boundary_k=512), dict(refine_k=0),
                                dict(refine_band=0.1),
                                dict(refine_band_k=1024)])
def test_certified_requests_raise(kw):
    """Each request that raised NotImplementedError before the certified
    path was ported now resolves as safeopt_tpu resolves it and steps;
    only its invalid combinations raise (``tests/test_torch_certified.py``
    holds the decisions against safeopt_tpu)."""
    opt = _port_opt(**kw)
    jopt = jt.SafeOpt(jt.GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                                      jt.RBF(1, variance=2.0),
                                      noise_var=1e-3),
                      pt.linearly_spaced_combinations([(-4.0, 4.0)], 100),
                      fmin=[0.0], use_pallas=False, **kw)
    # the refine band's and budget's defaults are the port's own
    # (safe_opt.REFINE_BAND, re-derived from the card's three-pass error;
    # REFINE_BAND_SHARE of the grid), the rest as safeopt_tpu
    names = ["_exact_boundaries", "_boundary_band", "_boundary_k",
             "_interval_precision", "_refine_k", "_oracle"]
    if "refine_band" in kw:
        names.append("_refine_band")
    else:
        assert opt._refine_band == psafe.REFINE_BAND
    if "refine_band_k" in kw:
        names.append("_refine_band_k")
    else:
        assert opt._refine_band_k == int(100 * psafe.REFINE_BAND_SHARE)
    for name in names:
        assert getattr(opt, name) == getattr(jopt, name), name
    assert opt.optimize().shape == (1,)
    with pytest.raises(ValueError, match="exact_boundaries"):
        _port_opt(**{**kw, "interval_precision": "high",
                     "exact_boundaries": False})


def test_plain_path_defaults_accepted():
    opt = _port_opt(exact_boundaries=False, interval_precision=None,
                    oracle="host", boundary_band=1e-3, refine_band=1e-2,
                    refine_band_k=20480)
    assert opt.optimize().shape == (1,)


def test_unsupported_kernel_raises():
    """White anywhere in a kernel tree, which no grid kernel takes, runs
    on the eager route and decides in lockstep with safeopt_tpu (it
    raised ``NotImplementedError`` before that route existed)."""
    grid = pt.linearly_spaced_combinations([(-1.0, 1.0)] * 2, 5)
    x0, y0 = np.array([[0.0, 0.0]]), np.array([[1.0]])

    def f(x):
        return float(1.0 - 0.2 * np.sum(np.square(x)))

    def opts(make):
        port = pt.SafeOpt(pt.GPRegression(x0, y0, make(pt), noise_var=1e-3,
                                          device="cpu"),
                          grid, fmin=[-2.5], threshold=0.05)
        jax_opt = jt.SafeOpt(jt.GPRegression(x0, y0, make(jt),
                                             noise_var=1e-3),
                             grid, fmin=[-2.5], threshold=0.05,
                             use_pallas=False)
        return port, jax_opt

    for make in (lambda p: p.White(2),
                 lambda p: p.RBF(2) + p.White(2, variance=0.1),
                 lambda p: (p.RBF(1, active_dims=[0])
                            * p.White(1, active_dims=[1]))):
        port, jax_opt = opts(make)
        for it in range(3):
            x = np.asarray(port.optimize())
            assert_allclose(x, np.asarray(jax_opt.optimize()), atol=1e-12,
                            err_msg=f"query at {it}")
            assert port.stats.last.eager_gps == 1
            for name in ("S", "M", "G"):
                np.testing.assert_array_equal(
                    getattr(port, name), np.asarray(getattr(jax_opt, name)),
                    err_msg=f"{name} at {it}")
            assert_allclose(port.Q, np.asarray(jax_opt.Q), rtol=0,
                            atol=1e-12)
            for opt in (port, jax_opt):
                opt.add_new_data_point(x, f(x))
    # an active_dims subset runs K2/K4 (their plain versions here)
    port = pt.SafeOpt(pt.GPRegression(x0, y0, pt.RBF(1, active_dims=[0]),
                                      noise_var=1e-3, device="cpu"),
                      grid, fmin=[0.0])
    assert port.optimize().shape == (2,)
    assert port.stats.last.eager_gps == 0


def test_device_mismatch_raises():
    gps = [pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                           pt.RBF(1), noise_var=1e-3, device="cpu", dtype=dt)
           for dt in (torch.float64, torch.float32)]
    grid = pt.linearly_spaced_combinations([(-1.0, 1.0)], 5)
    with pytest.raises(ValueError, match="one device and dtype"):
        pt.SafeOpt(gps, grid, fmin=[0.0, 0.0])
    meta_grid = torch.zeros((5, 1), device="meta")
    with pytest.raises(ValueError, match="parameter_set is on"):
        pt.SafeOpt(gps[0], meta_grid, fmin=[0.0])


def test_nan_observation_routing():
    gps = [pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]), pt.RBF(1),
                           noise_var=1e-4, device="cpu") for _ in range(2)]
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)], 50)
    opt = pt.SafeOpt(gps, grid, fmin=[-np.inf, 0.0], beta=lambda t: 2.0)
    opt.add_new_data_point(np.array([[1.0]]), np.array([[2.0, np.nan]]))
    assert opt.gps[0].num_data == 2
    assert opt.gps[1].num_data == 1
    assert opt.t == 2
    assert opt.optimize().shape == (1,)
    assert opt.stats.last.safe_count > 0


def test_import_leaves_jax_out():
    code = ("import sys, safeopt_torch, safeopt_torch.convert, "
            "safeopt_torch.ops._build; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'safeopt_tpu' not in sys.modules, 'safeopt_tpu imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr

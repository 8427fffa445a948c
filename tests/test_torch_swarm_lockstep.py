"""Whole-``optimize()`` lockstep of the port's SafeOptSwarm, float64 on
the CPU.

Mirrors ``tests/test_swarm_lockstep.py``: ``RefSafeOptSwarm``
(``tests/reference_impl.py``, an independent NumPy float64 mirror of the
reference's orchestration), the port's stepwise path, the port's fused
iteration and safeopt_tpu's fused and stepwise paths consume identical
uniform streams (drawn per swarm in the order idx, vel, r) through the
two injection hooks ``_draw_uniform`` and ``_fused_streams``, and must
produce the same queries, safe sets, greedy estimates and lower bounds
over whole campaigns: 1-D, 5-D with two GPs for 15 iterations, UCB, and
a Sum kernel.

Tolerances: the port against the reference at 1e-10 (its PSO arithmetic
is IEEE-exact against NumPy's; only the posteriors' summation order
differs). safeopt_tpu against the port at 1e-6, its own lockstep's
tolerance: XLA's CPU code contracts part of the PSO update into fused
multiply-adds, and its trajectories drift from the reference by up to
7e-7 in a safe-set point over 15 iterations of the 5-D problem
(measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms.swarm_opt_fused import stream_layout

from reference_impl import (RefBias, RefGP, RefMatern32, RefRBF,
                            RefSafeOptSwarm)

TOL_REF, TOL_JAX = 1e-10, 1e-6


def make_provider(seed):
    """Deterministic U[0,1) stream; one copy per implementation."""
    rng = np.random.default_rng(seed)
    return lambda shape: rng.uniform(size=shape)


def _streamed(base):
    class Stepwise(base):
        """The stepwise path with injected uniforms."""

        def attach(self, provider):
            self._provider = provider

        def _draw_uniform(self, shape):
            return np.asarray(self._provider(shape))

    class Fused(base):
        """The fused path with injected uniforms (per swarm idx, vel, r;
        greedy, maximizers, expanders)."""

        def attach(self, provider):
            self._provider = provider

        def _fused_streams(self, ucb=False):
            return {name: jnp.asarray(self._provider(shape))
                    for name, shape in stream_layout(
                        self.swarm_size, self.max_iters, self.gp.input_dim,
                        ucb)}

    return Stepwise, Fused


CLASSES = {"pt": _streamed(pt.SafeOptSwarm), "jt": _streamed(jt.SafeOptSwarm)}


def rkhs_fn(kern_eval, centers, weights):
    centers = np.atleast_2d(np.asarray(centers, dtype=float))
    weights = np.asarray(weights, dtype=float)

    def f(x):
        return kern_eval(np.atleast_2d(np.asarray(x, dtype=float)),
                         centers) @ weights

    return f


def _make(kind, provider, ref_gps, gps, **kw):
    """An optimizer of ``kind`` ('ref' or '<pkg>-<stepwise|fused>') over
    ``ref_gps()`` / ``gps(pkg)``, with the injected ``provider``."""
    if kind == "ref":
        return RefSafeOptSwarm(ref_gps(), draw_uniform=provider, **kw)
    pkg_name, path = kind.split("-")
    pkg = pt if pkg_name == "pt" else jt
    stepwise, fused = CLASSES[pkg_name]
    opt = (stepwise if path == "stepwise" else fused)(gps(pkg), **kw)
    opt.attach(provider)
    return opt


KINDS = ("ref", "pt-stepwise", "pt-fused", "jt-fused", "jt-stepwise")


def run_lockstep(make, fns, iters, seed, ucb=False, kinds=KINDS):
    """Drive every implementation in lockstep and hold each to the
    reference (the port at TOL_REF, safeopt_tpu at TOL_JAX)."""
    opts = {k: make(k, make_provider(seed)) for k in kinds}
    ref = opts["ref"]
    assert_allclose(opts["pt-fused"].optimal_velocities,
                    ref.optimal_velocities, rtol=1e-12)
    for it in range(iters):
        xs = {}
        for k, o in opts.items():
            xs[k] = np.asarray(o.optimize(ucb=ucb) if k == "ref" or
                               k.endswith("fused") else
                               o.optimize(ucb=ucb, fused=False))
        for k, o in opts.items():
            tol = TOL_REF if k.startswith("pt") else TOL_JAX
            msg = f"{k} diverged at iteration {it}"
            assert_allclose(xs[k], xs["ref"], atol=tol, err_msg=msg)
            if not ucb:
                assert o.S.shape == ref.S.shape, msg
                assert_allclose(o.S, ref.S, atol=tol, err_msg=msg)
                assert_allclose(o.greedy_point, ref.greedy_point, atol=tol,
                                err_msg=msg)
            assert_allclose(o.best_lower_bound, ref.best_lower_bound,
                            atol=tol, err_msg=msg)
        for k, o in opts.items():
            y = np.array([[float(f(xs[k])[0]) for f in fns]])
            o.add_new_data_point(np.atleast_2d(xs[k]), y)
    xm, ym = ref.get_maximum()
    for k in kinds[1:]:
        xo, yo = opts[k].get_maximum()
        tol = TOL_REF if k.startswith("pt") else TOL_JAX
        assert_allclose(np.asarray(xo), xm, atol=tol)
        assert_allclose(np.asarray(yo), ym, atol=tol)


def test_1d_fifteen_iterations():
    """1d_example.ipynb's shape: one RBF GP, fmin=0, threshold=0.2."""
    rkern = RefRBF(1, variance=2.0, lengthscale=1.0)
    f = rkhs_fn(rkern.K, [[-4.0], [-1.0], [0.0], [2.0], [5.0]],
                [1.5, -1.0, 2.0, 1.0, -2.0])
    x0 = np.array([[0.0]])
    assert f(x0)[0] > 0.5

    def make(kind, provider):
        return _make(
            kind, provider,
            lambda: RefGP(x0, f(x0)[:, None], rkern, noise_var=0.05 ** 2),
            lambda p: p.GPRegression(
                x0, f(x0)[:, None], p.RBF(1, variance=2.0, lengthscale=1.0),
                noise_var=0.05 ** 2, **({"device": "cpu"} if p is pt else {})),
            fmin=[0.0], bounds=[(-10.0, 10.0)], threshold=0.2, swarm_size=10,
            max_iters=15)

    run_lockstep(make, [f], iters=15, seed=101)


def test_5d_two_gps_fifteen_iterations():
    """5-D, an objective (fmin=-inf) and a Matern-3/2 constraint."""
    d = 5
    rk_f = RefRBF(d, variance=2.0, lengthscale=2.0)
    rk_g = RefMatern32(d, variance=1.5, lengthscale=3.0)
    centers = np.array([[0.0] * d, [1.5, -1.0, 0.5, 0.0, 1.0],
                        [-2.0, 1.0, -0.5, 1.5, -1.0]])
    f = rkhs_fn(rk_f.K, centers, [2.0, 1.2, -1.5])
    g = rkhs_fn(rk_g.K, centers[:2], [1.5, 0.8])
    x0 = np.zeros((1, d))
    assert g(x0)[0] > 0.5

    def gps(p):
        where = {"device": "cpu"} if p is pt else {}
        return [p.GPRegression(x0, f(x0)[:, None],
                               p.RBF(d, variance=2.0, lengthscale=2.0),
                               noise_var=1e-4, **where),
                p.GPRegression(x0, g(x0)[:, None],
                               p.Matern32(d, variance=1.5, lengthscale=3.0),
                               noise_var=1e-4, **where)]

    def make(kind, provider):
        return _make(
            kind, provider,
            lambda: [RefGP(x0, f(x0)[:, None], rk_f, noise_var=1e-4),
                     RefGP(x0, g(x0)[:, None], rk_g, noise_var=1e-4)],
            gps, fmin=[-np.inf, 0.0], bounds=[(-3.0, 3.0)] * d,
            threshold=0.1, swarm_size=12, max_iters=15)

    run_lockstep(make, [f, g], iters=15, seed=202)


def test_ucb_runs_only_two_swarms():
    rkern = RefRBF(1, variance=2.0)
    f = rkhs_fn(rkern.K, [[0.0], [2.0]], [2.0, 1.0])
    x0 = np.array([[0.0]])

    def make(kind, provider):
        return _make(
            kind, provider,
            lambda: RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-4),
            lambda p: p.GPRegression(
                x0, f(x0)[:, None], p.RBF(1, variance=2.0), noise_var=1e-4,
                **({"device": "cpu"} if p is pt else {})),
            fmin=[0.0], bounds=[(-5.0, 5.0)], swarm_size=10, max_iters=10)

    run_lockstep(make, [f], iters=5, seed=7, ucb=True,
                 kinds=("ref", "pt-stepwise", "pt-fused", "jt-fused"))


def test_sum_kernel_ten_iterations():
    """Kernel algebra through the swarm: an RBF + Bias sum."""
    rkern = RefRBF(1, variance=2.0, lengthscale=1.0) + RefBias(1,
                                                               variance=0.3)
    f = rkhs_fn(rkern.K, [[-3.0], [0.0], [2.5]], [1.0, 1.8, -0.9])
    x0 = np.array([[0.0]])
    assert f(x0)[0] > 0.5

    def make(kind, provider):
        return _make(
            kind, provider,
            lambda: RefGP(x0, f(x0)[:, None], rkern, noise_var=0.05 ** 2),
            lambda p: p.GPRegression(
                x0, f(x0)[:, None], p.RBF(1, variance=2.0, lengthscale=1.0)
                + p.Bias(1, variance=0.3), noise_var=0.05 ** 2,
                **({"device": "cpu"} if p is pt else {})),
            fmin=[0.0], bounds=[(-8.0, 8.0)], threshold=0.2, swarm_size=10,
            max_iters=12)

    run_lockstep(make, [f], iters=10, seed=303,
                 kinds=("ref", "pt-stepwise", "pt-fused", "jt-fused"))


@pytest.mark.parametrize("path", ["stepwise", "fused"])
def test_unsafe_seed_raises_like_the_reference(path):
    """Every implementation raises on an unsafe seed, before drawing."""
    x0 = np.array([[0.0]])

    def make(kind, provider):
        return _make(
            kind, provider,
            lambda: RefGP(x0, np.array([[-1.0]]), RefRBF(1), noise_var=1e-4),
            lambda p: p.GPRegression(x0, np.array([[-1.0]]), p.RBF(1),
                                     noise_var=1e-4,
                                     **({"device": "cpu"} if p is pt
                                        else {})),
            fmin=[0.0], bounds=[(-1.0, 1.0)], swarm_size=5, max_iters=5)

    for kind in ("ref", f"pt-{path}", f"jt-{path}"):
        opt = make(kind, make_provider(1))
        with pytest.raises(RuntimeError, match="safe set is empty"):
            opt.optimize() if kind == "ref" or path == "fused" else \
                opt.optimize(fused=False)

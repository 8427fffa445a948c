"""The port's device-side swarm loop and lag-1 swarm campaigns, float64 on
the CPU.

Mirrors ``tests/test_runner.py::TestSwarmLoop`` and
``tests/test_pipeline.py``: ``run_swarmopt_loop`` gives safeopt_tpu's
queries, observations, lower bounds and safe-set counts to 1e-10 when
safeopt_tpu gets explicit ``it_keys`` and the port the uniforms and
normals those keys draw (the test draws them in JAX, in the fused
program's order); it reproduces the blocking ``SafeOptSwarm`` loop fed
the same uniforms, with no host read in an iteration; a generator
prefix resumes a run. ``run_lagged_campaign`` gives bitwise-identical
queries and observations pipelined and serial, for one GP and two, and
safeopt_tpu's queries with the same injected streams (at 1e-6, its
lockstep's tolerance: XLA's CPU code contracts part of the PSO update
into fused multiply-adds). The asynchronous mechanics: ``result()`` is
idempotent, a deep chain without ``reserve`` raises, ``reserve`` never
shrinks, an unchained dispatch equals the blocking ``optimize()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms.runner import run_swarmopt_loop
from safeopt_torch.algorithms.swarm_opt_fused import (SwarmIterState,
                                                      stream_layout)
from safeopt_tpu.algorithms.runner import run_swarmopt_loop as jax_loop
from safeopt_tpu.algorithms.swarm_opt_fused import \
    SwarmIterState as JaxIterState

D, SWARM, ITERS, CAP = 2, 8, 10, 128
VEL, BOUNDS = [0.3, 0.3], [[-3.0, 3.0], [-3.0, 3.0]]


def _f_jax(x):
    return 2.0 * jnp.exp(-0.5 * jnp.sum(x * x))


def _g_jax(x):
    return 1.0 - 0.05 * jnp.sum(x * x)


def _f_torch(x):
    return 2.0 * torch.exp(-0.5 * torch.sum(x * x))


def _g_torch(x):
    return 1.0 - 0.05 * torch.sum(x * x)


def _gps(pkg, n_gps, capacity=16):
    x0 = np.zeros((1, D))
    where = {"device": "cpu"} if pkg is pt else {}
    gps = [pkg.GPRegression(x0, np.array([[2.0]]),
                            pkg.RBF(D, variance=2.0, lengthscale=1.5),
                            noise_var=1e-4, capacity=capacity, **where)]
    if n_gps == 2:
        gps.append(pkg.GPRegression(x0, np.array([[1.0]]),
                                    pkg.Matern32(D, variance=1.0,
                                                 lengthscale=3.0),
                                    noise_var=1e-4, capacity=capacity,
                                    **where))
    return gps


def _jax_draws(it_keys, n_gps, ucb=False):
    """The uniforms (flat, ``stream_layout``'s order) and the noise
    normals that safeopt_tpu's loop draws from ``it_keys``."""
    layout = stream_layout(SWARM, ITERS, D, ucb)
    flat, normals = [], []
    for key in it_keys:
        k_swarm, k_noise = jax.random.split(key)
        parts = {}
        for k, s in zip(jax.random.split(k_swarm, 3),
                        ("greedy", "maximizers", "expanders")):
            k1, k2, k3 = jax.random.split(k, 3)
            n = SWARM - 3 if s == "greedy" else SWARM
            parts[s + "_idx"] = jax.random.uniform(k1, (n,), jnp.float64)
            parts[s + "_vel"] = jax.random.uniform(k2, (SWARM, D),
                                                   jnp.float64)
            parts[s + "_r"] = jax.random.uniform(k3, (ITERS, 2, SWARM, D),
                                                 jnp.float64)
        flat.append(np.concatenate([np.asarray(parts[name]).ravel()
                                    for name, _ in layout]))
        normals.append(np.asarray(jax.random.normal(k_noise, (n_gps,),
                                                    jnp.float64)))
    return np.stack(flat), np.stack(normals)


def _consts(n_gps):
    fmin = [0.0] if n_gps == 1 else [-np.inf, 0.0]
    scaling = [np.sqrt(2.0)] if n_gps == 1 else [np.sqrt(2.0), 1.0]
    return fmin, scaling, [0.0] * n_gps


def _port_loop(gps, n_iter, streams, noise, noise_std, ucb=False):
    fmin, scaling, threshold = _consts(len(gps))
    S = np.zeros((CAP, D))
    state = SwarmIterState(S=torch.tensor(S), count=torch.tensor(1),
                           greedy=torch.zeros(D, dtype=torch.float64))
    objectives = (_f_torch, _g_torch)[:len(gps)]
    return run_swarmopt_loop(
        tuple(g.kern for g in gps), tuple(g.factor_state() for g in gps),
        state, VEL, BOUNDS, fmin, scaling, threshold, np.full(n_iter, 2.0),
        np.zeros(D), -np.inf, streams, noise, objectives=objectives,
        n_iter=n_iter, swarm_size=SWARM, max_iters=ITERS,
        noise_std=noise_std, ucb=ucb)


@pytest.mark.parametrize("n_gps,noise_std,ucb",
                         [(1, 0.0, False), (2, 0.1, False), (1, 0.1, True)],
                         ids=["one-gp", "two-gps-noise", "ucb"])
def test_loop_matches_safeopt_tpu_with_the_same_draws(n_gps, noise_std, ucb):
    n_iter = 5
    it_keys = jax.random.split(jax.random.key(0), n_iter)
    fmin, scaling, threshold = _consts(n_gps)
    jgps = _gps(jt, n_gps)
    S = np.zeros((CAP, D))
    theirs = jax_loop(
        tuple(g.kern for g in jgps), tuple(g.state for g in jgps),
        JaxIterState(S=jnp.asarray(S), count=jnp.asarray(1, jnp.int32),
                     greedy=jnp.zeros(D)),
        jax.random.key(0), jnp.asarray(VEL), jnp.asarray(BOUNDS),
        jnp.asarray(fmin), jnp.asarray(scaling), jnp.asarray(threshold),
        np.full(n_iter, 2.0), np.zeros(D), -np.inf,
        objectives=(_f_jax, _g_jax)[:n_gps], n_iter=n_iter,
        swarm_size=SWARM, max_iters=ITERS, noise_std=noise_std, ucb=ucb,
        it_keys=it_keys)
    flat, normals = _jax_draws(it_keys, n_gps, ucb)
    ours = _port_loop(_gps(pt, n_gps), n_iter, flat, normals, noise_std,
                      ucb=ucb)
    assert_allclose(ours.xs.numpy(), np.asarray(theirs.xs), atol=1e-10)
    assert_allclose(ours.ys.numpy(), np.asarray(theirs.ys), atol=1e-10)
    assert_allclose(ours.best_lower_bounds.numpy(),
                    np.asarray(theirs.best_lower_bounds), atol=1e-10)
    np.testing.assert_array_equal(ours.safe_counts.numpy(),
                                  np.asarray(theirs.safe_counts))
    np.testing.assert_array_equal(ours.num_safe_min.numpy(),
                                  np.asarray(theirs.num_safe_min))
    assert [int(s.count) for s in ours.states] == [1 + n_iter] * n_gps
    assert ours.host_syncs.tolist() == [0] * n_iter


class _Fed(pt.SafeOptSwarm):
    """The fused path fed one row of a flat per-iteration uniform tensor
    per ``optimize()``."""

    def feed(self, flat):
        self._rows = iter(flat)
        return self

    def _fused_streams(self, ucb=False):
        row = next(self._rows)
        out, at = {}, 0
        for name, shape in stream_layout(self.swarm_size, self.max_iters,
                                         self.gp.input_dim, ucb):
            n = int(np.prod(shape))
            out[name] = row[at:at + n].reshape(shape)
            at += n
        return out


def test_loop_reproduces_the_blocking_loop_and_resumes():
    """The blocking SafeOptSwarm loop on the same plant and uniforms gives
    the loop's queries; a generator's draws, split into a prefix run and
    its resumption from the grown states, give the whole run's."""
    n_iter = 6
    flat = torch.rand((n_iter, sum(int(np.prod(s)) for _, s in
                                   stream_layout(SWARM, ITERS, D))),
                      generator=torch.Generator().manual_seed(4),
                      dtype=torch.float64)
    gps = _gps(pt, 2)
    loop = _port_loop(gps, n_iter, flat, None, 0.0)

    fmin, scaling, threshold = _consts(2)
    blocking = _Fed(_gps(pt, 2), fmin=fmin, bounds=BOUNDS, scaling=scaling,
                    swarm_size=SWARM, max_iters=ITERS).feed(flat.numpy())
    blocking.optimal_velocities = np.asarray(VEL)
    blocking.greedy_point = np.zeros(D)
    for t in range(n_iter):
        x = blocking.optimize()
        assert_allclose(x, loop.xs[t].numpy(), atol=1e-12,
                        err_msg=f"step {t}")
        xt = torch.tensor(x)
        blocking.add_new_data_point(
            x, np.array([[float(_f_torch(xt)), float(_g_torch(xt))]]))
    assert blocking._count == int(loop.safe_counts[-1])

    # a prefix of the draws, then the rest from the prefix's end state
    head = _port_loop(_gps(pt, 2), 2, flat[:2], None, 0.0)
    fmin, scaling, threshold = _consts(2)
    tail = run_swarmopt_loop(
        tuple(g.kern for g in gps), head.states, head.iter_state, VEL,
        BOUNDS, fmin, scaling, threshold, np.full(n_iter - 2, 2.0),
        head.iter_state.greedy, head.best_lower_bounds[-1], flat[2:],
        objectives=(_f_torch, _g_torch), n_iter=n_iter - 2,
        swarm_size=SWARM, max_iters=ITERS)
    np.testing.assert_array_equal(torch.cat([head.xs, tail.xs]).numpy(),
                                  loop.xs.numpy())


@pytest.mark.parametrize("loop", ["swarm", "grid"])
def test_float64_loops_leave_the_callers_states_untouched(loop):
    """A float64 loop's step mirror is a copy of the caller's states, not
    the states themselves: the appended rows go into the mirror and the
    returned states, and the caller's keep their rows and count."""
    from safeopt_torch.algorithms.runner import run_safeopt_loop

    gp = _gps(pt, 1)[0]
    states = (gp.factor_state(),)
    before = [t.clone() for t in states[0]]
    if loop == "swarm":
        state = SwarmIterState(S=torch.zeros((CAP, D), dtype=torch.float64),
                               count=torch.tensor(1),
                               greedy=torch.zeros(D, dtype=torch.float64))
        out = run_swarmopt_loop(
            (gp.kern,), states, state, VEL, BOUNDS, [0.0], [np.sqrt(2.0)],
            [0.0], [2.0] * 3, np.zeros(D), -np.inf,
            torch.Generator().manual_seed(0), objectives=(_f_torch,),
            n_iter=3, swarm_size=SWARM, max_iters=ITERS)
    else:
        grid = pt.linearly_spaced_combinations([(-2.0, 2.0)] * D, 30)
        t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        out = run_safeopt_loop((gp.kern,), states, t(grid), t([0.0]), 2.0,
                               t([np.sqrt(2.0)]), t([0.0]),
                               objectives=(_f_torch,), n_iter=3, chunk=16)
    assert int(out.states[0].count) == 4
    for a, b in zip(states[0], before):
        assert torch.equal(a, b)


def test_loop_argument_checks():
    gps = _gps(pt, 1)
    with pytest.raises(ValueError, match="noise_std"):
        _port_loop(gps, 2, torch.Generator().manual_seed(0), None, 0.1)
    with pytest.raises(ValueError, match="shape"):
        _port_loop(gps, 2, np.zeros((2, 5)), None, 0.0)
    with pytest.raises(TypeError, match="float64"):
        run_swarmopt_loop(
            (gps[0].kern,), (gps[0].state._replace(
                X=gps[0].state.X.float()),),
            SwarmIterState(torch.zeros(CAP, D), torch.tensor(1),
                           torch.zeros(D)), VEL, BOUNDS, [0.0], [1.0], [0.0],
            [2.0], np.zeros(D), -np.inf, torch.Generator(),
            objectives=(_f_torch,), n_iter=1, swarm_size=SWARM,
            max_iters=ITERS)


def _plant1(x):
    x = np.asarray(x, dtype=float)
    return float(2.0 * np.exp(-0.5 * np.sum(x ** 2)))


def _plant2(x):
    x = np.asarray(x, dtype=float)
    return np.array([2.0 * np.exp(-0.5 * np.sum(x ** 2)),
                     1.0 - 0.05 * np.sum(x ** 2)])


class _Streamed:
    def attach(self, seed):
        rng = np.random.default_rng(seed)
        self._provider = lambda shape: rng.uniform(size=shape)
        return self

    def _fused_streams(self, ucb=False):
        return {name: self._provider(shape) for name, shape in
                stream_layout(self.swarm_size, self.max_iters,
                              self.gp.input_dim, ucb)}


class _PtStreamed(_Streamed, pt.SafeOptSwarm):
    pass


class _JtStreamed(_Streamed, jt.SafeOptSwarm):
    pass


def _opt(num_gps=1, d=3, seed=0, cls=None, pkg=pt):
    """safeopt_tpu's pipeline test problem (tests/test_pipeline.py)."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-0.4, 0.4, size=(4, d))
    where = {"device": "cpu"} if pkg is pt else {}
    gps = [pkg.GPRegression(
        X, (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None],
        pkg.RBF(d, variance=2.0, lengthscale=2.0), noise_var=0.01, **where)]
    fmin = [0.2]
    if num_gps == 2:
        gps.append(pkg.GPRegression(
            X, (1.0 - 0.05 * np.sum(X ** 2, axis=1))[:, None],
            pkg.Matern32(d, variance=1.0, lengthscale=3.0), noise_var=0.01,
            **where))
        fmin = [-np.inf, 0.0]
    kw = dict(fmin=fmin, bounds=[(-2.0, 2.0)] * d, swarm_size=12,
              max_iters=20)
    gp = gps if num_gps == 2 else gps[0]
    if cls is not None:
        return cls(gp, **kw).attach(seed)
    return pkg.SafeOptSwarm(gp, seed=seed, **kw)


@pytest.mark.parametrize("num_gps", [1, 2])
def test_lagged_campaign_pipelined_matches_serial_bitwise(num_gps):
    plant = _plant1 if num_gps == 1 else _plant2
    runs = {}
    for pipelined in (False, True):
        opt = _opt(num_gps)
        runs[pipelined] = (pt.run_lagged_campaign(opt, plant, n_iter=6,
                                                  pipelined=pipelined), opt)
    (xs_s, ys_s), serial = runs[False]
    (xs_p, ys_p), piped = runs[True]
    assert xs_s.shape == (6, 3)
    np.testing.assert_array_equal(xs_p, xs_s)
    np.testing.assert_array_equal(ys_p, ys_s)
    np.testing.assert_array_equal(piped.gp.X_host, serial.gp.X_host)
    assert piped._count == serial._count
    np.testing.assert_array_equal(piped.S, serial.S)
    assert piped.best_lower_bound == serial.best_lower_bound
    assert len(piped.stats.history) == len(serial.stats.history) == 6


def test_lagged_campaign_matches_safeopt_tpu_with_injected_streams():
    xs, ys = pt.run_lagged_campaign(_opt(2, cls=_PtStreamed), _plant2,
                                    n_iter=5)
    xj, yj = jt.run_lagged_campaign(_opt(2, cls=_JtStreamed, pkg=jt),
                                    _plant2, n_iter=5)
    assert_allclose(xs, np.asarray(xj), atol=1e-6)
    assert_allclose(ys, np.asarray(yj), atol=1e-6)


def test_empty_output_for_zero_iterations():
    xs, ys = pt.run_lagged_campaign(_opt(), _plant1, n_iter=0)
    assert xs.size == 0 and ys.size == 0


def test_async_mechanics():
    opt = _opt()
    opt.reserve(2)
    pending = opt.optimize_async()
    np.testing.assert_array_equal(pending.result(), pending.result())
    assert len(opt.stats.history) == 1

    # the default buffer holds a chained iteration or two of worst-case
    # growth: a deep unreserved chain fails loudly, never overflows
    opt = _opt()
    pending = opt.optimize_async()
    with pytest.raises(RuntimeError, match="reserve"):
        for _ in range(64):
            pending = opt.optimize_async(after=pending)

    opt = _opt()
    opt.reserve(8)
    rows = opt._S_dev.S.shape[0]
    opt.reserve(4)
    assert opt._S_dev.S.shape[0] == rows

    a, b = _opt(seed=3), _opt(seed=3)
    np.testing.assert_array_equal(a.optimize(), b.optimize_async().result())

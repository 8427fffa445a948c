"""The port's swarm pieces against safeopt_tpu and the NumPy reference,
float64 on the CPU.

Mirrors ``tests/test_swarm.py``: ``_penalty`` over every band,
``_particle_fitness`` for the four swarm types, ``swarm_scan``'s dynamics
(against ``ref_pso`` and safeopt_tpu's scan), the bisected velocities,
the fused iteration's ``_validate_and_prune``, ``_init_particles`` and
``_grow_safe_set`` against safeopt_tpu's and the stepwise path's host
logic, ``SwarmOptimization``, ``SafeOptSwarm``'s failure modes and
invariants, and ``SafeOptSwarm`` on a ``SparseGPRegression`` against
safeopt_tpu's with the same injected streams.

Tolerances: 1e-10 unless stated. The port's elementwise PSO arithmetic
is IEEE-exact against NumPy's, so against the reference only the GP
posterior's summation order differs; XLA's CPU code contracts some of
the PSO update into fused multiply-adds, so safeopt_tpu's swarm drifts
from both by rounding (up to 1e-8 in a query over 15 iterations,
measured), and its whole-run comparisons are held at 1e-6, the
tolerance of safeopt_tpu's own lockstep against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import swarm_opt as so
from safeopt_torch.algorithms import swarm_opt_fused as sf
from safeopt_tpu.algorithms import swarm_opt as jso
from safeopt_tpu.algorithms import swarm_opt_fused as jsf

from reference_impl import (RefGP, RefMatern32, RefRBF, ref_particle_fitness,
                            ref_penalty, ref_pso)

CPU = dict(device="cpu")


def t64(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=torch.float64)


def _models():
    x0 = np.array([[0.0], [0.5], [-1.0]])
    y_f = np.array([[1.0], [0.8], [0.3]])
    y_g = np.array([[0.5], [0.6], [-0.2]])
    pts = (pt.GPRegression(x0, y_f, pt.RBF(1, variance=2.0), noise_var=0.01,
                           **CPU),
           pt.GPRegression(x0, y_g, pt.Matern32(1, variance=1.5),
                           noise_var=0.01, **CPU))
    jts = (jt.GPRegression(x0, y_f, jt.RBF(1, variance=2.0), noise_var=0.01),
           jt.GPRegression(x0, y_g, jt.Matern32(1, variance=1.5),
                           noise_var=0.01))
    refs = (RefGP(x0, y_f, RefRBF(1, variance=2.0), noise_var=0.01),
            RefGP(x0, y_g, RefMatern32(1, variance=1.5), noise_var=0.01))
    return pts, jts, refs


def _args(gps):
    return tuple(g.kern for g in gps), tuple(g.state for g in gps)


class Streamed(pt.SafeOptSwarm):
    """The fused path with injected uniforms, in the stepwise order."""

    def attach(self, provider):
        self._provider = provider
        return self

    def _fused_streams(self, ucb=False):
        return {name: self._provider(shape) for name, shape in
                sf.stream_layout(self.swarm_size, self.max_iters,
                                 self.gp.input_dim, ucb)}


class JStreamed(jt.SafeOptSwarm):
    """safeopt_tpu's fused path fed the same uniforms."""

    def attach(self, provider):
        self._provider = provider
        return self

    def _fused_streams(self, ucb=False):
        return {name: jnp.asarray(self._provider(shape)) for name, shape in
                sf.stream_layout(self.swarm_size, self.max_iters,
                                 self.gp.input_dim, ucb)}


def provider(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: rng.uniform(size=shape)


def test_penalty_matches_reference_and_safeopt_tpu_across_all_bands():
    slack = np.array([0.5, 0.0, -0.0005, -0.001, -0.05, -0.1, -0.5, -1.0,
                      -2.0, -10.0])
    ours = so._penalty(t64(slack)).numpy()
    assert_allclose(ours, ref_penalty(slack), rtol=1e-12)
    assert_allclose(ours, np.asarray(jso._penalty(jnp.asarray(slack))),
                    rtol=1e-12)


@pytest.mark.parametrize("fmin", [[-np.inf, 0.0], [0.0, 0.0]],
                         ids=["objective-free", "constrained-objective"])
@pytest.mark.parametrize("swarm_type",
                         ["greedy", "maximizers", "expanders", "safe_set"])
def test_particle_fitness_matches_reference_and_safeopt_tpu(swarm_type,
                                                            fmin):
    pts, jts, refs = _models()
    particles = np.random.default_rng(42).uniform(-3, 3, size=(20, 1))
    beta, blb = 2.0, 0.4
    fmin = np.asarray(fmin)
    scaling = np.array([np.sqrt(2.0), np.sqrt(1.5)])
    vals, safe = so._particle_fitness(
        swarm_type, *_args(pts), t64(beta), t64(fmin), t64(scaling),
        t64(blb), t64(particles))
    rvals, rsafe = ref_particle_fitness(swarm_type, list(refs), beta, fmin,
                                        scaling, blb, particles)
    jvals, jsafe = jso._particle_fitness(
        swarm_type, *_args(jts), jnp.asarray(beta), jnp.asarray(fmin),
        jnp.asarray(scaling), jnp.asarray(blb), jnp.asarray(particles))
    assert_allclose(vals.numpy(), rvals, rtol=1e-10, atol=1e-10)
    assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(safe.numpy(), rsafe)
    np.testing.assert_array_equal(safe.numpy(), np.asarray(jsafe))


def test_swarm_scan_dynamics_match_reference_and_safeopt_tpu():
    """Same fitness and the same randomness give the same PSO run."""
    pts, jts, refs = _models()
    fmin = np.array([-np.inf, 0.0])
    scaling = np.array([np.sqrt(2.0), np.sqrt(1.5)])
    rng = np.random.default_rng(7)
    swarm_size, d, iters = 12, 1, 30
    positions = rng.uniform(-2, 2, size=(swarm_size, d))
    velocities = rng.uniform(0, 1, size=(swarm_size, d)) * 0.3
    r_stream = rng.uniform(size=(iters, 2, swarm_size, d))
    vel, bounds = np.array([0.3]), np.array([[-3.0, 3.0]])

    res = so._run_swarm_fused(
        *_args(pts), t64(positions), t64(velocities), t64(r_stream),
        t64(vel), t64(bounds), t64(2.0), t64(fmin), t64(scaling), t64(0.4),
        swarm_type="maximizers")
    jres = jso._run_swarm_fused(
        *_args(jts), jnp.asarray(positions), jnp.asarray(velocities),
        jnp.asarray(r_stream), jnp.asarray(vel), jnp.asarray(bounds),
        jnp.asarray(2.0), jnp.asarray(fmin), jnp.asarray(scaling),
        jnp.asarray(0.4), swarm_type="maximizers")
    rx, rv, rbp, rbv, rgb = ref_pso(
        lambda p: ref_particle_fitness("maximizers", list(refs), 2.0, fmin,
                                       scaling, 0.4, p),
        positions, velocities, r_stream, vel, bounds)
    for ours, ref, jx in ((res.positions, rx, jres.positions),
                          (res.velocities, rv, jres.velocities),
                          (res.best_positions, rbp, jres.best_positions),
                          (res.best_values, rbv, jres.best_values),
                          (res.global_best, rgb, jres.global_best)):
        assert_allclose(ours.numpy(), ref, rtol=1e-10, atol=1e-10)
        assert_allclose(ours.numpy(), np.asarray(jx), rtol=1e-10,
                        atol=1e-10)


def test_swarm_scan_seeds_bests_regardless_of_safety():
    """Initial bests come from the first fitness even where unsafe; a best
    moves only on improvement AND safety; the first maximum wins."""
    def fitness(p):
        return -torch.sum(p * p, dim=1), p[:, 0] < 0.0

    x0 = t64([[0.5], [-0.5], [-0.5]])
    res = pt.algorithms.swarm_core.swarm_scan(
        fitness, x0, torch.zeros_like(x0), torch.zeros((3, 2, 3, 1),
                                                       dtype=torch.float64),
        t64([0.1]))
    np.testing.assert_array_equal(res.best_positions.numpy(), x0.numpy())
    assert res.global_best.item() == 0.5           # argmax: first of ties


def test_bisected_velocities_match_safeopt_tpu_and_stay_in_band():
    kern = pt.RBF(2, variance=2.0, lengthscale=[0.5, 2.0], ARD=True)
    v = so._bisect_velocity(kern, np.sqrt(2.0), 2)
    jv = jso._bisect_velocity_jit(
        jt.RBF(2, variance=2.0, lengthscale=[0.5, 2.0], ARD=True),
        jnp.asarray(np.sqrt(2.0)), d=2, dtype=jnp.float64)
    assert_allclose(v, np.asarray(jv), rtol=1e-12)
    for j in range(2):
        step = np.zeros((1, 2))
        step[0, j] = v[j]
        corr = float(kern.K(t64(np.zeros((1, 2))), t64(step))[0, 0]) / 2.0
        assert 0.94 - 1e-3 < corr < 0.95 + 1e-3


def _fused_model():
    X = np.array([[0.0], [0.5], [-0.8], [1.5]])
    Y = np.array([[1.2], [0.9], [-0.4], [0.7]])
    return (pt.GPRegression(X, Y, pt.RBF(1, variance=2.0), noise_var=1e-3,
                            **CPU),
            jt.GPRegression(X, Y, jt.RBF(1, variance=2.0), noise_var=1e-3))


@pytest.mark.parametrize("swarm_size", [2, 6], ids=["prunes", "keeps"])
def test_validate_and_prune_matches_safeopt_tpu(swarm_size):
    gp, jgp = _fused_model()
    S = np.array([[0.0], [0.5], [-0.8], [1.5], [0.2], [-0.2]])
    S_buf = np.zeros((8, 1))
    S_buf[:len(S)] = S
    fmin, scaling = np.array([0.0]), np.array([np.sqrt(2.0)])
    out = sf._validate_and_prune(
        (gp.kern,), (gp.state,), t64(S_buf), torch.tensor(len(S)),
        swarm_size, t64(2.0), t64(fmin), t64(scaling))
    jout = jsf._validate_and_prune(
        (jgp.kern,), (jgp.state,), jnp.asarray(S_buf),
        jnp.asarray(len(S), jnp.int32), swarm_size, jnp.asarray(2.0),
        jnp.asarray(fmin), jnp.asarray(scaling))
    S_new, count, n_safe, pruned = (t.numpy() for t in out)
    assert int(count) == int(jout[1]) and int(n_safe) == int(jout[2])
    assert int(pruned) == int(jout[3])
    assert_allclose(S_new[:int(count)], np.asarray(jout[0])[:int(count)])
    safe = so._safe_set_check((gp.kern,), (gp.state,), t64(S_buf), len(S),
                              t64(2.0), t64(fmin), t64(scaling)).numpy()
    if swarm_size == 2:
        assert 0 < pruned and int(count) == int(safe.sum())
        np.testing.assert_array_equal(S_new[:int(count)], S[safe[:len(S)]])
    else:
        assert pruned == 0
        np.testing.assert_array_equal(S_new, S_buf)


def test_init_particles_matches_safeopt_tpu():
    rng = np.random.default_rng(3)
    S = rng.uniform(-1, 1, size=(16, 2))
    u = rng.uniform(size=(7,))
    greedy, specials = rng.uniform(size=2), rng.uniform(size=(2, 2))
    for swarm_type in ("greedy", "maximizers"):
        ours = sf._init_particles(t64(u), t64(S), torch.tensor(11),
                                  swarm_type, t64(greedy), t64(specials))
        theirs = jsf._init_particles(
            jnp.asarray(u), jnp.asarray(S), jnp.asarray(11, jnp.int32),
            swarm_type, jnp.asarray(greedy), jnp.asarray(specials))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_grow_safe_set_matches_safeopt_tpu_and_the_stepwise_path():
    gp, jgp = _fused_model()
    rng = np.random.default_rng(17)
    S = rng.uniform(-2, 2, size=(5, 1))
    best = np.vstack([S[0] + 1e-4,                    # redundant (cov ~ 1)
                      rng.uniform(5, 9, size=(4, 1))])  # far => new
    S_buf = np.zeros((16, 1))
    S_buf[:5] = S
    S_new, count, added = sf._grow_safe_set(
        gp.kern, t64(np.sqrt(2.0)), t64(S_buf), torch.tensor(5), t64(best))
    jS, jcount, jadded = jsf._grow_safe_set(
        jgp.kern, jnp.asarray(np.sqrt(2.0)), jnp.asarray(S_buf),
        jnp.asarray(5, jnp.int32), jnp.asarray(best))
    assert int(count) == int(jcount) and int(added) == int(jadded)
    np.testing.assert_array_equal(S_new.numpy(), np.asarray(jS))

    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[(-10.0, 10.0)])
    opt.S = S.copy()
    opt._grow_safe_set(best)
    np.testing.assert_array_equal(S_new.numpy()[:int(count)], opt.S)
    assert int(added) == len(opt.S) - 5


def test_grow_safe_set_compares_with_the_safe_set_only():
    """The JAX fused program also tests a candidate against buffer rows
    past the count once one candidate was accepted (here the zero padding
    row next to S): it rejects 0.05, whose covariance with the origin is
    0.999. The port's fused growth, the port's stepwise growth,
    safeopt_tpu's stepwise growth and the reference accept it."""
    gp, jgp = _fused_model()
    S, best = np.array([[1.0]]), np.array([[5.0], [0.05]])
    S_buf = np.zeros((8, 1))
    S_buf[:1] = S
    S_new, count, _ = sf._grow_safe_set(gp.kern, t64(np.sqrt(2.0)),
                                        t64(S_buf), torch.tensor(1),
                                        t64(best))
    assert int(count) == 3
    np.testing.assert_array_equal(S_new.numpy()[:3], np.vstack([S, best]))
    _, jcount, _ = jsf._grow_safe_set(jgp.kern, jnp.asarray(np.sqrt(2.0)),
                                      jnp.asarray(S_buf),
                                      jnp.asarray(1, jnp.int32),
                                      jnp.asarray(best))
    assert int(jcount) == 2                # the JAX fused program's fault
    for pkg, model in ((pt, gp), (jt, jgp)):
        opt = pkg.SafeOptSwarm(model, fmin=[0.0], bounds=[(-10.0, 10.0)])
        opt.S = S.copy()
        opt._grow_safe_set(best)
        assert len(opt.S) == 3


def test_grow_safe_set_keeps_to_the_buffer():
    gp, _ = _fused_model()
    best = np.array([[3.0], [6.0], [9.0]])
    S_new, count, added = sf._grow_safe_set(
        gp.kern, t64(np.sqrt(2.0)), t64([[0.0], [0.0], [0.0]]),
        torch.tensor(1), t64(best))
    assert int(count) == 3 and int(added) == 2
    np.testing.assert_array_equal(S_new.numpy(), [[0.0], [3.0], [6.0]])


def test_swarm_optimization_class_runs():
    def fitness(p):
        return -torch.sum(p ** 2, dim=1), torch.ones(p.shape[0], dtype=bool)

    swarm = pt.SwarmOptimization(10, np.array([0.5, 0.5]), fitness,
                                 bounds=[(-2, 2), (-2, 2)], seed=3, **CPU)
    assert_allclose(swarm.max_velocity, [5.0, 5.0])
    swarm.init_swarm(np.random.default_rng(42).uniform(-2, 2, size=(10, 2)))
    swarm.run_swarm(50)
    assert float(torch.linalg.norm(swarm.global_best)) < 0.5
    assert swarm.positions.dtype == torch.float64


def _one_gp(x=0.0, y=1.0, **kw):
    return pt.GPRegression(np.array([[x]]), np.array([[y]]),
                           pt.RBF(1, variance=2.0), noise_var=0.01 ** 2,
                           **CPU, **kw)


@pytest.mark.parametrize("fused", [True, False])
def test_empty_safe_set_raises_and_keeps_the_state(fused):
    """An unsafe seed raises RuntimeError (reference test_swarm.py)."""
    opt = pt.SafeOptSwarm(_one_gp(y=-1.0), fmin=[0.0], bounds=[[-1.0, 1.0]])
    before = opt.S.copy()
    with pytest.raises(RuntimeError, match="safe set is empty"):
        opt.optimize(fused=fused)
    np.testing.assert_array_equal(opt.S, before)


def test_get_maximum_is_best_observed():
    gp = pt.GPRegression(np.array([[0.0], [1.0], [2.0]]),
                         np.array([[1.0], [3.0], [2.0]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    x, y = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-5.0, 5.0]]).get_maximum()
    assert_allclose(x, [1.0])
    assert_allclose(y, [3.0])


@pytest.mark.parametrize("fused", [True, False])
def test_ucb_mode(fused):
    opt = pt.SafeOptSwarm(_one_gp(), fmin=[0.0], bounds=[[-3.0, 3.0]])
    x = opt.optimize(ucb=True, fused=fused)
    assert x.shape == (1,) and -3.0 <= float(x[0]) <= 3.0


def test_end_to_end_invariants_and_stats():
    """Full loop: the safe set grows, queries stay in bounds and safe, one
    pull and no graph per step on the CPU."""
    rkern = RefRBF(1, variance=2.0)
    centers, weights = [[-4.0], [-1.0], [0.0], [2.0], [5.0]], \
        [1.5, -1.0, 2.0, 1.0, -2.0]

    def f(x):
        return rkern.K(np.atleast_2d(x), centers) @ np.asarray(weights)

    x0 = np.array([[0.0]])
    gp = pt.GPRegression(x0, f(x0)[:, None], pt.RBF(1, variance=2.0),
                         noise_var=0.05 ** 2, **CPU)
    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-10.0, 10.0]],
                          threshold=0.2, seed=3)
    initial_safe = len(opt.S)
    for _ in range(10):
        x = opt.optimize()
        assert -10.0 <= float(x[0]) <= 10.0
        y = float(f(x[None, :])[0])
        opt.add_new_data_point(x, y)
        assert y > -0.5
    assert len(opt.S) > initial_safe
    assert float(opt.get_maximum()[1][0]) >= float(f(x0)[0])
    stats = opt.stats.history
    assert len(stats) == 10 and all(s.host_syncs == 1 for s in stats)
    assert not any(s.graph for s in stats) and opt.graph_captures == 0
    assert [s.safe_count for s in stats][-1] == len(opt.S)


def test_generator_makes_runs_reproducible_and_graph_needs_cuda():
    runs = []
    for _ in range(2):
        opt = pt.SafeOptSwarm(_one_gp(), fmin=[0.0], bounds=[[-3.0, 3.0]],
                              generator=torch.Generator().manual_seed(5))
        runs.append(opt.optimize())
    np.testing.assert_array_equal(*runs)
    with pytest.raises(ValueError, match="CUDA"):
        pt.SafeOptSwarm(_one_gp(), fmin=[0.0], bounds=[[-3.0, 3.0]],
                        graph=True)


def test_graph_key_tracks_what_a_capture_bakes_in():
    gp = _one_gp()
    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-3.0, 3.0]])
    args, kw = opt._fused_args()
    key = sf.graph_key(*args[:3], **kw)
    assert key == sf.graph_key(*args[:3], **kw)
    assert key != sf.graph_key(*args[:3], **dict(kw, ucb=True))
    other = (pt.Matern32(1, variance=2.0),)
    assert key != sf.graph_key(other, *args[1:3], **kw)
    opt.reserve(10)
    args2, _ = opt._fused_args()
    assert args2[2].S.shape[0] > args[2].S.shape[0]
    assert key != sf.graph_key(*args2[:3], **kw)


def test_sparse_model_matches_safeopt_tpu_with_injected_streams():
    """SafeOptSwarm on a sparse model: the greedy specials come from the
    observation store (``X_host``/``Y_host``), not the inducing points,
    in both packages; the queries agree (tolerance as the module
    docstring states)."""
    rng = np.random.default_rng(3)
    X0 = rng.uniform(-0.5, 0.5, size=(6, 2))
    Y0 = (2.0 * np.exp(-0.5 * np.sum(X0 ** 2, axis=1)))[:, None]

    def make(pkg, cls):
        gp = pkg.gp.SparseGPRegression(X0, Y0, pkg.RBF(2, variance=2.0),
                                       noise_var=1e-3, inducing=5,
                                       **(CPU if pkg is pt else {}))
        return cls(gp, fmin=[0.0], bounds=[(-2.0, 2.0)] * 2, swarm_size=10,
                   max_iters=20).attach(provider(9))

    ours, theirs = make(pt, Streamed), make(jt, JStreamed)
    head = ours._observations_head()
    np.testing.assert_array_equal(head[2:4], X0[-1])
    np.testing.assert_array_equal(head[4:6], X0[int(np.argmax(Y0))])
    for _ in range(3):
        x, xj = ours.optimize(), np.asarray(theirs.optimize())
        assert_allclose(x, xj, atol=1e-6)
        assert np.all(np.abs(x) <= 2.0)
        y = float(2.0 * np.exp(-0.5 * np.sum(x ** 2)))
        ours.add_new_data_point(x, y)
        theirs.add_new_data_point(xj, y)
    assert ours.gp.num_data == 9 and ours.gp.num_inducing == 5
    assert_allclose(ours.S, theirs.S, atol=1e-6)

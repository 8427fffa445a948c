"""The port's checkpoints on the CPU in float64, and their crossing with
safeopt_tpu's.

Mirrors ``tests/test_checkpoint.py`` case by case with the port's
optimizers (``device='cpu'``), then holds the format against the JAX
package's: a checkpoint ``safeopt_tpu.utils.checkpoint.save`` wrote
loads into the port, and one the port wrote loads into safeopt_tpu, for
exact, sparse, contextual and certified ``SafeOpt``; the loaded object's
next query equals the writer's (decisions equal, queries to 1e-10: the
loader refactors the data, so its factor agrees to round-off). A JAX
swarm checkpoint loads its data and settings and warns that its stream
restarts. A port checkpoint resumes the port bit for bit (its factors
are stored), and ``save_state`` resumes the device loops and a fleet bit
for bit from the tail of their noise and streams.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms.runner import (run_safeopt_loop,
                                             run_swarmopt_loop)
from safeopt_torch.algorithms.swarm_opt_fused import (SwarmIterState,
                                                      stream_layout)
from safeopt_torch.parallel import (run_safeopt_campaigns,
                                    stack_campaign_states)
from safeopt_torch.utils import checkpoint
from safeopt_torch.utils.checkpoint import load_state, save_state
from safeopt_tpu.utils import checkpoint as jax_checkpoint

CPU = dict(device="cpu")
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=F64)


def test_safeopt_roundtrip(tmp_path):
    gps = [pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                           pt.RBF(1, variance=2.0, lengthscale=0.8),
                           noise_var=0.01, **CPU),
           pt.GPRegression(np.array([[0.0]]), np.array([[0.7]]),
                           pt.Matern32(1, variance=1.5), noise_var=0.02,
                           **CPU)]
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)], 200)
    opt = pt.SafeOpt(gps, grid, fmin=[-np.inf, 0.0], threshold=0.1)
    opt.add_new_data_point(np.array([[0.5]]), np.array([[1.2, 0.8]]))
    opt.add_new_data_point(np.array([[1.0]]), np.array([[0.9, np.nan]]))
    x1 = opt.optimize()

    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert_allclose(opt2.x, opt.x)
    assert_allclose(opt2.y, opt.y)
    assert opt2.gps[0].num_data == opt.gps[0].num_data
    assert opt2.gps[1].num_data == opt.gps[1].num_data
    assert_allclose(opt2.optimize(), x1, atol=1e-12)
    q = np.linspace(-5, 5, 30)[:, None]
    for g1, g2 in zip(opt.gps, opt2.gps):
        for a, b in zip(g1.predict_noiseless(q), g2.predict_noiseless(q)):
            assert torch.equal(a, b)       # the stored factor: bit for bit


def test_safeopt_context_roundtrip(tmp_path):
    kern = pt.RBF(1, active_dims=[0]) * pt.RBF(1, active_dims=[1])
    gp = pt.GPRegression(np.array([[0.0, 0.0]]), np.array([[1.0]]), kern,
                         noise_var=0.01, **CPU)
    opt = pt.SafeOpt(gp, pt.linearly_spaced_combinations([(-1.0, 1.0)], 20),
                     fmin=[0.0], num_contexts=1)
    opt.context = 0.3
    path = str(tmp_path / "ckpt_ctx.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert_allclose(opt2.context, [0.3])
    assert opt2.num_contexts == 1


def test_swarm_roundtrip(tmp_path):
    gp = pt.GPRegression(np.array([[0.0], [0.4]]), np.array([[1.0], [0.8]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                          swarm_size=10)
    opt.optimize()
    path = str(tmp_path / "ckpt_swarm.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert_allclose(opt2.S, opt.S)
    assert_allclose(opt2.greedy_point, opt.greedy_point)
    assert opt2.best_lower_bound == opt.best_lower_bound
    assert opt2.swarm_size == 10
    x = opt2.optimize()
    assert -2.0 <= float(x[0]) <= 2.0


def test_safeopt_settings_roundtrip(tmp_path):
    """expander_chunk and use_lipschitz survive a roundtrip; the JAX
    package's use_pallas is written as its default."""
    gp = pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOpt(gp, pt.linearly_spaced_combinations([(-3.0, 3.0)], 100),
                     fmin=[0.0], lipschitz=[1.5], expander_chunk=8)
    assert opt.use_lipschitz
    opt.use_lipschitz = False
    path = str(tmp_path / "ckpt_settings.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert opt2._expander_chunk == 8
    assert opt2.use_lipschitz is False
    assert_allclose(opt2.lipschitz, [1.5])
    with np.load(path) as data:
        import json
        assert json.loads(str(data["__meta__"]))["use_pallas"] is None


def test_safeopt_oracle_roundtrip(tmp_path):
    gp = pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOpt(gp, pt.linearly_spaced_combinations([(-3.0, 3.0)], 50),
                     fmin=[0.0], exact_boundaries=True, oracle="device")
    path = str(tmp_path / "ckpt_oracle.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert opt2._oracle == "device"
    assert opt2._exact_boundaries is True


def test_swarm_max_iters_roundtrip(tmp_path):
    gp = pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                          swarm_size=10, max_iters=7)
    path = str(tmp_path / "ckpt_swarm_iters.npz")
    checkpoint.save(opt, path)
    assert checkpoint.load(path, **CPU).max_iters == 7


def test_callable_beta_warns(tmp_path, caplog):
    gp = pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOpt(gp, pt.linearly_spaced_combinations([(-3.0, 3.0)], 50),
                     fmin=[0.0], beta=lambda t: 2.0 + 0.1 * t)
    path = str(tmp_path / "ckpt_beta.npz")
    with caplog.at_level(logging.WARNING):
        checkpoint.save(opt, path)
    assert any("callable" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        opt2 = checkpoint.load(path, **CPU)
    assert any("callable" in r.message for r in caplog.records)
    assert opt2.beta(0) == opt.beta(opt.t)
    opt3 = checkpoint.load(path, beta=lambda t: 2.0 + 0.1 * t, **CPU)
    assert opt3.beta(5) == 2.5


def test_sparse_gp_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    X = rng.uniform(-2.0, 2.0, size=(30, 1))
    Y = np.exp(-0.5 * X ** 2) + 0.01 * rng.normal(size=(30, 1))
    gp = pt.SparseGPRegression(X, Y, pt.RBF(1, variance=2.0),
                               noise_var=0.01, inducing=8, **CPU)
    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                          swarm_size=10)
    path = str(tmp_path / "ckpt_sparse.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert type(opt2.gp).__name__ == "SparseGPRegression"
    assert_allclose(opt2.gp.Z, gp.Z)
    q = np.linspace(-2, 2, 20)[:, None]
    for a, b in zip(gp.predict_noiseless(q), opt2.gp.predict_noiseless(q)):
        assert_allclose(b, a, atol=1e-10)
    assert_allclose(opt2.optimize(), opt.optimize(), atol=1e-12)


def test_swarm_midrun_next_query_identical(tmp_path):
    gp = pt.GPRegression(np.array([[0.0], [0.3]]), np.array([[1.0], [0.9]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                          swarm_size=10, max_iters=20)
    for _ in range(3):
        x = opt.optimize()
        opt.add_new_data_point(np.atleast_2d(x),
                               np.array([[float(np.exp(-0.5 * x[0] ** 2))]]))
    path = str(tmp_path / "ckpt_swarm_mid.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path, **CPU)
    assert np.array_equal(opt2.optimize(), opt.optimize())


def _flagship_like(pkg, n_obs=12, **kw):
    rng = np.random.default_rng(3)
    X = rng.uniform(-1.0, 1.0, size=(n_obs, 2))
    f = lambda x: 2.0 * np.exp(-0.5 * np.sum(x ** 2, axis=1))  # noqa
    gps = [pkg.GPRegression(X, f(X)[:, None],
                            pkg.RBF(2, variance=2.0, lengthscale=1.0),
                            noise_var=0.01, capacity=32, **kw),
           pkg.GPRegression(X, (1.0 - 0.2 * np.sum(X ** 2, axis=1))[:, None],
                            pkg.RBF(2, variance=1.0, lengthscale=1.5),
                            noise_var=0.01, capacity=32, **kw)]
    grid = pkg.linearly_spaced_combinations([(-3.0, 3.0)] * 2, 17)
    return gps, grid, f


def test_resumed_safeopt_equals_the_unbroken_run_bitwise(tmp_path):
    """4 iterations, save, load into a fresh object, 4 more: the queries
    and the intervals are the 8 unbroken iterations' bit for bit."""
    def run(opt, n, out):
        for _ in range(n):
            x = opt.optimize()
            out.append((x, opt.Q.copy()))
            y = np.array([[2.0 * np.exp(-0.5 * np.sum(x ** 2)),
                           1.0 - 0.2 * np.sum(x ** 2)]])
            opt.add_new_data_point(x, y)

    gps, grid, _ = _flagship_like(pt, **CPU)
    unbroken = []
    run(pt.SafeOpt(gps, grid, fmin=[0.2, 0.5], expander_chunk=16), 8,
        unbroken)
    gps, grid, _ = _flagship_like(pt, **CPU)
    opt = pt.SafeOpt(gps, grid, fmin=[0.2, 0.5], expander_chunk=16)
    resumed = []
    run(opt, 4, resumed)
    path = str(tmp_path / "mid.npz")
    checkpoint.save(opt, path)
    run(checkpoint.load(path, **CPU), 4, resumed)
    for (x1, q1), (x2, q2) in zip(unbroken, resumed):
        assert_array_equal(x1, x2)
        assert_array_equal(q1, q2)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _sparse_pair(pkg, **kw):
    rng = np.random.default_rng(4)
    X = rng.uniform(-1.5, 1.5, size=(40, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    cls = pt.SparseGPRegression if pkg is pt else \
        jt.gp.sparse.SparseGPRegression
    gp = cls(X, Y, pkg.RBF(2, variance=2.0), noise_var=0.01, inducing=10,
             **kw)
    return gp, pkg.linearly_spaced_combinations([(-3.0, 3.0)] * 2, 15)


def _contextual(pkg, **kw):
    kern = (pkg.RBF(1, variance=2.0, lengthscale=0.8, active_dims=[0])
            * pkg.RBF(1, lengthscale=1.5, active_dims=[1]))
    X = np.array([[0.0, 0.0], [0.3, 0.5], [-0.4, 0.2]])
    gp = pkg.GPRegression(X, np.array([[1.0], [1.1], [0.9]]), kern,
                          noise_var=0.01, **kw)
    return gp, pkg.linearly_spaced_combinations([(-2.0, 2.0)], 60)


CASES = {
    "exact": lambda pkg, kw: (lambda g: (g[0], g[1], dict(fmin=[0.2, 0.5])))(
        _flagship_like(pkg, **kw)),
    "sparse": lambda pkg, kw: (lambda g: (g[0], g[1], dict(fmin=[0.3])))(
        _sparse_pair(pkg, **kw)),
    "contextual": lambda pkg, kw: (lambda g: (g[0], g[1], dict(
        fmin=[0.5], num_contexts=1)))(_contextual(pkg, **kw)),
    "certified": lambda pkg, kw: (lambda g: (g[0], g[1], dict(
        fmin=[0.2, 0.5], exact_boundaries=True, oracle="host")))(
        _flagship_like(pkg, **kw)),
}


def _step(opt):
    """The next query, at context 0.5 for a contextual optimizer."""
    return opt.optimize(context=0.5) if opt.num_contexts else opt.optimize()


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_loads_into_the_port(case, tmp_path):
    gps, grid, kw = CASES[case](jt, {})
    writer = jt.SafeOpt(gps, grid, **kw)
    _step(writer)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(writer, path)
    reader = checkpoint.load(path, **CPU)
    assert reader._exact_boundaries == writer._exact_boundaries
    assert reader._oracle == writer._oracle
    x_jax, x_port = _step(writer), _step(reader)
    assert_allclose(x_port, np.asarray(x_jax), rtol=0, atol=1e-10)
    assert_array_equal(reader.S, np.asarray(writer.S))
    assert_allclose(reader.Q, np.asarray(writer.Q), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_loads_into_safeopt_tpu(case, tmp_path):
    gps, grid, kw = CASES[case](pt, CPU)
    writer = pt.SafeOpt(gps, grid, **kw)
    _step(writer)
    path = str(tmp_path / "port.npz")
    checkpoint.save(writer, path)
    reader = jax_checkpoint.load(path)
    assert reader._exact_boundaries == writer._exact_boundaries
    x_port, x_jax = _step(writer), _step(reader)
    assert_allclose(np.asarray(x_jax), x_port, rtol=0, atol=1e-10)
    assert_array_equal(np.asarray(reader.S), writer.S)
    assert_allclose(np.asarray(reader.Q), writer.Q, rtol=0, atol=1e-10)


def test_certified_settings_cross_both_ways(tmp_path):
    """interval_precision, the oracle and the refine and boundary
    settings carry over, so that a certified run resumes certified."""
    gps, grid, _ = _flagship_like(pt, **CPU)
    opt = pt.SafeOpt(gps, grid, fmin=[0.2, 0.5], interval_precision="high",
                     boundary_band=2e-3, refine_band=3e-2, refine_k=64,
                     refine_band_k=100, boundary_k=50, oracle="host")
    path = str(tmp_path / "cert.npz")
    checkpoint.save(opt, path)
    for loaded in (checkpoint.load(path, **CPU), jax_checkpoint.load(path)):
        assert loaded._interval_precision == "high"
        assert loaded._exact_boundaries is True
        assert loaded._oracle == "host"
        assert (loaded._boundary_band, loaded._refine_band) == (2e-3, 3e-2)
        assert (loaded._refine_k, loaded._refine_band_k,
                loaded._boundary_k) == (64, 100, 50)


def test_jax_swarm_checkpoint_loads_its_data_and_warns(tmp_path, caplog):
    gp = jt.GPRegression(np.array([[0.0], [0.4]]), np.array([[1.0], [0.8]]),
                         jt.RBF(1, variance=2.0), noise_var=0.01)
    writer = jt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                             swarm_size=10, max_iters=9)
    writer.optimize()
    path = str(tmp_path / "jax_swarm.npz")
    jax_checkpoint.save(writer, path)
    with caplog.at_level(logging.WARNING):
        reader = checkpoint.load(path, seed=4, **CPU)
    assert any("PRNG key" in r.message for r in caplog.records)
    assert_allclose(reader.S, np.asarray(writer.S))
    assert_allclose(reader.greedy_point, np.asarray(writer.greedy_point))
    assert reader.best_lower_bound == writer.best_lower_bound
    assert (reader.swarm_size, reader.max_iters) == (10, 9)
    # the stream restarts from the seed: equal to a fresh seed-4 swarm's
    fresh = checkpoint.load(path, seed=4, **CPU)
    assert np.array_equal(fresh.optimize(), reader.optimize())


def test_port_swarm_checkpoint_loads_into_safeopt_tpu(tmp_path):
    gp = pt.GPRegression(np.array([[0.0], [0.4]]), np.array([[1.0], [0.8]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    writer = pt.SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                             swarm_size=10)
    writer.optimize()
    path = str(tmp_path / "port_swarm.npz")
    checkpoint.save(writer, path)
    reader = jax_checkpoint.load(path)
    assert_allclose(np.asarray(reader.S), writer.S)
    assert reader.best_lower_bound == writer.best_lower_bound
    assert -2.0 <= float(reader.optimize()[0]) <= 2.0


# ---------------------------------------------------------------------------
# device loop-state persistence
# ---------------------------------------------------------------------------

class TestCampaignPersistence:
    def _problem(self):
        x0 = np.array([[0.1, -0.1]])
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        gp = pt.GPRegression(x0, np.array([[y0]]),
                             pt.RBF(2, variance=2.0, lengthscale=1.2),
                             noise_var=1e-4, capacity=32, **CPU)
        grid = _t(pt.linearly_spaced_combinations([(-2.0, 2.0)] * 2, 15))
        args = dict(kernels=(gp.kern,), grid=grid, fmin=_t([0.5]),
                    scaling=_t([np.sqrt(2.0)]), threshold=_t([0.0]))
        return gp, args, lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    def test_safeopt_loop_resumes_bit_identically(self, tmp_path):
        gp, a, objective = self._problem()
        noise = _t(np.random.default_rng(42).normal(size=(10, 1)))
        common = dict(objectives=(objective,), noise_std=0.05, chunk=16)

        def run(states, noise, n):
            return run_safeopt_loop(a["kernels"], states, a["grid"],
                                    a["fmin"], 2.0, a["scaling"],
                                    a["threshold"], noise, n_iter=n,
                                    **common)

        full = run((gp.factor_state(),), noise, 10)
        head = run((gp.factor_state(),), noise[:6], 6)
        path = str(tmp_path / "campaign.npz")
        save_state(path, {"states": head.states, "noise": noise[6:],
                          "t": 6})
        ck = load_state(path, **CPU)
        assert ck["t"] == 6
        tail = run(tuple(ck["states"]), ck["noise"], 4)
        assert torch.equal(torch.cat([head.xs, tail.xs]), full.xs)
        assert torch.equal(torch.cat([head.next_idx, tail.next_idx]),
                           full.next_idx)
        for sf, st in zip(full.states, tail.states):
            assert torch.equal(sf.X, st.X) and torch.equal(sf.Linv, st.Linv)
            assert int(sf.count) == int(st.count)

    def test_swarm_loop_resumes_bit_identically(self, tmp_path):
        d = 2
        gp = pt.GPRegression(np.zeros((1, d)), np.array([[2.0]]),
                             pt.RBF(d, variance=2.0, lengthscale=1.5),
                             noise_var=1e-4, capacity=32, **CPU)
        layout = stream_layout(8, 8, d)
        U = sum(int(np.prod(s)) for _, s in layout)
        gen = torch.Generator().manual_seed(3)
        streams = torch.rand((8, U), generator=gen, dtype=F64)
        fixed = ((gp.kern,), _t([0.3, 0.3]), _t([[-3.0, 3.0]] * d),
                 _t([0.0]), _t([np.sqrt(2.0)]), _t([0.0]))
        sstate = SwarmIterState(S=torch.zeros((128, d), dtype=F64),
                                count=torch.tensor(1),
                                greedy=torch.zeros(d, dtype=F64))
        f = lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x))  # noqa

        def run(states, it_state, streams, greedy, blb):
            kernels, vel, bounds, fmin, scaling, thr = fixed
            n = streams.shape[0]
            return run_swarmopt_loop(
                kernels, states, it_state, vel, bounds, fmin, scaling, thr,
                np.full(n, 2.0), greedy, blb, streams, objectives=(f,),
                n_iter=n, swarm_size=8, max_iters=8)

        full = run((gp.factor_state(),), sstate, streams,
                   torch.zeros(d, dtype=F64), _t(-np.inf))
        head = run((gp.factor_state(),), sstate, streams[:5],
                   torch.zeros(d, dtype=F64), _t(-np.inf))
        path = str(tmp_path / "swarm.npz")
        save_state(path, {"states": head.states,
                          "iter_state": head.iter_state,
                          "streams": streams[5:], "t": 5,
                          "greedy": head.iter_state.greedy,
                          "blb": head.best_lower_bounds[-1],
                          "generator": gen})
        ck = load_state(path, **CPU)
        assert torch.equal(ck["generator"].get_state(), gen.get_state())
        tail = run(tuple(ck["states"]), ck["iter_state"], ck["streams"],
                   ck["greedy"], ck["blb"])
        assert torch.equal(torch.cat([head.xs, tail.xs]), full.xs)
        assert torch.equal(tail.iter_state.S, full.iter_state.S)

    def test_fleet_resumes_bit_identically(self, tmp_path):
        """A fleet round-trips through save_state with its leading
        campaign axis intact."""
        gp, a, objective = self._problem()
        rng = np.random.default_rng(0)
        per = []
        for _ in range(4):
            x0 = rng.uniform(-0.3, 0.3, size=(1, 2))
            g = pt.GPRegression(x0, np.array([[2.0 * np.exp(
                -0.5 * np.sum(x0 ** 2))]]), gp.kern, noise_var=1e-4,
                capacity=32, **CPU)
            per.append((g.factor_state(),))
        batched = stack_campaign_states(per)
        noise = _t(rng.normal(size=(4, 6, 1)))
        common = dict(objectives=(objective,), chunk=16, noise_std=0.05)

        def run(states, noise, n):
            return run_safeopt_campaigns(
                a["kernels"], states, a["grid"], a["fmin"], 2.0,
                a["scaling"], a["threshold"], noise, n_iter=n, **common)

        fullk = run(batched, noise, 6)
        headk = run(batched, noise[:, :3], 3)
        path = str(tmp_path / "fleet.npz")
        save_state(path, {"states": headk.states, "noise": noise, "t": 3})
        ck = load_state(path, **CPU)
        assert ck["states"][0].X.shape[0] == 4
        tailk = run(tuple(ck["states"]), ck["noise"][:, 3:], 3)
        assert torch.equal(torch.cat([headk.xs, tailk.xs], dim=1),
                           fullk.xs)


def test_load_state_reads_safeopt_tpu_arrays(tmp_path):
    """A tree of plain arrays that safeopt_tpu's save_state wrote loads
    here as tensors with their dtypes and shapes."""
    path = str(tmp_path / "jax_state.npz")
    jax_checkpoint.save_state(path, {"a": jnp.arange(4.0), "t": 3,
                                     "xs": [np.ones((2, 2)), None]})
    ck = load_state(path, **CPU)
    assert ck["t"] == 3 and ck["xs"][1] is None
    assert torch.equal(ck["a"], torch.arange(4.0, dtype=F64))
    assert ck["xs"][0].shape == (2, 2)

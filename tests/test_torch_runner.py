"""The port's device-side SafeOpt loop against safeopt_tpu's, on the CPU.

Mirrors the grid cases of ``tests/test_runner.py``: ``run_safeopt_loop``
gives the queries of safeopt_tpu's ``run_safeopt_loop`` to 1e-8 when
safeopt_tpu gets explicit ``it_keys`` and the port the normals
``jax.random.normal(it_keys[t], (G,))``; it reproduces the blocking
``SafeOpt`` loop (plain, contextual with a beta schedule, and with an
eager GP beside a K1 one); a hostile objective shows up in ``has_safe``;
a prefix and its resumption equal the whole run; in float32 its mirrors
hold the bits of ``GPRegression``'s one-row updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms.runner import run_safeopt_loop
from safeopt_tpu.algorithms.runner import run_safeopt_loop as jax_loop

CENTERS, WEIGHTS = [[-3.0], [0.0], [2.5]], [0.6, 1.0, -0.7]


def _f_jax(x):
    r2 = jnp.sum((x[None, :] - jnp.asarray(CENTERS)) ** 2, axis=1)
    return 2.0 * jnp.exp(-0.5 * r2) @ jnp.asarray(WEIGHTS)


def _f_torch(x):
    c = torch.tensor(CENTERS, dtype=x.dtype, device=x.device)
    w = torch.tensor(WEIGHTS, dtype=x.dtype, device=x.device)
    return 2.0 * torch.exp(-0.5 * torch.sum((x[None, :] - c) ** 2, dim=1)) @ w


def _g_torch(x):
    return 1.0 - 0.1 * torch.sum(x * x)


def _g_jax(x):
    return 1.0 - 0.1 * jnp.sum(x * x)


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


X0 = np.array([[0.0]])
GRID = pt.linearly_spaced_combinations([(-6.0, 6.0)], 200)


def _y0(fn):
    return np.array([[float(fn(torch.tensor([0.0], dtype=torch.float64)))]])


@pytest.mark.parametrize("noise_std", [0.0, 0.02])
def test_loop_matches_safeopt_tpu_with_the_same_noise(noise_std):
    n_iter = 8
    it_keys = jax.random.split(jax.random.key(3), n_iter)
    kw = dict(noise_var=1e-4, capacity=64)
    jgps = [jt.GPRegression(X0, _y0(f), jt.RBF(1, variance=2.0), **kw)
            for f in (_f_torch, _g_torch)]
    res_j = jax_loop(
        tuple(g.kern for g in jgps), tuple(g.state for g in jgps),
        jnp.asarray(GRID), jnp.asarray([-np.inf, 0.0]), jnp.asarray(2.0),
        jnp.asarray([np.sqrt(2.0), np.sqrt(2.0)]), jnp.asarray([0.1, 0.1]),
        jax.random.key(0), objectives=(_f_jax, _g_jax), n_iter=n_iter,
        noise_std=noise_std, chunk=16, it_keys=it_keys)
    normals = np.stack([np.asarray(jax.random.normal(it_keys[t], (2,)))
                        for t in range(n_iter)])
    pgps = [pt.GPRegression(X0, _y0(f), pt.RBF(1, variance=2.0),
                            device="cpu", **kw) for f in (_f_torch, _g_torch)]
    res = run_safeopt_loop(
        tuple(g.kern for g in pgps), tuple(g.factor_state() for g in pgps),
        _t(GRID), _t([-np.inf, 0.0]), 2.0, _t([np.sqrt(2.0)] * 2),
        _t([0.1, 0.1]), _t(normals), objectives=(_f_torch, _g_torch),
        n_iter=n_iter, noise_std=noise_std, chunk=16)
    assert_allclose(res.xs.numpy(), np.asarray(res_j.xs), rtol=0, atol=1e-8)
    assert_allclose(res.ys.numpy(), np.asarray(res_j.ys), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(res.next_idx.numpy(),
                                  np.asarray(res_j.next_idx))
    np.testing.assert_array_equal(res.safe_counts.numpy(),
                                  np.asarray(res_j.safe_counts))
    assert bool(res.has_safe.all())
    assert [int(s.count) for s in res.states] == [1 + n_iter] * 2
    assert res.host_syncs.shape == (n_iter,) and bool((res.host_syncs >= 1)
                                                      .all())


def _host_loop(make_kern, objectives, n_iter, contexts=None, betas=None,
               fmin=(0.0,), grid=GRID, **opt_kw):
    """The blocking SafeOpt loop on the same plant (float64, noise 0)."""
    nc = 0 if contexts is None else contexts.shape[1]
    x0 = np.zeros((1, grid.shape[1] + nc))
    y0 = [float(f(torch.tensor(x0[0]))) for f in objectives]
    gps = [pt.GPRegression(x0, np.array([[y]]), make_kern(i), noise_var=1e-4,
                           capacity=32, device="cpu")
           for i, y in enumerate(y0)]
    beta = 2.0 if betas is None else (lambda t: float(betas[t - 1]))
    opt = pt.SafeOpt(gps, grid, fmin=list(fmin), beta=beta, threshold=0.1,
                     num_contexts=nc, expander_chunk=16, **opt_kw)
    xs = []
    for t in range(n_iter):
        kw = {} if contexts is None else {"context": contexts[t]}
        x = np.asarray(opt.optimize(**kw))
        full = x if contexts is None else np.concatenate([x, contexts[t]])
        xs.append(full)
        y = np.array([[float(f(torch.tensor(full))) for f in objectives]])
        opt.add_new_data_point(x, y, **kw)
    return np.stack(xs), gps, opt


def test_loop_matches_the_blocking_loop():
    n_iter = 8
    make = lambda i: pt.RBF(1, variance=2.0)  # noqa: E731
    xs_host, gps, _ = _host_loop(make, (_f_torch,), n_iter)
    fresh = [pt.GPRegression(X0, _y0(_f_torch), make(0), noise_var=1e-4,
                             capacity=32, device="cpu")]
    res = run_safeopt_loop(
        (fresh[0].kern,), (fresh[0].factor_state(),), _t(GRID), _t([0.0]),
        2.0, _t([np.sqrt(2.0)]), _t([0.1]), objectives=(_f_torch,),
        n_iter=n_iter, chunk=16)
    assert_allclose(res.xs.numpy(), xs_host, rtol=0, atol=1e-8)
    # the grown state is the blocking loop's host factor
    for name in ("L", "Linv", "w"):
        assert_allclose(getattr(res.states[0], name).numpy(),
                        getattr(gps[0]._host, name), rtol=0, atol=1e-10)


def test_eager_and_kernel_routes_in_one_loop():
    """GP 0 on K1/K3's route, GP 1 RBF + White on the eager route."""
    n_iter = 6

    def make(i):
        return (pt.RBF(1, variance=2.0) if i == 0 else
                pt.RBF(1, variance=1.0, lengthscale=1.5)
                + pt.White(1, variance=1e-2))

    objectives = (_f_torch, _g_torch)
    xs_host, _, opt = _host_loop(make, objectives, n_iter, fmin=(0.0, 0.5),
                                 scaling=[np.sqrt(2.0), 1.0])
    assert opt.stats.last.eager_gps == 1
    x0 = np.zeros((1, 1))
    states = [pt.GPRegression(x0, np.array([[float(f(torch.zeros(1,
                              dtype=torch.float64)))]]), make(i),
                              noise_var=1e-4, capacity=32,
                              device="cpu").factor_state()
              for i, f in enumerate(objectives)]
    res = run_safeopt_loop(
        (make(0), make(1)), tuple(states), _t(GRID), _t([0.0, 0.5]), 2.0,
        _t([np.sqrt(2.0), 1.0]), _t([0.1, 0.1]), objectives=objectives,
        n_iter=n_iter, chunk=16)
    assert_allclose(res.xs.numpy(), xs_host, rtol=0, atol=1e-8)


def _ctx_kernel(pkg):
    return (pkg.RBF(1, variance=2.0, lengthscale=0.8, active_dims=[0])
            * pkg.RBF(1, variance=1.0, lengthscale=1.2, active_dims=[1]))


def _ctx_f_torch(x):
    return 2.0 * torch.exp(-0.5 * x[0] ** 2) * (1.0 + 0.3 * x[1])


def _ctx_f_jax(x):
    return 2.0 * jnp.exp(-0.5 * x[0] ** 2) * (1.0 + 0.3 * x[1])


def test_contextual_loop_matches_safeopt_tpu_and_the_blocking_loop():
    """Contexts and a beta schedule inside the loop: the same queries as
    safeopt_tpu's loop and as the blocking SafeOpt loop with the same
    context switches and beta(t)."""
    n_iter = 6
    contexts = np.array([[0.0], [0.0], [0.1], [0.1], [0.2], [0.2]])
    betas = 2.0 + 0.1 * np.arange(n_iter)
    params = pt.linearly_spaced_combinations([(-2.0, 2.0)], 41)
    grid = np.hstack([params, np.zeros((41, 1))])
    x0 = np.zeros((1, 2))
    y0 = np.array([[float(_ctx_f_torch(torch.zeros(2,
                                                   dtype=torch.float64)))]])
    jgp = jt.GPRegression(x0, y0, _ctx_kernel(jt), noise_var=1e-4,
                          capacity=16)
    res_j = jax_loop(
        (jgp.kern,), (jgp.state,), jnp.asarray(grid), jnp.asarray([0.5]),
        jnp.asarray(2.0), jnp.asarray([np.sqrt(2.0)]), jnp.asarray([0.0]),
        jax.random.key(0), objectives=(_ctx_f_jax,), n_iter=n_iter,
        chunk=16, contexts=jnp.asarray(contexts), betas=jnp.asarray(betas))
    pgp = pt.GPRegression(x0, y0, _ctx_kernel(pt), noise_var=1e-4,
                          capacity=16, device="cpu")
    res = run_safeopt_loop(
        (pgp.kern,), (pgp.factor_state(),), _t(grid), _t([0.5]), 2.0,
        _t([np.sqrt(2.0)]), _t([0.0]), objectives=(_ctx_f_torch,),
        n_iter=n_iter, chunk=16, contexts=contexts, betas=betas)
    assert bool(res.has_safe.all())
    assert_allclose(res.xs.numpy(), np.asarray(res_j.xs), rtol=0, atol=1e-8)
    xs_host, _, _ = _host_loop(lambda i: _ctx_kernel(pt), (_ctx_f_torch,),
                               n_iter, contexts=contexts, betas=betas,
                               fmin=(0.5,), grid=params,
                               scaling=[np.sqrt(2.0)])
    assert_allclose(res.xs.numpy(), xs_host, rtol=0, atol=1e-8)


def test_loop_reports_lost_certification():
    """A hostile objective that measures everything unsafe shows up in
    ``has_safe``; the loop runs on, as safeopt_tpu's does."""
    def hostile(x):
        return -5.0 * torch.ones((), dtype=x.dtype)

    gp = pt.GPRegression(X0, np.array([[1.0]]), pt.RBF(1, variance=2.0),
                         noise_var=1e-4, capacity=64, device="cpu")
    res = run_safeopt_loop(
        (gp.kern,), (gp.factor_state(),),
        _t(pt.linearly_spaced_combinations([(-2.0, 2.0)], 50)), _t([0.0]),
        2.0, _t([np.sqrt(2.0)]), _t([0.0]), objectives=(hostile,), n_iter=6,
        chunk=16)
    flags = res.has_safe.numpy()
    assert flags[0] and not flags[-1]
    assert int(res.states[0].count) == 7


def test_resume_from_a_prefix_and_generator_noise():
    """The noise drawn once from a generator is the noise tensor; a
    prefix of the run and its resumption with the rest of the tensor give
    the whole run."""
    gp = pt.GPRegression(X0, _y0(_f_torch), pt.RBF(1, variance=2.0),
                         noise_var=1e-4, capacity=64, device="cpu")
    args = ((gp.kern,), None, _t(GRID), _t([0.0]), 2.0, _t([np.sqrt(2.0)]),
            _t([0.1]))
    kw = dict(objectives=(_f_torch,), noise_std=0.01, chunk=16)

    def run(states, noise, n_iter):
        return run_safeopt_loop(args[0], states, *args[2:], noise,
                                n_iter=n_iter, **kw)

    whole = run((gp.factor_state(),), torch.Generator().manual_seed(5), 7)
    normals = torch.randn((7, 1), generator=torch.Generator().manual_seed(5),
                          dtype=torch.float64)
    again = run((gp.factor_state(),), normals, 7)
    assert torch.equal(whole.xs, again.xs) and torch.equal(whole.ys, again.ys)
    head = run((gp.factor_state(),), normals[:3], 3)
    tail = run(head.states, normals[3:], 4)
    assert torch.equal(torch.cat([head.xs, tail.xs]), whole.xs)
    assert torch.equal(torch.cat([head.ys, tail.ys]), whole.ys)


def test_float32_mirrors_take_the_row_updates_bits():
    """In float32 the loop's appends write rows that equal GPRegression's
    one-row mirror updates bit for bit."""
    n_iter = 5
    grid = pt.linearly_spaced_combinations([(-4.0, 4.0)], 300)
    gp = pt.GPRegression(X0, _y0(_f_torch), pt.RBF(1, variance=2.0),
                         noise_var=1e-4, capacity=16, device="cpu",
                         dtype=torch.float32)
    res = run_safeopt_loop(
        (gp.kern,), (gp.factor_state(),), _t(grid), _t([0.0]), 2.0,
        _t([np.sqrt(2.0)]), _t([0.1]), objectives=(_f_torch,),
        n_iter=n_iter, chunk=16, dtype=torch.float32)
    for x, y in zip(res.xs.numpy(), res.ys.numpy()):
        gp.append_data(x, y[0])
    from safeopt_torch.algorithms.runner import _mirror
    mirror = _mirror(res.states[0], torch.float32)
    for name in ("X", "Y", "L", "Linv", "w", "count"):
        assert torch.equal(getattr(mirror, name), getattr(gp.state, name)), \
            name
    assert_allclose(res.states[0].L.numpy(), gp._host.L, rtol=0, atol=1e-12)


def test_argument_checks():
    gp = pt.GPRegression(X0, _y0(_f_torch), pt.RBF(1), noise_var=1e-4,
                         capacity=4, device="cpu", dtype=torch.float32)
    args = (_t(GRID), _t([0.0]), 2.0, _t([1.0]), _t([0.1]))
    with pytest.raises(TypeError, match="float64"):
        run_safeopt_loop((gp.kern,), (gp.state,), *args,
                         objectives=(_f_torch,), n_iter=2)
    with pytest.raises(ValueError, match="capacities"):
        run_safeopt_loop((gp.kern,), (gp.factor_state(),), *args,
                         objectives=(_f_torch,), n_iter=4)
    with pytest.raises(ValueError, match="noise"):
        run_safeopt_loop((gp.kern,), (gp.factor_state(),), *args,
                         objectives=(_f_torch,), n_iter=2, noise_std=0.1)

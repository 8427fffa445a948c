"""The port's kernel families past the grid kernels, against safeopt_tpu.

Mirrors ``tests/test_kernels_extended.py`` for the port (hyperopt,
sparse, checkpoint and export have no port yet). Float64 on the CPU:
RatQuad, StdPeriodic, Linear, Poly and MLP (and White) give safeopt_tpu's
grams and ``Kdiag`` to 1e-12 (relative and absolute), their host mirrors
``np_kernel``/``np_kdiag`` give safeopt_tpu's, and the host factor
equals safeopt_tpu's to 1e-12 through appends and pops. A ``SafeOpt``
whose GP has such a kernel, alone or beside a GP the grid kernels take,
runs it on the eager route and decides in lockstep with safeopt_tpu
(S, M, G and ``next_idx`` equal at every step, Q to 1e-10), with V kept
or, past the byte limit, the grid in chunks; the certified path takes
the eager rows as they are.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import safe_opt_core as pcore
from safeopt_torch.convert import (gp_arrays, gp_from_arrays,
                                   kernel_from_params, kernel_params)
from safeopt_torch.gp import host_math as phost
from safeopt_torch.ops import fused_posterior as pfp
from safeopt_tpu.gp import host_math as jhost

TIGHT = dict(rtol=1e-12, atol=1e-12)

FAMILIES = {
    "ratquad": lambda p: p.RatQuad(2, variance=2.0, lengthscale=[0.8, 1.4],
                                   power=1.5, ARD=True),
    "stdperiodic": lambda p: p.StdPeriodic(2, variance=1.3, period=[1.5, 2.5],
                                           lengthscale=[0.7, 1.1], ARD1=True,
                                           ARD2=True),
    "stdperiodic_scalar": lambda p: p.StdPeriodic(1, period=2.0,
                                                  active_dims=[1]),
    "linear": lambda p: p.Linear(2, variances=[0.5, 2.0], ARD=True),
    "poly": lambda p: p.Poly(2, variance=1.3, scale=0.5, bias=0.7, order=3),
    "mlp": lambda p: p.MLP(2, variance=1.2, weight_variance=[1.0, 2.0],
                           bias_variance=0.4, ARD=True),
    "white": lambda p: p.White(2, variance=0.3),
    "linear_plus_rbf": lambda p: (p.Linear(2, variances=0.3)
                                  + p.RBF(2, variance=1.5)),
    "poly_times_ratquad": lambda p: (p.Poly(1, order=2, active_dims=[0])
                                     * p.RatQuad(1, active_dims=[1])),
}


def _points(seed, n, d=2, spread=2.0):
    return np.random.default_rng(seed).uniform(-spread, spread, size=(n, d))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gram_and_kdiag_match_jax(name):
    jk = FAMILIES[name](jt)
    pk = FAMILIES[name](pt)
    X, Z = _points(1, 7), _points(2, 5)
    tX, tZ = torch.tensor(X), torch.tensor(Z)
    assert_allclose(pk.K(tX, tZ).numpy(), np.asarray(jk.K(X, Z)), **TIGHT)
    assert_allclose(pk.K(tX).numpy(), np.asarray(jk.K(X)), **TIGHT)
    assert_allclose(pk.Kdiag(tX).numpy(), np.asarray(jk.Kdiag(X)), **TIGHT)
    # convert.py carries the parameters across
    ck = kernel_from_params(**kernel_params(jk))
    assert kernel_params(ck).keys() == kernel_params(jk).keys()
    assert_allclose(ck.K(tX, tZ).numpy(), np.asarray(jk.K(X, Z)), **TIGHT)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_host_mirrors_match_jax(name):
    jk, pk = FAMILIES[name](jt), FAMILIES[name](pt)
    X, Z = _points(3, 6), _points(4, 4)
    assert_allclose(phost.np_kernel(pk, X, Z), jhost.np_kernel(jk, X, Z),
                    **TIGHT)
    assert_allclose(phost.np_kernel(pk, X), jhost.np_kernel(jk, X), **TIGHT)
    assert_allclose(phost.np_kdiag(pk, X), jhost.np_kdiag(jk, X), **TIGHT)
    # the host mirror is the kernel's own gram
    assert_allclose(phost.np_kernel(pk, X, Z),
                    pk.K(torch.tensor(X), torch.tensor(Z)).numpy(), **TIGHT)


@pytest.mark.parametrize("name", ["ratquad", "stdperiodic", "linear_plus_rbf",
                                  "poly_times_ratquad", "mlp"])
def test_host_factor_matches_jax_through_updates(name):
    X = _points(5, 6)
    Y = np.sin(X.sum(axis=1, keepdims=True))
    pgp = pt.GPRegression(X, Y, FAMILIES[name](pt), noise_var=0.05,
                          capacity=8, device="cpu")
    jgp = jt.GPRegression(X, Y, FAMILIES[name](jt), noise_var=0.05,
                          capacity=8)
    rng = np.random.default_rng(6)
    for step in range(4):                       # crosses capacity 8 -> 16
        if step == 2:
            pgp.pop_data()
            jgp.pop_data()
        x = rng.uniform(-2, 2, size=2)
        pgp.append_data(x, float(np.sin(x.sum())))
        jgp.append_data(x, float(np.sin(x.sum())))
        for field in ("L", "Linv", "w"):
            assert_allclose(getattr(pgp._host, field),
                            np.asarray(getattr(jgp._host, field)),
                            rtol=1e-10, atol=1e-12, err_msg=field)
    Xq = _points(7, 9)
    for a, b in zip(pgp.predict_f64(Xq), jgp.predict_f64(Xq)):
        assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_validation_rules_hold():
    with pytest.raises(ValueError, match="positive integer"):
        pt.Poly(1, order=2.5)
    with pytest.raises(ValueError, match="positive integer"):
        pt.Poly(1, order=0)
    with pytest.raises(ValueError, match="1-D"):
        pt.Cosine(2)
    assert pt.Poly(1, order=2.0).order == 2.0
    # StdPeriodic: one period apart is the same point
    k = pt.StdPeriodic(1, period=1.7)
    x = torch.tensor([[0.3]], dtype=torch.float64)
    assert_allclose(k.K(x, x + 1.7).numpy(), k.K(x, x).numpy(), rtol=1e-12)
    # MLP: the self gram's diagonal is Kdiag
    m = FAMILIES["mlp"](pt)
    X = torch.tensor(_points(8, 5))
    assert_allclose(torch.diagonal(m.K(X)).numpy(), m.Kdiag(X).numpy(),
                    rtol=1e-12)
    # White: variance on one set's diagonal, zero across two sets
    w = pt.White(2, variance=0.7)
    assert torch.equal(w.K(X), 0.7 * torch.eye(5, dtype=torch.float64))
    assert not w.K(X, X.clone()).any()
    # scaling='auto' refuses a Linear-only GP (its prior std at 0 is 0)
    gp = pt.GPRegression(np.ones((1, 1)), np.ones((1, 1)), pt.Linear(1),
                         noise_var=0.1, device="cpu")
    with pytest.raises(ValueError, match="scaling"):
        pt.SafeOpt(gp, np.linspace(-1, 1, 5)[:, None], fmin=[0.0])


def test_copies_are_independent():
    for name, make in FAMILIES.items():
        k = make(pt)
        c = k.copy()
        assert kernel_params(c).keys() == kernel_params(k).keys(), name
        X = torch.tensor(_points(9, 4))
        assert torch.equal(c.K(X), k.K(X)), name


def test_the_grid_kernels_take_none_of_them():
    for name in ("ratquad", "stdperiodic", "linear", "poly", "mlp", "white",
                 "linear_plus_rbf", "poly_times_ratquad"):
        k = FAMILIES[name](pt)
        assert not pfp.supports_kernel(k, 2), name
        assert not pfp.supports_plan(k, 2), name
        state = pt.GPRegression(np.zeros((1, 2)), np.ones((1, 1)), k,
                                noise_var=0.1, device="cpu").state
        assert pcore._gp_groups((k,), (state,), 2) == [([0], "eager")]


# -- trajectories in lockstep with safeopt_tpu --------------------------------

def _plant(x):
    x = np.atleast_1d(np.asarray(x, dtype=float))
    return np.array([[1.4 * np.exp(-0.5 * np.sum(x ** 2)) + 0.2 * x[0],
                      1.0 - 0.12 * np.sum(x ** 2)]])


def _lockstep(make_kerns, d=1, iters=6, n_grid=120, fmin=(0.0, 0.3),
              x0=None, **opt_kw):
    """Port and safeopt_tpu SafeOpt over the same models (factors carried
    across with convert.py); asserts equal decisions at every step."""
    G = len(make_kerns)
    x0 = np.zeros((1, d)) if x0 is None else x0
    Y0 = _plant(x0[0])[:, :G]
    jgps = [jt.GPRegression(x0, Y0[:, i:i + 1], make(jt), noise_var=1e-3,
                            capacity=32)
            for i, make in enumerate(make_kerns)]
    pgps = [gp_from_arrays(kernel_from_params(**kernel_params(g.kern)),
                           **gp_arrays(g), device="cpu") for g in jgps]
    grid = pt.linearly_spaced_combinations([(-3.0, 3.0)] * d, n_grid)
    kw = dict(dict(fmin=list(fmin[:G]), threshold=0.05, scaling=[1.0] * G),
              **opt_kw)
    jopt = jt.SafeOpt(jgps, grid, use_pallas=False, **kw)
    popt = pt.SafeOpt(pgps, grid, **kw)
    walked = 0
    for it in range(iters):
        x = np.asarray(popt.optimize())
        xj = np.asarray(jopt.optimize())
        for name in ("S", "M", "G"):
            np.testing.assert_array_equal(getattr(popt, name),
                                          np.asarray(getattr(jopt, name)),
                                          err_msg=f"{name} at {it}")
        assert popt.stats.last.next_index == jopt.stats.last.next_index, it
        assert_allclose(x, xj, atol=1e-12)
        assert_allclose(popt.Q, np.asarray(jopt.Q), rtol=0, atol=1e-10)
        walked += popt.stats.last.walk_chunks
        y = _plant(x)[:, :G]
        popt.add_new_data_point(x, y)
        jopt.add_new_data_point(x, y)
    return popt, walked


TRAJECTORIES = {
    "white": [lambda p: p.RBF(1, variance=2.0, lengthscale=0.9)
              + p.White(1, variance=0.02)],
    "ratquad": [lambda p: p.RatQuad(1, variance=2.0, lengthscale=0.9,
                                    power=1.2)],
    "stdperiodic": [lambda p: p.StdPeriodic(1, variance=2.0, period=7.0,
                                            lengthscale=1.2)],
    "linear_plus_rbf": [lambda p: p.Linear(1, variances=0.1)
                        + p.RBF(1, variance=2.0)],
    "poly_plus_rbf": [lambda p: p.Poly(1, variance=0.05, order=2)
                      + p.RBF(1, variance=2.0)],
    "mlp": [lambda p: p.MLP(1, variance=2.0, weight_variance=2.0)],
    # GP 0 on K1/K3's route, GP 1 eager: one step mixes both
    "mixed": [lambda p: p.RBF(1, variance=2.0),
              lambda p: p.RBF(1, variance=1.0, lengthscale=1.5)
              + p.White(1, variance=1e-2)],
    # a K2/K4 GP beside an eager one
    "mixed_plan": [lambda p: p.RBF(1, variance=2.0) + p.Bias(1, 0.1),
                   lambda p: p.RatQuad(1, power=2.0)],
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_trajectory_lockstep_with_jax(name):
    popt, _ = _lockstep(TRAJECTORIES[name])
    eager = sum(r == "eager" for _, r in pcore._gp_groups(
        [g.kern for g in popt.gps], [g.state for g in popt.gps], 1))
    assert popt.stats.last.eager_gps == eager >= 1


def test_mixed_trajectory_in_two_dimensions_walks():
    """The flagship's mixed routes at a small size: GP 0 on K1/K3, GP 1
    RBF + White on the eager route; the walk tests candidates."""
    popt, walked = _lockstep([
        lambda p: p.RBF(2, variance=2.0),
        lambda p: p.RBF(2, variance=1.0, lengthscale=1.5)
        + p.White(2, variance=1e-2)], d=2, n_grid=25, iters=6,
        x0=np.array([[0.3, -0.2]]), fmin=(0.2, 0.5),
        scaling=[np.sqrt(2.0), 1.0])
    assert walked > 0
    assert [r for _, r in pcore._gp_groups(
        [g.kern for g in popt.gps], [g.state for g in popt.gps], 2)] == [
        "batched", "eager"]


def test_chunked_eager_route_decides_as_the_kept_v(monkeypatch):
    """Past ``_V_BYTES_LIMIT`` the eager route runs the grid in chunks
    with V not kept (the expander then takes ``M2 @ k(X, grid)``): the
    same decisions as safeopt_tpu, whose V fits here."""
    monkeypatch.setattr(pcore, "_V_BYTES_LIMIT", 1024)
    monkeypatch.setattr(pcore, "_CHUNK_ROWS", 7)
    _, walked = _lockstep(TRAJECTORIES["mixed"])
    assert walked > 0


@pytest.mark.parametrize("oracle", ["host", "device"])
def test_certified_path_takes_the_eager_rows(oracle):
    """exact_boundaries with interval_precision='high': GP 0 takes the
    three-pass K1-3p pass and the refinement, GP 1 (eager) its rows as
    they are; the decisions are safeopt_tpu's at every step."""
    _lockstep(TRAJECTORIES["mixed"], iters=4, exact_boundaries=True,
              interval_precision="high", oracle=oracle, boundary_band=1e-2,
              refine_k=64, refine_band=2e-2, refine_band_k=120)


def test_eager_rows_match_the_host_oracle():
    """The eager route's intervals are ``mu -+ beta sigma`` of the host
    float64 factor's prediction."""
    X = _points(11, 9)
    Y = np.cos(X.sum(axis=1, keepdims=True))
    kern = FAMILIES["linear_plus_rbf"](pt)
    gp = pt.GPRegression(X, Y, kern, noise_var=0.01, device="cpu")
    grid = torch.tensor(_points(12, 300, spread=3.0))
    Q, mu, sigma, Vs = pcore._grid_posterior((kern,), (gp.state,), grid, 2.0)
    mu64, var64 = gp.predict_f64(grid.numpy())
    assert_allclose(mu[0].numpy(), mu64, rtol=0, atol=1e-10)
    assert_allclose(Q[:, 0].numpy(), mu64 - 2.0 * np.sqrt(var64), rtol=0,
                    atol=1e-10)
    assert Vs[0] is not None and Vs[0].shape == (gp.state.capacity, 300)

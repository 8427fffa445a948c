"""The port's GP engine against the JAX package's, float64 on the CPU.

The host factor of the port (SciPy float64) must equal the JAX
``HostFactor``'s (which may run its native C++ engine) to 1e-12 after
construction, appends, pops and growth. The device mirror's one-row
updates must equal a full rebuild of the mirror bit for bit, and
``convert.py`` must carry a JAX model's factor across unchanged.
"""

import inspect

import numpy as np
import pytest
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
import torch
from safeopt_torch.convert import (gp_arrays, gp_from_arrays,
                                   kernel_from_params, kernel_params)
from safeopt_torch.gp.regression import _next_capacity

TOL = dict(rtol=0, atol=1e-12)


def _data(seed, n, d=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    Y = np.sin(X.sum(axis=1, keepdims=True)) + 0.05 * rng.normal(size=(n, 1))
    return X, Y


def _pair(family="RBF", n=8, capacity=None, seed=0):
    X, Y = _data(seed, n)
    kw = dict(variance=1.5, lengthscale=[0.7, 1.4], ARD=True)
    pgp = pt.GPRegression(X, Y, getattr(pt, family)(2, **kw),
                          noise_var=0.01, capacity=capacity, device="cpu")
    jgp = jt.GPRegression(X, Y, getattr(jt, family)(2, **kw),
                          noise_var=0.01, capacity=capacity)
    return pgp, jgp


def _assert_factor_equal(pgp, jgp):
    ph, jh = pgp._host, jgp._host
    assert ph.count == jh.count
    for name in ("X", "Y", "L", "Linv", "w"):
        assert_allclose(getattr(ph, name), np.asarray(getattr(jh, name)),
                        err_msg=name, **TOL)


@pytest.mark.parametrize("family", ["RBF", "Matern32", "Matern52",
                                    "Exponential"])
def test_factor_matches_jax_through_updates(family):
    pgp, jgp = _pair(family, n=6, capacity=8)
    _assert_factor_equal(pgp, jgp)
    rng = np.random.default_rng(3)
    for _ in range(4):                 # crosses capacity 8 -> 16
        x, y = rng.uniform(-2, 2, size=2), float(rng.normal())
        pgp.append_data(x, y)
        jgp.append_data(x, y)
        _assert_factor_equal(pgp, jgp)
    assert pgp.state.capacity == jgp.state.capacity == 16
    pgp.pop_data()
    jgp.pop_data()
    _assert_factor_equal(pgp, jgp)


def test_predictions_match_jax():
    pgp, jgp = _pair(n=10)
    Xq = np.random.default_rng(4).uniform(-3, 3, size=(31, 2))
    mu, var = pgp.predict_noiseless(Xq)
    mu_j, var_j = jgp.predict_noiseless(Xq)
    assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    assert_allclose(var.numpy(), np.asarray(var_j), **TOL)
    mu64, var64 = pgp.predict_f64(Xq)
    mu64_j, var64_j = jgp.predict_f64(Xq)
    assert_allclose(mu64, mu64_j, **TOL)
    assert_allclose(var64, var64_j, **TOL)
    _, var_obs = pgp.predict(Xq)
    assert_allclose(var_obs.numpy(), var.numpy() + 0.01, rtol=1e-15)


def _rebuilt(gp):
    return gp._device_state()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row_scatter_equals_rebuild_bitwise(dtype):
    X, Y = _data(1, 5)
    gp = pt.GPRegression(X, Y, pt.RBF(2, variance=2.0), noise_var=0.01,
                         capacity=16, device="cpu", dtype=dtype)
    rng = np.random.default_rng(9)
    for step in range(6):
        if step == 3:
            gp.pop_data()
        else:
            gp.append_data(rng.uniform(-2, 2, size=2), float(rng.normal()))
        full = _rebuilt(gp)
        for name, a, b in zip(full._fields, gp.state, full):
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), f"{name} differs after step {step}"


def test_state_is_a_copy_of_the_host_factor():
    X, Y = _data(2, 4)
    gp = pt.GPRegression(X, Y, pt.RBF(2), noise_var=0.01, device="cpu")
    before = gp.state.L.clone()
    gp._host.L[0, 0] = 123.0          # host mutation must not leak
    assert torch.equal(gp.state.L, before)


def test_set_xy_append_truncate_and_refit():
    X, Y = _data(5, 9)
    gp = pt.GPRegression(X[:4], Y[:4], pt.Matern32(2), noise_var=0.01,
                         device="cpu")
    gp.set_XY(X, Y)                                    # pure append
    ref = pt.GPRegression(X, Y, pt.Matern32(2), noise_var=0.01,
                          device="cpu")
    assert_allclose(gp._host.L, ref._host.L, **TOL)
    gp.set_XY(X[:6], Y[:6])                            # pure truncate
    assert gp.num_data == 6
    gp.set_XY(X[::-1].copy(), Y[::-1].copy())          # full refit
    assert gp.num_data == 9
    np.testing.assert_array_equal(gp.X.numpy(), X[::-1])


def test_next_capacity():
    assert _next_capacity(1) == 64
    assert _next_capacity(65) == 128
    assert _next_capacity(3, minimum=2) == 4


def test_convert_carries_the_jax_factor():
    _, jgp = _pair("Matern52", n=7)
    kern = kernel_from_params(**kernel_params(jgp.kern))
    assert type(kern) is pt.Matern52
    pgp = gp_from_arrays(kern, **gp_arrays(jgp), device="cpu")
    for name in ("X", "Y", "L", "Linv", "w"):
        np.testing.assert_array_equal(getattr(pgp._host, name),
                                      np.asarray(getattr(jgp._host, name)))
    np.testing.assert_array_equal(pgp.state.Linv.numpy(),
                                  np.asarray(jgp.state.Linv))


def test_convert_round_trip_within_the_port():
    pgp, _ = _pair("Exponential", n=5)
    params = kernel_params(pgp.kern)
    twin = gp_from_arrays(kernel_from_params(**params), **gp_arrays(pgp),
                          device="cpu", dtype=torch.float32)
    assert kernel_params(twin.kern).keys() == params.keys()
    assert twin.state.L.dtype == torch.float32
    assert torch.equal(twin.state.L, pgp.state.L.float())


def test_convert_rejects_partial_or_misshapen_factors():
    pgp, _ = _pair(n=3)
    arrays = gp_arrays(pgp)
    with pytest.raises(ValueError, match="all of"):
        gp_from_arrays(pgp.kern, **dict(arrays, Linv=None), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        gp_from_arrays(pgp.kern, **dict(arrays, w=arrays["w"][:3]),
                       device="cpu")
    # a kind neither package has
    with pytest.raises(NotImplementedError):
        kernel_from_params("brownian", input_dim=1, variance=1.0)


def test_convert_carries_a_jax_kernel_tree():
    jk = (jt.RBF(1, variance=2.0, lengthscale=1.5, active_dims=[0])
          * jt.Cosine(1, variance=0.7, active_dims=[1])
          + jt.Bias(2, variance=0.3) + jt.White(2, variance=0.01))
    params = kernel_params(jk)
    assert params["kind"] == "sum" and params["k1"]["k2"]["kind"] == "bias"
    pk = kernel_from_params(**params)
    assert type(pk.k1.k1.k1) is pt.RBF and type(pk.k2) is pt.White
    X = np.random.default_rng(6).uniform(-2, 2, size=(9, 2))
    assert_allclose(pk.K(torch.tensor(X)).numpy(), np.asarray(jk.K(X)),
                    rtol=1e-12, atol=1e-14)


def test_entry_points_default_to_the_card():
    for fn in (pt.GPRegression.__init__, gp_from_arrays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

"""The port's functional GP engine against safeopt_tpu's, float64 on the CPU.

Mirrors the engine cases of ``tests/test_gp.py``: ``gp_fit``,
``gp_append``, ``gp_pop``, ``gp_predict`` and ``predict_from_factors``
over padded ``GPState`` buffers give the JAX functions' factors to 1e-12
(the same masking: identity rows past ``count``); an incremental append
equals a full fit, append then pop is the identity, and 150 interleaved
appends and pops do not drift from a fresh fit. ``GPRegression``'s
``log_likelihood`` and ``HostFactor.posterior_cov`` match safeopt_tpu's to
1e-9; ``posterior_samples_f`` given safeopt_tpu's standard normals draws
its samples, and with a ``torch.Generator`` has the posterior's moments
and correlations; ``refit`` and ``factor_state`` hold the host factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.gp import (gp_append, gp_fit, gp_pop, gp_predict,
                              predict_from_factors)
from safeopt_tpu.gp import regression as jreg

from reference_impl import RefGP, RefRBF

TIGHT = dict(rtol=0, atol=1e-12)
KERNELS = {
    "rbf": lambda p: p.RBF(2, variance=2.0, lengthscale=0.8),
    "matern32_ard": lambda p: p.Matern32(2, lengthscale=[0.7, 1.3],
                                         ARD=True),
    "rbf_plus_white": lambda p: (p.RBF(2, variance=1.5)
                                 + p.White(2, variance=0.05)),
    "ratquad_times_linear": lambda p: (p.RatQuad(1, active_dims=[0])
                                       * p.Linear(1, active_dims=[1])
                                       + p.Bias(2, variance=0.5)),
}


def _padded(seed, n, cap, d=2):
    rng = np.random.default_rng(seed)
    X = np.zeros((cap, d))
    Y = np.zeros((cap, 1))
    X[:n] = rng.uniform(-2.0, 2.0, size=(n, d))
    Y[:n] = np.sin(X[:n].sum(axis=1, keepdims=True))
    return X, Y


def _assert_state_equal(ps, js, tol=TIGHT, fields=("X", "Y", "L", "Linv",
                                                    "w")):
    assert int(ps.count) == int(js.count)
    for name in fields:
        assert_allclose(getattr(ps, name).numpy(),
                        np.asarray(getattr(js, name)), err_msg=name, **tol)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_fit_append_pop_match_jax(name):
    X, Y = _padded(1, 9, 16)
    pk, jk = KERNELS[name](pt), KERNELS[name](jt)
    ps = gp_fit(pk, torch.tensor(X), torch.tensor(Y), 6, 0.01)
    js = jreg.gp_fit(jk, jnp.asarray(X), jnp.asarray(Y), 6, 0.01)
    _assert_state_equal(ps, js)
    for i in (6, 7, 8):
        ps = gp_append(pk, ps, torch.tensor(X[i]), float(Y[i, 0]))
        js = jreg.gp_append(jk, js, jnp.asarray(X[i]), float(Y[i, 0]))
        _assert_state_equal(ps, js)
    ps, js = gp_pop(ps), jreg.gp_pop(js)
    _assert_state_equal(ps, js)
    Xq = np.random.default_rng(2).uniform(-3, 3, size=(11, 2))
    for a, b in zip(gp_predict(pk, ps, torch.tensor(Xq)),
                    jreg.gp_predict(jk, js, jnp.asarray(Xq))):
        assert_allclose(a.numpy(), np.asarray(b), **TIGHT)
    mask = (np.arange(16) < 8).astype(float)
    for a, b in zip(
            predict_from_factors(pk, ps.X, torch.tensor(mask), ps.Linv,
                                 ps.w, torch.tensor(Xq)),
            jreg.predict_from_factors(jk, js.X, jnp.asarray(mask), js.Linv,
                                      js.w, jnp.asarray(Xq))):
        assert_allclose(a.numpy(), np.asarray(b), **TIGHT)


def test_incremental_append_equals_a_full_fit():
    X, Y = _padded(3, 20, 32)
    k = KERNELS["rbf_plus_white"](pt)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    st = gp_fit(k, tX, tY, 1, 1e-3)
    for i in range(1, 20):
        st = gp_append(k, st, tX[i], tY[i, 0])
    full = gp_fit(k, tX, tY, 20, 1e-3)
    assert int(st.count) == 20
    for name in ("L", "Linv", "w"):
        assert_allclose(getattr(st, name).numpy(),
                        getattr(full, name).numpy(), rtol=0, atol=1e-10,
                        err_msg=name)
    # and the GPRegression wrapper's host factor, through factor_state
    gp = pt.GPRegression(X[:20], Y[:20], k, noise_var=1e-3, capacity=32,
                         device="cpu")
    _assert_state_equal(gp.factor_state(), st, dict(rtol=0, atol=1e-10))


def test_append_then_pop_is_the_identity():
    X, Y = _padded(4, 5, 8)
    k = KERNELS["rbf"](pt)
    st = gp_fit(k, torch.tensor(X), torch.tensor(Y), 5, 0.1)
    back = gp_pop(gp_append(k, st, torch.tensor([1.0, -1.0]), 0.5))
    for name in ("count", "L", "Linv", "w"):
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    Xq = torch.tensor(np.random.default_rng(5).normal(size=(8, 2)))
    for a, b in zip(gp_predict(k, back, Xq), gp_predict(k, st, Xq)):
        assert torch.equal(a, b)


def test_no_drift_over_many_appends_and_pops():
    """150 interleaved appends and pops: the incremental factor stays
    within float64 noise of a fresh factorization of its data."""
    rng = np.random.default_rng(21)
    k = KERNELS["rbf"](pt)
    cap = 128
    st = gp_fit(k, torch.zeros((cap, 2), dtype=torch.float64),
                torch.zeros((cap, 1), dtype=torch.float64), 0, 1e-4)
    for i in range(150):
        st = gp_append(k, st, torch.tensor(rng.uniform(-3, 3, size=2)),
                       float(rng.normal()))
        if i % 3 == 2:
            st = gp_pop(st)
    fresh = gp_fit(k, st.X, st.Y, st.count, 1e-4)
    Xq = torch.tensor(rng.uniform(-3, 3, size=(20, 2)))
    for a, b in zip(gp_predict(k, st, Xq), gp_predict(k, fresh, Xq)):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-11)


def test_functional_predict_matches_the_reference():
    kern = pt.RBF(1)
    st = pt.GPRegression(np.zeros((1, 1)), np.ones((1, 1)), kern,
                         noise_var=0.1, device="cpu").factor_state()
    st2 = gp_append(kern, st, torch.tensor([0.5]), torch.tensor(2.0))
    mu, var = gp_predict(kern, st2, torch.tensor([[0.25]]))
    ref = RefGP(np.array([[0.0], [0.5]]), np.array([[1.0], [2.0]]),
                RefRBF(1), noise_var=0.1)
    rmu, rvar = ref.predict_noiseless(np.array([[0.25]]))
    assert_allclose(mu.numpy(), rmu[:, 0], rtol=1e-9)
    assert_allclose(var.numpy(), rvar[:, 0], rtol=1e-9)
    assert int(gp_pop(st2).count) == 1


def _twins(n=15, seed=4, kern="rbf_1d"):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    Y = np.sin(X) + 0.05 * rng.normal(size=(n, 1))

    def make(p):
        if kern == "rbf_1d":
            return p.RBF(1, variance=2.0, lengthscale=1.0)
        return p.StdPeriodic(1, period=4.0) + p.Linear(1, variances=0.2)

    return (pt.GPRegression(X, Y, make(pt), noise_var=0.05 ** 2,
                            device="cpu"),
            jt.GPRegression(X, Y, make(jt), noise_var=0.05 ** 2))


@pytest.mark.parametrize("kern", ["rbf_1d", "periodic_plus_linear"])
def test_log_likelihood_and_posterior_cov_match_jax(kern):
    pgp, jgp = _twins(kern=kern)
    assert_allclose(pgp.log_likelihood(), jgp.log_likelihood(), rtol=0,
                    atol=1e-9)
    Xq = np.linspace(-3.5, 3.5, 9)[:, None]
    assert_allclose(pgp._host.posterior_cov(Xq),
                    jgp._host.posterior_cov(Xq), rtol=0, atol=1e-9)
    if kern == "rbf_1d":                 # the direct formula
        X, Y = pgp.X_host, pgp.Y_host
        K = 2.0 * np.exp(-0.5 * (X - X.T) ** 2) + 0.05 ** 2 * np.eye(15)
        _, logdet = np.linalg.slogdet(K)
        want = (-0.5 * Y[:, 0] @ np.linalg.solve(K, Y[:, 0])
                - 0.5 * logdet - 7.5 * np.log(2 * np.pi))
        assert_allclose(pgp.log_likelihood(), want, rtol=1e-8)


def test_posterior_samples_with_jax_normals_match_jax():
    pgp, jgp = _twins()
    Xq = np.linspace(-3, 3, 7)[:, None]
    key = jax.random.key(1)
    want = jgp.posterior_samples_f(Xq, size=5, key=key)
    normals = np.asarray(jax.random.normal(key, (7, 5), dtype=jnp.float64))
    got = pgp.posterior_samples_f(Xq, size=5, normals=normals)
    assert got.shape == (7, 1, 5)
    assert_allclose(got, want, rtol=0, atol=1e-9)


def test_posterior_samples_statistics_and_correlation():
    pgp, _ = _twins(n=20)
    Xq = np.linspace(-3, 3, 7)[:, None]
    draws = pgp.posterior_samples_f(
        Xq, size=4000, generator=torch.Generator().manual_seed(1))
    mu, var = pgp.predict_f64(Xq)
    assert_allclose(draws[:, 0, :].mean(axis=1), mu,
                    atol=4 * np.sqrt(var.max() / 4000) + 0.02)
    assert_allclose(draws[:, 0, :].var(axis=1), var, rtol=0.15, atol=1e-4)
    # the same generator state draws the same samples
    again = pgp.posterior_samples_f(
        Xq, size=4000, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(draws, again)
    far = pgp.posterior_samples_f(np.array([[5.0], [5.01]]), size=2000)
    assert np.corrcoef(far[0, 0], far[1, 0])[0, 1] > 0.98


def test_refit_rebuilds_factor_and_mirror():
    pgp, jgp = _twins()
    rng = np.random.default_rng(9)
    for _ in range(5):
        x = rng.uniform(-3, 3, size=1)
        pgp.append_data(x, float(np.sin(x[0])))
        jgp.append_data(x, float(np.sin(x[0])))
    before = pgp.state.L.clone()
    pgp.refit()
    jgp.refit()
    assert_allclose(pgp._host.L, np.asarray(jgp._host.L), rtol=0,
                    atol=1e-12)
    assert_allclose(pgp.state.L.numpy(), before.numpy(), rtol=0, atol=1e-10)
    assert pgp.num_data == 20


def test_active_dims_subset_factors_the_sliced_kernel():
    """A leaf on a subset of the columns (RBF(1) on column 0 of 2-D data)
    factors its own gram on the host: the port's host factor equals a
    SciPy factorization of k(x_0, z_0). safeopt_tpu's native host engine
    (when it is built) grams every column here (ROADMAP Queue 3)."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, size=(6, 2))
    Y = np.cos(X[:, :1])
    gp = pt.GPRegression(X, Y, pt.RBF(1, variance=2.0), noise_var=1e-3,
                         device="cpu")
    gp.append_data(np.array([0.4, 1.7]), 0.2)
    Xa = np.vstack([X, [[0.4, 1.7]]])[:, :1]
    K = 2.0 * np.exp(-0.5 * (Xa - Xa.T) ** 2) + 1e-3 * np.eye(7)
    assert_allclose(gp._host.L[:7, :7], np.linalg.cholesky(K), rtol=0,
                    atol=1e-12)

"""The port's hyperparameter fitting against safeopt_tpu's, float64 on the CPU.

Mirrors ``tests/test_hyperopt.py`` (but for ``test_accel_restarts_refused``:
the port runs ``device='accel'`` with restarts on the card, which
``tests/test_torch_cuda.py`` checks). The exact and sparse LMLs equal
safeopt_tpu's to 1e-10 relative, and their gradients through the kernel
leaves (``kernel_leaves``, the JAX pytree's order) and through ``Z``
equal ``jax.grad``'s to 1e-8, for every kernel family. Adam alone
(``polish=False``) takes the same steps as optax's Adam: the fitted
parameters and LML agree to 1e-8 relative after 40 steps (float64 on
both sides; the gradients agree to round-off and these surfaces do not
amplify it). Restarts given safeopt_tpu's perturbations (its threefry
draws, passed as ``draws``) run the same starts and pick the same best
run. The BFGS polish differs by design (scipy's BFGS, not
``jax.scipy.optimize``), so a polished fit is held to its properties.
Sizes stay small (n <= 60, Adam steps <= 50).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.gp import hyperopt as phyp
from safeopt_tpu.gp import hyperopt as jhyp

RNG = np.random.default_rng(9)


def _data(lengthscale=1.5, variance=2.0, noise=0.05, n=40, rng=RNG):
    X = np.sort(rng.uniform(-5, 5, size=(n, 1)), axis=0)
    K = variance * np.exp(-0.5 * ((X - X.T) / lengthscale) ** 2)
    L = np.linalg.cholesky(K + 1e-10 * np.eye(n))
    f = L @ rng.normal(size=n)
    return X, (f + noise * rng.normal(size=n))[:, None]


def _fit(kern, X, Y, noise_var, **kw):
    return phyp.fit_hyperparameters(kern, X, Y, noise_var, device="cpu",
                                    **kw)


# every kernel family of both packages, as (name, maker(pkg), d)
FAMILIES = [
    ("rbf_ard", lambda p: p.RBF(2, variance=1.3, lengthscale=[0.7, 1.4],
                                ARD=True), 2),
    ("matern32", lambda p: p.Matern32(2, variance=0.9, lengthscale=1.1), 2),
    ("matern52", lambda p: p.Matern52(2, variance=1.2, lengthscale=0.8), 2),
    ("exponential", lambda p: p.Exponential(2, variance=1.1,
                                            lengthscale=1.3), 2),
    ("ratquad", lambda p: p.RatQuad(2, variance=1.4, lengthscale=0.9,
                                    power=1.7), 2),
    ("cosine", lambda p: p.Cosine(1, variance=1.4, lengthscale=0.9), 1),
    ("stdperiodic", lambda p: p.StdPeriodic(2, variance=1.1,
                                            period=[2.5, 3.1],
                                            lengthscale=0.8, ARD1=True), 2),
    ("linear", lambda p: p.Linear(2, variances=[0.6, 0.9], ARD=True), 2),
    ("poly", lambda p: p.Poly(1, variance=0.6, scale=0.3, bias=0.8,
                              order=3.0), 1),
    ("mlp", lambda p: p.MLP(1, variance=1.2, weight_variance=0.7,
                            bias_variance=0.5), 1),
    ("rbf_times_matern_plus_bias_white",
     lambda p: (p.RBF(1, active_dims=[0]) * p.Matern32(1, active_dims=[1])
                + p.Bias(2, variance=0.4) + p.White(2, variance=0.05)), 2),
]


def _family_data(d, n=12, seed=12):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, d))
    return X, np.sin(1.3 * X[:, :1]) + 0.1


def _jax_lml_and_grad(jkern, X, Y, noise_var):
    leaves, treedef = jax.tree_util.tree_flatten(jkern)

    def lml(leaves_):
        k = jax.tree_util.tree_unflatten(treedef, leaves_)
        return jhyp.log_marginal_likelihood(k, jnp.asarray(X),
                                            jnp.asarray(Y), noise_var)

    args = [jnp.asarray(v, jnp.float64) for v in leaves]
    return float(lml(args)), [np.asarray(g) for g in jax.grad(lml)(args)]


def _port_lml_and_grad(pkern, X, Y, noise_var):
    leaves = [v.clone().requires_grad_() for v in pt.gp.kernel_leaves(pkern)]
    lml = phyp.log_marginal_likelihood(pt.gp.with_leaves(pkern, leaves),
                                       X, Y, noise_var)
    # a leaf the kernel ignores (Bias's, White's lengthscale) gets 0, as
    # jax.grad gives it
    grads = torch.autograd.grad(lml, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(lml.detach()), [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# the objectives and their gradients
# ---------------------------------------------------------------------------

def test_lml_matches_direct_formula_and_safeopt_tpu():
    X, Y = _data()
    kern = pt.RBF(1, variance=2.0, lengthscale=1.5)
    lml = float(phyp.log_marginal_likelihood(kern, X, Y, 0.05 ** 2))
    K = 2.0 * np.exp(-0.5 * ((X - X.T) / 1.5) ** 2) + 0.05 ** 2 * np.eye(
        len(X))
    _, logdet = np.linalg.slogdet(K)
    expected = (-0.5 * Y[:, 0] @ np.linalg.solve(K, Y[:, 0])
                - 0.5 * logdet - 0.5 * len(X) * np.log(2 * np.pi))
    assert_allclose(lml, expected, rtol=1e-8)
    jlml = float(jhyp.log_marginal_likelihood(
        jt.RBF(1, variance=2.0, lengthscale=1.5), jnp.asarray(X),
        jnp.asarray(Y), 0.05 ** 2))
    assert_allclose(lml, jlml, rtol=1e-10)


@pytest.mark.parametrize("name,make,d", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_lml_and_gradients_match_jax_grad(name, make, d):
    """Every family: the LML to 1e-10 relative, d LML / d leaf to 1e-8
    (relative to the largest gradient of the kernel), in the order of
    the JAX pytree's leaves. Exponential's lengthscale gradient is
    undefined through the gram form (``test_exponential_lengthscale_
    gradient_is_rounding_on_the_diagonal``): its variance gradient is
    held here."""
    X, Y = _family_data(d)
    jl, jg = _jax_lml_and_grad(make(jt), X, Y, 1e-3)
    pl, pg = _port_lml_and_grad(make(pt), X, Y, 1e-3)
    assert_allclose(pl, jl, rtol=1e-10)
    assert len(pg) == len(jg)
    if name == "exponential":
        pg, jg = pg[:1], jg[:1]
    scale = max(np.abs(g).max() for g in jg)
    for i, (a, b) in enumerate(zip(pg, jg)):
        assert a.shape == b.shape, i
        assert_allclose(a, b, rtol=1e-8, atol=1e-8 * scale,
                        err_msg=f"{name} leaf {i}")


def test_leaves_follow_the_jax_pytree_order():
    for _, make, _ in FAMILIES:
        pl = pt.gp.kernel_leaves(make(pt))
        jl = jax.tree_util.tree_leaves(make(jt))
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=0)
    k = make(pt)
    rebuilt = pt.gp.with_leaves(k, [v * 2 for v in pt.gp.kernel_leaves(k)])
    assert type(rebuilt) is type(k)
    assert_allclose(pt.gp.kernel_leaves(rebuilt)[0].numpy(),
                    2 * pt.gp.kernel_leaves(k)[0].numpy())
    assert_allclose(pt.gp.kernel_leaves(k)[0].numpy(), 1.0)  # untouched
    with pytest.raises(ValueError, match="leaves"):
        pt.gp.with_leaves(k, [])


@pytest.mark.parametrize("make", [
    lambda p: p.RBF(2, variance=1.1, lengthscale=[0.6, 1.3], ARD=True),
    lambda p: p.Matern32(2, variance=1.1, lengthscale=0.9),
    lambda p: p.Matern52(2, variance=0.8, lengthscale=[1.2, 0.7], ARD=True)],
    ids=["rbf_ard", "matern32", "matern52_ard"])
def test_gradient_through_repeated_points_matches_jax(make):
    """The gram form clamps r2 at 0, and a repeated point puts a tie
    (r2 exactly 0) off the diagonal too; jnp.maximum passes half the
    gradient at a tie, and so does the port (torch.maximum)."""
    X = np.array([[0.3, -0.2], [0.3, -0.2], [1.0, 0.5], [-0.7, 0.1]])
    Y = np.array([[0.4], [0.41], [0.1], [-0.2]])
    jl, jg = _jax_lml_and_grad(make(jt), X, Y, 1e-2)
    pl, pg = _port_lml_and_grad(make(pt), X, Y, 1e-2)
    assert_allclose(pl, jl, rtol=1e-10)
    for a, b in zip(pg, jg):
        assert_allclose(a, b, rtol=1e-8, atol=1e-10)


def test_exponential_lengthscale_gradient_is_rounding_on_the_diagonal():
    """A reference fault the port keeps (ROADMAP Queue 3): Exponential's
    k = v exp(-sqrt(r2 + 1e-36)) has d k / d r2 = -v / (2e-18) at r2 = 0,
    and the gram form's r2 on the diagonal (|x|^2 + |x|^2 - 2 x.x) has a
    derivative in the lengthscale that is zero only up to rounding: the
    product is rounding times 5e17. On two points both packages' LML
    gradient in the lengthscale is off the central difference (0.116) by
    more than 20, each by its own rounding."""
    X = np.random.default_rng(12).uniform(-2, 2, size=(2, 2))
    Y = np.sin(1.3 * X[:, :1]) + 0.1

    def lml(ls):
        return float(phyp.log_marginal_likelihood(
            pt.Exponential(2, variance=1.1, lengthscale=ls), X, Y, 1e-3))

    fd = (lml(1.3 + 1e-6) - lml(1.3 - 1e-6)) / 2e-6
    _, jg = _jax_lml_and_grad(jt.Exponential(2, variance=1.1,
                                             lengthscale=1.3), X, Y, 1e-3)
    _, pg = _port_lml_and_grad(pt.Exponential(2, variance=1.1,
                                              lengthscale=1.3), X, Y, 1e-3)
    assert_allclose(fd, 0.11638, rtol=1e-3)
    assert abs(float(jg[1]) - fd) > 20.0
    assert abs(float(pg[1]) - fd) > 20.0
    # the variance gradient does not go through r2: it agrees
    assert_allclose(pg[0], jg[0], rtol=1e-10)


def test_sparse_lml_and_gradients_match_jax_grad():
    """The DTC LML and its gradient in the leaves and in Z (the
    inducing-point optimization's gradient)."""
    rng = np.random.default_rng(13)
    X = rng.uniform(-2, 2, size=(25, 1))
    Y = np.sin(X) + 0.05 * rng.normal(size=(25, 1))
    Z = np.linspace(-1.8, 1.8, 5)[:, None]

    def jlml(leaves_, Zv, treedef):
        k = jax.tree_util.tree_unflatten(treedef, leaves_)
        return jhyp.sparse_log_marginal_likelihood(k, X, Y, Zv, 0.01)

    for make in (lambda p: p.RBF(1, variance=1.5, lengthscale=0.8),
                 lambda p: p.Matern52(1, variance=1.2, lengthscale=0.9)):
        leaves, treedef = jax.tree_util.tree_flatten(make(jt))
        args = [jnp.asarray(v, jnp.float64) for v in leaves]
        jv = float(jlml(args, jnp.asarray(Z), treedef))
        jg_leaves, jg_z = jax.grad(jlml, argnums=(0, 1))(
            args, jnp.asarray(Z), treedef)
        pk = make(pt)
        pleaves = [v.clone().requires_grad_()
                   for v in pt.gp.kernel_leaves(pk)]
        Zt = torch.tensor(Z, requires_grad=True)
        pv = phyp.sparse_log_marginal_likelihood(
            pt.gp.with_leaves(pk, pleaves), X, Y, Zt, 0.01)
        grads = torch.autograd.grad(pv, pleaves + [Zt])
        assert_allclose(float(pv.detach()), jv, rtol=1e-10)
        for a, b in zip(grads[:-1], jg_leaves):
            assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-9)
        assert_allclose(grads[-1].numpy(), np.asarray(jg_z), rtol=1e-8,
                        atol=1e-9)


def test_non_positive_definite_gram_gives_nan_not_an_error():
    X = np.array([[0.0], [0.0], [1.0]])
    Y = np.array([[1.0], [1.0], [0.5]])
    lml = phyp.log_marginal_likelihood(pt.RBF(1, variance=1e6), X, Y,
                                       -1.0)
    assert torch.isnan(lml)
    lml = phyp.sparse_log_marginal_likelihood(pt.RBF(1), X, Y,
                                              np.array([[0.0], [0.0]]), -1.0)
    assert torch.isnan(lml)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def test_fit_improves_lml_and_recovers_scale():
    X, Y = _data(lengthscale=1.5, variance=2.0, noise=0.05)
    kern0 = pt.RBF(1, variance=0.3, lengthscale=0.3)
    lml0 = float(phyp.log_marginal_likelihood(kern0, X, Y, 0.3))
    kern, noise, lml = _fit(kern0, X, Y, 0.3, steps=50, learning_rate=0.05)
    assert lml > lml0 + 5.0
    assert 0.5 < float(kern.lengthscale) < 4.0
    assert noise < 0.05
    assert kern.lengthscale.dtype == torch.float64
    assert kern.lengthscale.device.type == "cpu"
    assert not kern.lengthscale.requires_grad
    assert float(kern0.lengthscale) == 0.3             # input untouched


@pytest.mark.parametrize("optimize_noise", [True, False])
def test_adam_fit_matches_safeopt_tpu(optimize_noise):
    """40 Adam steps without the polish: parameters and LML equal the JAX
    fit's to 1e-8 relative (see the module docstring)."""
    X, Y = _data(n=30, rng=np.random.default_rng(3))
    k, nv, lml = _fit(pt.RBF(1, variance=0.5, lengthscale=0.6), X, Y, 0.2,
                      steps=40, polish=False, optimize_noise=optimize_noise)
    jk, jnv, jlml = jhyp.fit_hyperparameters(
        jt.RBF(1, variance=0.5, lengthscale=0.6), X, Y, 0.2, steps=40,
        polish=False, optimize_noise=optimize_noise)
    assert_allclose(float(k.variance), float(jk.variance), rtol=1e-8)
    assert_allclose(float(k.lengthscale), float(jk.lengthscale), rtol=1e-8)
    assert_allclose(nv, jnv, rtol=1e-8)
    assert_allclose(lml, jlml, rtol=1e-8)
    if not optimize_noise:
        assert nv == 0.2


def _jax_draws(params_keys, r, seed):
    """safeopt_tpu's restart draws (unscaled), in the port's order:
    the kernel's leaves, then the noise. ``params_keys`` lists the
    flattened JAX params in their own order ('Z' first when present,
    then the kernel's leaves, then the noise) as (name, shape)."""
    keys = jax.random.split(jax.random.key(seed), len(params_keys))
    draws = {}
    for i, (name, shape) in enumerate(params_keys):
        draws[name] = np.asarray(jax.random.normal(
            keys[i], (r,) + shape, jnp.float64)).reshape(r, -1)
    order = [n for n, _ in params_keys if n != "Z"]
    return torch.tensor(np.concatenate([draws[n] for n in order], axis=1))


def test_restarts_given_jax_draws_pick_the_same_run():
    """The restart test of tests/test_hyperopt.py: from a hopeless start
    with too few steps, a perturbed restart finds the short-lengthscale
    basin; fed safeopt_tpu's draws the port runs the same starts, picks
    the same best run and lands on its parameters."""
    rng = np.random.default_rng(12)
    X = np.sort(rng.uniform(-3, 3, size=(50, 1)), axis=0)
    K = pt.gp.host_math.np_kernel(pt.RBF(1, variance=2.0, lengthscale=0.25),
                                  X) + 1e-4 * np.eye(50)
    Y = np.linalg.cholesky(K) @ rng.normal(size=(50, 1))
    kw = dict(steps=30, restart_scale=3.0, polish=False)
    _, _, lml_single = _fit(pt.RBF(1, variance=1e-3, lengthscale=50.0), X, Y,
                            1.0, **kw)
    draws = _jax_draws([("variance", ()), ("lengthscale", ()),
                        ("noise", ())], 12, 0)
    k_multi, nv, lml_multi = _fit(pt.RBF(1, variance=1e-3, lengthscale=50.0),
                                  X, Y, 1.0, restarts=12, draws=draws, **kw)
    jk, jnv, jlml = jhyp.fit_hyperparameters(
        jt.RBF(1, variance=1e-3, lengthscale=50.0), X, Y, 1.0, restarts=12,
        seed=0, **kw)
    assert lml_multi > lml_single + 20.0
    assert float(k_multi.lengthscale) < 1.0
    assert_allclose(lml_multi, jlml, rtol=1e-8)
    assert_allclose(float(k_multi.lengthscale), float(jk.lengthscale),
                    rtol=1e-7)
    assert_allclose(nv, jnv, rtol=1e-7)


def test_restart_draws_from_a_generator_are_seeded():
    X, Y = _data(n=20, rng=np.random.default_rng(5))
    kw = dict(steps=5, restarts=3, polish=False)
    a = _fit(pt.RBF(1), X, Y, 0.1, seed=4, **kw)
    b = _fit(pt.RBF(1), X, Y, 0.1, seed=4, **kw)
    gen = torch.Generator().manual_seed(4)
    c = _fit(pt.RBF(1), X, Y, 0.1,
             draws=torch.randn((3, 3), generator=gen, dtype=torch.float64),
             **kw)
    assert a[2] == b[2] == c[2]
    assert float(a[0].lengthscale) == float(c[0].lengthscale)


def test_a_failing_restart_leaves_the_others_alone():
    """Restart 1 starts where the gram does not factor (noise 1e-30 on
    repeated points): its LML is non-finite from the first step and it
    freezes, with no effect on run 0, which ends as the unbatched fit."""
    X = np.array([[0.0], [0.0], [0.5], [0.5], [1.5]])
    Y = np.array([[1.0], [1.0], [0.3], [0.3], [-0.5]])
    kw = dict(steps=20, polish=False, noise_floor=0.0)
    k0, nv0, lml0 = _fit(pt.RBF(1, variance=3.0), X, Y, 0.1, **kw)
    draws = torch.zeros((1, 3), dtype=torch.float64)
    draws[0, 2] = (np.log(1e-30) - np.log(0.1))       # the noise, unscaled
    bad = float(phyp.log_marginal_likelihood(pt.RBF(1, variance=3.0), X, Y,
                                             1e-30))
    assert not np.isfinite(bad)
    k1, nv1, lml1 = _fit(pt.RBF(1, variance=3.0), X, Y, 0.1, restarts=1,
                         draws=draws, restart_scale=1.0, **kw)
    assert_allclose(lml1, lml0, rtol=1e-12)
    assert_allclose(float(k1.lengthscale), float(k0.lengthscale), rtol=1e-12)
    assert_allclose(nv1, nv0, rtol=1e-12)


def test_gp_method_updates_model():
    X, Y = _data()
    gp = pt.GPRegression(X, Y, pt.RBF(1, variance=0.5, lengthscale=0.5),
                         noise_var=0.2, device="cpu")
    mu_before, _ = gp.predict_noiseless(X[:5])
    lml = gp.optimize_hyperparameters(steps=50)
    assert np.isfinite(lml)
    assert_allclose(gp.log_likelihood(), lml, rtol=1e-8)
    assert gp._host.kernel is gp.kern
    assert gp._host.noise_var == gp.noise_var
    mu_after, _ = gp.predict_noiseless(X[:5])
    err_before = np.abs(mu_before.numpy() - Y[:5]).mean()
    err_after = np.abs(mu_after.numpy() - Y[:5]).mean()
    assert err_after <= err_before + 1e-6
    fresh = pt.GPRegression(X, Y, gp.kern, noise_var=gp.noise_var,
                            device="cpu")
    assert_allclose(gp.state.Linv.numpy(), fresh.state.Linv.numpy(),
                    rtol=0, atol=1e-12)


def test_fit_ard_and_product():
    X = RNG.uniform(-2, 2, size=(30, 2))
    Y = np.sin(X[:, :1]) + 0.1 * RNG.normal(size=(30, 1))
    k2, noise, lml = _fit(pt.RBF(2, variance=1.0, lengthscale=[1.0, 1.0],
                                 ARD=True), X, Y, 0.1, steps=50)
    assert np.isfinite(lml)
    assert k2.lengthscale.shape == (2,)
    prod = pt.RBF(1, active_dims=[0]) * pt.Matern32(1, active_dims=[1])
    k3, _, lml2 = _fit(prod, X, Y, 0.1, steps=30)
    assert np.isfinite(lml2)
    assert type(k3).__name__ == "Product"
    assert k3.k2.active_dims == (1,)


def test_fit_is_float64_for_a_float32_model():
    """Near-duplicate inputs push kappa(K) past what float32 factors; the
    fit runs in float64 whatever the model's dtype and stays finite."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-1, 1, size=(12, 1))
    X = np.vstack([base, base + 1e-9])
    Y = np.sin(2 * X) + 1e-4 * rng.normal(size=X.shape)
    gp = pt.GPRegression(X, Y, pt.RBF(1), noise_var=1e-6, device="cpu",
                         dtype=torch.float32)
    lml = gp.optimize_hyperparameters(steps=30)
    assert np.isfinite(lml)
    for leaf in pt.gp.kernel_leaves(gp.kern):
        assert leaf.dtype == torch.float64 and torch.isfinite(leaf).all()
    assert np.isfinite(gp.noise_var) and gp.noise_var > 0
    assert gp.state.Linv.dtype == torch.float32


def test_nonfinite_fit_keeps_input_hyperparameters(caplog):
    """A diverged optimization must not corrupt the model."""
    X = np.linspace(-1, 1, 8)[:, None]
    Y = np.sin(X)
    kern_in = pt.RBF(1, variance=2.0, lengthscale=0.7)
    with caplog.at_level(logging.WARNING):
        kern, noise, lml = _fit(kern_in, X, Y, 0.01, steps=50,
                                learning_rate=1e6)
    if any("non-finite" in r.message for r in caplog.records):
        assert kern is kern_in
        assert noise == 0.01
        assert np.isfinite(lml)
    else:
        assert np.isfinite(lml)


def test_all_runs_nonfinite_return_the_inputs(caplog):
    """Every run non-finite (an objective that is NaN everywhere): the
    input kernel, noise and inducing points come back, with what the
    objective gives at them, as safeopt_tpu returns them."""
    X = np.linspace(-1, 1, 6)[:, None]
    Y = np.cos(X)
    Z = np.array([[-0.5], [0.5]])

    def lml_fn(kern, nv, Zv):
        return phyp.sparse_log_marginal_likelihood(kern, X, Y, Zv,
                                                   nv) * torch.nan

    kern_in = pt.RBF(1, variance=1.5, lengthscale=0.7)
    with caplog.at_level(logging.WARNING):
        k, nv, Zo, lml = _fit(kern_in, X, Y, 0.1, steps=3, restarts=2,
                              lml_fn=lml_fn, inducing=Z)
    assert any("non-finite" in r.message for r in caplog.records)
    assert k is kern_in and nv == 0.1 and np.isnan(lml)
    assert_allclose(Zo, Z, rtol=0, atol=0)
    jk, jnv, jZ, jlml = jhyp.fit_hyperparameters(
        jt.RBF(1, variance=1.5, lengthscale=0.7), X, Y, 0.1, steps=3,
        restarts=2, inducing=Z,
        lml_fn=lambda kk, s2, Zv: jhyp.sparse_log_marginal_likelihood(
            kk, X, Y, Zv, s2) * jnp.nan)
    assert jnv == nv and np.isnan(jlml)
    assert_allclose(jZ, Zo, rtol=0, atol=0)


def test_gpy_style_optimize_alias():
    """gp.optimize(max_iters=...) fits and returns the LML; GPy-only
    keywords are accepted and ignored."""
    rng = np.random.default_rng(4)
    X = np.linspace(-3, 3, 30)[:, None]
    K = pt.gp.host_math.np_kernel(pt.RBF(1, variance=2.0, lengthscale=0.5),
                                  X) + 0.01 * np.eye(30)
    Y = np.linalg.cholesky(K) @ rng.normal(size=(30, 1))
    gp = pt.GPRegression(X, Y, pt.RBF(1, variance=1.0, lengthscale=2.0),
                         noise_var=0.01, device="cpu")
    lml0 = gp.log_likelihood()
    lml = gp.optimize(max_iters=30, messages=False, optimizer="lbfgs")
    assert lml > lml0


def test_optimize_restarts_gpy_alias():
    X, Y = _data()
    gp = pt.GPRegression(X, Y, pt.RBF(1, variance=0.5, lengthscale=8.0),
                         noise_var=0.5, device="cpu")
    lml = gp.optimize_restarts(num_restarts=4, max_iters=30,
                               messages=False)
    assert np.isfinite(lml)
    assert torch.isfinite(gp.kern.lengthscale).all()


def test_restarts_preserve_ard_and_product_structure():
    X = RNG.uniform(-2, 2, size=(25, 2))
    Y = np.sin(X[:, :1]) + 0.1 * RNG.normal(size=(25, 1))
    k2, _, lml = _fit(pt.RBF(2, variance=1.0, lengthscale=[1.0, 1.0],
                             ARD=True), X, Y, 0.1, steps=30, restarts=3)
    assert np.isfinite(lml)
    assert k2.lengthscale.shape == (2,)
    prod = pt.RBF(1, active_dims=[0]) * pt.Matern32(1, active_dims=[1])
    k3, _, lml2 = _fit(prod, X, Y, 0.1, steps=30, restarts=3)
    assert np.isfinite(lml2)
    assert type(k3).__name__ == "Product"


def test_bfgs_polish_improves_or_keeps():
    X, Y = _data(lengthscale=1.5, variance=2.0, noise=0.05)
    kern0 = pt.RBF(1, variance=0.3, lengthscale=0.3)
    _, _, lml_raw = _fit(kern0, X, Y, 0.3, steps=40, polish=False)
    k, nv, lml_pol = _fit(kern0, X, Y, 0.3, steps=40, polish=True)
    assert lml_pol >= lml_raw - 1e-9
    assert np.isfinite(float(k.lengthscale))
    assert nv > 0
    assert_allclose(float(phyp.log_marginal_likelihood(k, X, Y, nv)),
                    lml_pol, rtol=1e-10)


def test_inducing_requires_an_objective_with_z():
    X, Y = _data(n=10)
    with pytest.raises(ValueError, match="inducing= requires"):
        _fit(pt.RBF(1), X, Y, 0.1, steps=2, inducing=X[:3])


def test_device_names():
    """'auto' and 'accel' both mean the card (the JAX package's CPU
    routing and accel-with-restarts refusal guard a TPU runtime and are
    not ported); any other name is refused."""
    assert phyp.fit_device("cpu") == torch.device("cpu")
    assert phyp.fit_device("auto") == phyp.fit_device("accel") \
        == torch.device("cuda")
    X = np.random.default_rng(0).uniform(-1, 1, size=(20, 1))
    with pytest.raises(ValueError, match="device"):
        phyp.fit_hyperparameters(pt.RBF(1), X, X ** 2, 0.01, steps=5,
                                 device="gpu")
    gp = pt.GPRegression(X, X ** 2, pt.RBF(1), noise_var=0.01, device="cpu")
    with pytest.raises(ValueError, match="device"):
        gp.optimize_restarts(num_restarts=2, max_iters=2, device="tpu")

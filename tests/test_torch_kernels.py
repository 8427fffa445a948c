"""The port's kernels against the JAX package's, float64 on the CPU.

``K`` and ``Kdiag`` must agree with the JAX kernels to rtol 1e-12 (both
use the ``|x|^2 + |z|^2 - 2 x.z`` form, so only summation order
differs), for the stationary families and for Cosine, Bias, White and
their Product/Sum algebras, and the host mirrors ``np_kernel`` /
``np_kdiag`` with the JAX host mirrors bit for bit (the same NumPy
expressions).
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import safeopt_torch.gp as pgp
import safeopt_tpu.gp as jgp
import torch
from safeopt_torch.gp import host_math as phm
from safeopt_tpu.gp import host_math as jhm

FAMILIES = ["RBF", "Matern32", "Matern52", "Exponential"]
PARAMS = [
    dict(variance=1.7, lengthscale=0.8),
    dict(variance=0.6, lengthscale=[0.5, 1.3, 2.0], ARD=True),
    dict(variance=2.2, lengthscale=1.1, active_dims=[2, 0, 1]),
]


def _pair(family, kw):
    return getattr(pgp, family)(3, **kw), getattr(jgp, family)(3, **kw)


@pytest.mark.parametrize("kw", PARAMS, ids=["scalar", "ard", "dims"])
@pytest.mark.parametrize("family", FAMILIES)
def test_K_and_Kdiag_match_jax(family, kw):
    rng = np.random.default_rng(len(family) + len(kw))
    X = rng.uniform(-2.0, 2.0, size=(17, 3))
    Z = rng.uniform(-2.0, 2.0, size=(23, 3))
    pk, jk = _pair(family, kw)
    t = torch.tensor
    assert_allclose(pk.K(t(X), t(Z)).numpy(), np.asarray(jk.K(X, Z)),
                    rtol=1e-12, atol=1e-14)
    assert_allclose(pk.K(t(X)).numpy(), np.asarray(jk.K(X)), rtol=1e-12,
                    atol=1e-14)
    np.testing.assert_array_equal(pk.Kdiag(t(X)).numpy(),
                                  np.asarray(jk.Kdiag(X)))


@pytest.mark.parametrize("family", FAMILIES)
def test_host_mirror_matches_jax(family):
    rng = np.random.default_rng(7)
    X = rng.uniform(-2.0, 2.0, size=(9, 3))
    Z = rng.uniform(-2.0, 2.0, size=(5, 3))
    pk, jk = _pair(family, PARAMS[1])
    np.testing.assert_array_equal(phm.np_kernel(pk, X, Z),
                                  jhm.np_kernel(jk, X, Z))
    np.testing.assert_array_equal(phm.np_kdiag(pk, X), jhm.np_kdiag(jk, X))


def test_copy_is_independent():
    k = pgp.RBF(2, variance=1.5, lengthscale=[0.5, 2.0], ARD=True)
    c = k.copy()
    c.lengthscale[0] = 9.0
    assert float(k.lengthscale[0]) == 0.5
    assert type(c) is pgp.RBF and c.ARD and c.active_dims == (0, 1)


def test_active_dims_length_checked():
    with pytest.raises(ValueError):
        pgp.RBF(2, active_dims=[0])


def test_host_mirror_rejects_other_kernels():
    with pytest.raises(TypeError):
        phm.np_kernel(object(), np.zeros((1, 1)))


def _algebra(pkg):
    """Kernel algebras over 3 columns, ARD and active_dims included."""
    rbf = pkg.RBF(2, variance=1.3, lengthscale=[0.7, 1.6], ARD=True,
                  active_dims=[2, 0])
    cos = pkg.Cosine(1, variance=0.9, lengthscale=1.4, active_dims=[1])
    return {
        "context": (pkg.RBF(1, variance=2.0, active_dims=[0])
                    * pkg.RBF(1, variance=1.0, lengthscale=2.0,
                              active_dims=[1])),
        "cosine": pkg.Cosine(1, variance=1.7, lengthscale=0.6),
        "bias": pkg.Bias(3, variance=0.4),
        "white": pkg.White(3, variance=0.2),
        "sum_bias": rbf + pkg.Bias(3, variance=0.5),
        "cos_product": cos * pkg.Matern52(1, variance=1.5, active_dims=[2]),
        "nested": (rbf + pkg.White(3, variance=0.1)) * cos
                  + pkg.Exponential(3, variance=0.3, lengthscale=2.0),
    }


@pytest.mark.parametrize("name", sorted(_algebra(pgp)))
def test_algebra_K_and_Kdiag_match_jax(name):
    rng = np.random.default_rng(len(name))
    X = rng.uniform(-2.0, 2.0, size=(17, 3))
    Z = rng.uniform(-2.0, 2.0, size=(23, 3))
    pk, jk = _algebra(pgp)[name], _algebra(jgp)[name]
    cols = 1 if name == "cosine" else 3
    X, Z = X[:, :cols], Z[:, :cols]
    t = torch.tensor
    assert_allclose(pk.K(t(X), t(Z)).numpy(), np.asarray(jk.K(X, Z)),
                    rtol=1e-12, atol=1e-14)
    assert_allclose(pk.K(t(X)).numpy(), np.asarray(jk.K(X)), rtol=1e-12,
                    atol=1e-14)
    assert_allclose(pk.Kdiag(t(X)).numpy(), np.asarray(jk.Kdiag(X)),
                    rtol=1e-15)
    np.testing.assert_array_equal(phm.np_kernel(pk, X, Z),
                                  jhm.np_kernel(jk, X, Z))
    np.testing.assert_array_equal(phm.np_kernel(pk, X),
                                  jhm.np_kernel(jk, X))
    np.testing.assert_array_equal(phm.np_kdiag(pk, X), jhm.np_kdiag(jk, X))
    assert (pk.input_dim, pk.active_dims) == (jk.input_dim, jk.active_dims)


def test_cosine_refuses_two_dims():
    with pytest.raises(ValueError, match="1-D"):
        pgp.Cosine(2)


def test_algebra_copy_is_independent():
    k = _algebra(pgp)["nested"]
    c = k.copy()
    c.k1.k1.k1.lengthscale[0] = 9.0
    c.k2.variance.fill_(5.0)
    assert float(k.k1.k1.k1.lengthscale[0]) == 0.7
    assert float(k.k2.variance) == 0.3
    assert type(c.k1.k1.k2) is pgp.White and float(c.k1.k1.k2.variance) == 0.1

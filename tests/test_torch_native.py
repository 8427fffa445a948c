"""The port's native float64 factor engine (``safeopt_torch.native``,
its own copy of ``csrc/host_factor.cpp``) against SciPy and against
safeopt_tpu's.

Mirrors ``tests/test_native.py``: the native gram against the port's
NumPy gram, the Cholesky and triangular inverse against SciPy, the
refusal of an indefinite matrix, both ``HostFactor`` paths of the port
agreeing. Then the engine's share of the factor (up to
``NATIVE_MAX_ROWS`` rows) and its fallbacks: an append the engine
refuses, at a non-positive pivot or past its 4096-row buffer, takes the
NumPy bordering. Then the port's ``HostFactor`` bit for bit against
safeopt_tpu's, both native, for RBF, Matern32, RatQuad and StdPeriodic;
the leaves the native gram gets wrong or refuses (a column subset, past
64 columns) routed to the port's own gram; the library built into
``build/safeopt_torch/`` from the port's source, atomically, with four
processes building it at once.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import scipy.linalg
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch import native
from safeopt_torch.gp.host_math import (NATIVE_MAX_ROWS, HostFactor,
                                        _native_kind, np_kernel)
from safeopt_tpu import native as jax_native
from safeopt_tpu.gp.host_math import HostFactor as JaxHostFactor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)


def test_the_engine_builds_from_the_ports_source():
    assert native.available()
    so = native.library_path()
    assert so.parent == native._BUILD_DIR
    assert str(so).startswith(os.path.join(REPO, "build", "safeopt_torch"))
    assert native._SRC == native._SRC.parent / "host_factor.cpp"
    assert native._SRC.parent.name == "native"
    assert native._LIB._name == str(so)
    with open(native._SRC) as a, open(os.path.join(REPO, "csrc",
                                                   "host_factor.cpp")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kind,kern", [
    ("rbf", pt.RBF(3, variance=2.0, lengthscale=[0.5, 1.0, 2.0], ARD=True)),
    ("matern32", pt.Matern32(2, variance=1.5, lengthscale=0.7)),
    ("matern52", pt.Matern52(2, variance=2.5, lengthscale=1.3)),
    ("exponential", pt.Exponential(2, variance=1.2, lengthscale=0.9)),
], ids=["rbf", "matern32", "matern52", "exponential"])
def test_gram_matches_numpy(kind, kern):
    d = kern.input_dim
    X = RNG.normal(size=(12, d))
    Z = RNG.normal(size=(7, d))
    out = native.gram(kind, X, Z, kern.lengthscale.numpy(),
                      float(kern.variance))
    assert_allclose(out, np_kernel(kern, X, Z), rtol=1e-13, atol=1e-14)


def test_ratquad_and_stdperiodic_grams_match_numpy():
    X = RNG.uniform(-2, 2, size=(7, 2))
    Z = RNG.uniform(-2, 2, size=(5, 2))
    kern = pt.RatQuad(2, variance=1.7, lengthscale=[0.8, 1.6], power=1.3,
                      ARD=True)
    got = native.gram("ratquad", X, Z, kern.lengthscale.numpy(), 1.7,
                      power=1.3)
    assert_allclose(got, np_kernel(kern, X, Z), rtol=1e-12)
    kern = pt.StdPeriodic(2, variance=2.1, period=[1.5, 2.5],
                          lengthscale=0.7, ARD1=True)
    got = native.gram("stdperiodic", X, Z, kern.lengthscale.numpy(), 2.1,
                      period=kern.period.numpy())
    assert_allclose(got, np_kernel(kern, X, Z), rtol=1e-12)


def test_cholesky_and_inverse_match_scipy():
    n, cap = 20, 32
    A = RNG.normal(size=(n, n))
    K = A @ A.T + n * np.eye(n)
    buf = np.eye(cap)
    buf[:n, :n] = K
    native.cholesky_lower(buf, n)
    L_ref = scipy.linalg.cholesky(K, lower=True)
    assert_allclose(buf[:n, :n], L_ref, rtol=1e-11, atol=1e-12)
    inv = np.eye(cap)
    native.tri_inverse_lower(buf, n, inv)
    assert_allclose(inv[:n, :n],
                    scipy.linalg.solve_triangular(L_ref, np.eye(n),
                                                  lower=True),
                    rtol=1e-10, atol=1e-12)


def test_cholesky_rejects_indefinite():
    buf = np.eye(8)
    buf[0, 0] = -1.0
    with pytest.raises(np.linalg.LinAlgError):
        native.cholesky_lower(buf, 2)


def test_host_factor_native_vs_scipy_paths():
    """The port's HostFactor lifecycle agrees across both engines."""
    kern = pt.RBF(2, variance=2.0, lengthscale=0.8)
    X = RNG.uniform(-2, 2, size=(9, 2))
    Y = RNG.normal(size=(9, 1))
    hf_native = HostFactor(kern, 16, 2, 0.01)
    hf_scipy = HostFactor(kern, 16, 2, 0.01)
    hf_scipy._use_native = False
    assert hf_native._use_native
    hf_native.set_data(X, Y)
    hf_scipy.set_data(X, Y)
    for _ in range(4):
        x, y = RNG.uniform(-2, 2, size=2), float(RNG.normal())
        hf_native.append(x, y)
        hf_scipy.append(x, y)
    for name in ("L", "Linv", "w"):
        assert_allclose(getattr(hf_native, name), getattr(hf_scipy, name),
                        rtol=1e-9, atol=1e-11)
    q = RNG.uniform(-2, 2, size=(5, 2))
    for a, b in zip(hf_native.predict(q), hf_scipy.predict(q)):
        assert_allclose(a, b, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("family,kw", [
    ("RBF", dict(variance=2.0, lengthscale=[0.8, 1.3], ARD=True)),
    ("Matern32", dict(variance=1.5, lengthscale=0.7)),
    ("RatQuad", dict(variance=1.5, power=1.1)),
    ("StdPeriodic", dict(variance=1.5, period=2.0)),
])
def test_host_factor_is_safeopt_tpus_bit_for_bit(family, kw):
    """Both native: the same gram kind, Cholesky, inverse and bordered
    appends give the same bits in L, Linv, w and the float64
    predictions."""
    assert jax_native.available()
    X = RNG.uniform(-2, 2, size=(9, 2))
    Y = RNG.normal(size=(9, 1))
    ours = HostFactor(getattr(pt, family)(2, **kw), 16, 2, 0.01)
    theirs = JaxHostFactor(getattr(jt, family)(2, **kw), 16, 2, 0.01)
    assert ours._kind() is not None
    ours.set_data(X, Y)
    theirs.set_data(X, Y)
    for _ in range(4):
        x, y = RNG.uniform(-2, 2, size=2), float(RNG.normal())
        ours.append(x, y)
        theirs.append(x, y)
    for name in ("L", "Linv", "w", "X", "Y"):
        assert np.array_equal(getattr(ours, name), getattr(theirs, name)), \
            name
    q = RNG.uniform(-2, 2, size=(6, 2))
    for a, b in zip(ours.predict(q), theirs.predict(q)):
        assert np.array_equal(a, b)
    assert np.array_equal(ours.posterior_cov(q), theirs.posterior_cov(q))


def test_the_engine_factors_up_to_native_max_rows():
    """Up to ``NATIVE_MAX_ROWS`` observations the factor is the engine's,
    safeopt_tpu's bits; past it LAPACK's and NumPy's bordering, on the
    same native gram."""
    kern = pt.RBF(2, variance=2.0, lengthscale=0.8)
    n = NATIVE_MAX_ROWS
    X = RNG.uniform(-3, 3, size=(n + 2, 2))
    Y = RNG.normal(size=(n + 2, 1))
    ours = HostFactor(kern, 2 * n, 2, 0.01)
    theirs = JaxHostFactor(jt.RBF(2, variance=2.0, lengthscale=0.8), 2 * n,
                           2, 0.01)
    ours.set_data(X[:n], Y[:n])
    theirs.set_data(X[:n], Y[:n])
    for name in ("L", "Linv", "w"):
        assert np.array_equal(getattr(ours, name), getattr(theirs, name))
    ours.set_data(X[:n + 1], Y[:n + 1])
    K = ours._gram_sym(X[:n + 1]) + 0.01 * np.eye(n + 1)
    assert np.array_equal(ours.L[:n + 1, :n + 1],
                          scipy.linalg.cholesky(K, lower=True))
    # appends past n rows: the NumPy bordering of the engine's factor
    ref = HostFactor(kern, 2 * n, 2, 0.01)
    for hf in (ours, ref):
        hf.set_data(X[:n], Y[:n])
    ref._native_max_rows = 0
    for i in (n, n + 1):
        ours.append(X[i], float(Y[i, 0]))
        ref.append(X[i], float(Y[i, 0]))
    for name in ("L", "Linv", "w"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name))


def test_a_non_positive_pivot_falls_back_to_the_clamped_bordering():
    """The same point twice without noise: the engine refuses the pivot
    of 0, and the append takes the NumPy bordering, which clamps it, as
    the SciPy engine does."""
    kern = pt.RBF(1, variance=1.0, lengthscale=1.0)
    x = np.array([0.25])
    with pytest.raises(np.linalg.LinAlgError):
        native.border_append(np.eye(4), np.eye(4), np.zeros(4), 1,
                             np.ones(1), 1.0, 0.5)
    out = {}
    for engine in ("native", "scipy"):
        hf = HostFactor(kern, 4, 1, 0.0)
        hf._use_native = engine == "native"
        hf.set_data(x[None], np.array([[0.5]]))
        hf.append(x, 0.5)
        out[engine] = hf
        assert hf.count == 2 and hf.L[1, 1] == np.sqrt(1e-300)
    for name in ("L", "Linv", "w", "X", "Y"):
        assert np.array_equal(getattr(out["native"], name),
                              getattr(out["scipy"], name)), name


def test_appends_past_the_engines_buffer_fall_back():
    """The engine borders at most 4096 rows; with the factor forced onto
    it, appends past that take the NumPy bordering and stay exact. The
    points lie 1 apart at a lengthscale of 0.01, so the gram is exactly
    diagonal and each new row is known in closed form."""
    n, var, noise = 4097, 1.5, 0.25
    kern = pt.RBF(1, variance=var, lengthscale=0.01)
    hf = HostFactor(kern, n + 2, 1, noise)
    X = np.arange(n, dtype=np.float64)[:, None]
    hf.set_data(X, np.ones((n, 1)))
    hf._native_max_rows = 10 ** 9
    with pytest.raises(np.linalg.LinAlgError):
        native.border_append(hf.L, hf.Linv, hf.w, n, np.zeros(n),
                             var + noise, 0.5)
    dd = np.sqrt(var + noise)
    for pos, y in ((n, 0.5), (n + 1, -0.75)):
        hf.append(np.array([float(pos)]), y)
        assert hf.count == pos + 1
        assert hf.L[pos, pos] == dd and not hf.L[pos, :pos].any()
        assert hf.Linv[pos, pos] == 1.0 / dd
        assert not hf.Linv[pos, :pos].any()
        assert hf.w[pos] == y / dd
    mu, _ = hf.predict(np.array([[float(n + 1)]]))
    assert_allclose(mu, [var * -0.75 / (var + noise)], rtol=1e-12)


def test_gp_regression_factors_through_the_engine():
    gp = pt.GPRegression(RNG.uniform(-2, 2, size=(6, 2)),
                         RNG.normal(size=(6, 1)), pt.RBF(2), noise_var=0.01,
                         device="cpu")
    assert gp._host._use_native and gp._host._kind() == "rbf"


def test_a_column_subset_leaf_keeps_the_ports_gram():
    """RBF(1) on 2-column data: the engine would gram both columns (the
    JAX package's fault, ROADMAP Queue 3 entry 7); the port's factor is
    the leaf's own, as a model of the first column alone."""
    kern = pt.RBF(1, variance=2.0, lengthscale=0.7, active_dims=[0])
    assert _native_kind(kern, 2) is None
    X = RNG.uniform(-2, 2, size=(8, 2))
    Y = RNG.normal(size=(8, 1))
    sub = HostFactor(kern, 16, 2, 0.01)
    sub.set_data(X, Y)
    alone = HostFactor(pt.RBF(1, variance=2.0, lengthscale=0.7), 16, 1, 0.01)
    alone.set_data(X[:, :1], Y)
    q = RNG.uniform(-2, 2, size=(5, 2))
    for a, b in zip(sub.predict(q), alone.predict(q[:, :1])):
        assert_allclose(a, b, rtol=1e-12, atol=1e-13)


def test_past_64_columns_keeps_the_ports_gram():
    """65 columns, which the engine refuses (Queue 3 entry 4): the port's
    gram takes them, and the factor is the SciPy path's to round-off."""
    d = 65
    kern = pt.RBF(d, variance=1.0, lengthscale=4.0)
    assert _native_kind(kern, d) is None
    with pytest.raises(RuntimeError, match="native gram failed"):
        native.gram("rbf", np.zeros((2, d)), np.zeros((2, d)), 4.0, 1.0)
    X = RNG.uniform(-1, 1, size=(6, d))
    Y = RNG.normal(size=(6, 1))
    hf = HostFactor(kern, 8, d, 0.01)
    hf.set_data(X, Y)
    hf.append(RNG.uniform(-1, 1, size=d), 0.3)
    ref = HostFactor(kern, 8, d, 0.01)
    ref._use_native = False
    ref.set_data(X, Y)
    ref.append(hf.X[6], 0.3)
    assert_allclose(hf.Linv, ref.Linv, rtol=1e-10, atol=1e-12)


def test_concurrent_builds_never_load_a_partial_library():
    """Four processes build the engine into one empty directory at once:
    every one loads a whole library (the build renames a finished
    temporary file into place)."""
    code = ("import sys; from pathlib import Path; "
            "import safeopt_torch.native as n; "
            "n._BUILD_DIR = Path(sys.argv[1]); "
            "print(n.available(), float(n.gram('rbf', [[0.0]], [[1.0]], "
            "1.0, 1.0)[0, 0]))")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen([sys.executable, "-c", code, tmp],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
                 for _ in range(4)]
        outs = [p.communicate(timeout=240) for p in procs]
        left = sorted(os.listdir(tmp))
    for (out, err), p in zip(outs, procs):
        assert p.returncode == 0, err
        ok, value = out.split()
        assert ok == "True" and abs(float(value) - np.exp(-0.5)) < 1e-15
    assert len(left) == 1 and left[0].endswith(".so")

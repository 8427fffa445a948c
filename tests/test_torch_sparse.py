"""The port's sparse (DTC) GP against safeopt_tpu's, float64 on the CPU.

Mirrors ``tests/test_sparse.py`` (all but its checkpoint cases and its
SafeOptSwarm case, whose modules have no port yet). Both packages build
the DTC state with the same host float64 NumPy/SciPy code, so their
pseudo-factor, weights, device state and ``predict_f64`` agree to 1e-10
(bit for bit on these inputs); where a case needs the JAX model's very
operands, ``convert.sparse_from_arrays`` carries them. The DTC LML is
compared at a well-conditioned ``K_ZZ`` (inducing points at least a
lengthscale apart): there the two packages' Choleskys agree to 1e-10
relative; a near-singular ``K_ZZ`` amplifies round-off in its entries by
its condition number, in either package. ``SafeOpt`` on a sparse model
takes the same steps as safeopt_tpu's, plain and certified (the device
oracle's ``'sparse'`` kind, ``mu = k^T alpha``). Sizes stay small (n <=
60, m <= 40, Adam steps <= 50).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import safe_opt_core as pcore
from safeopt_torch.convert import sparse_arrays, sparse_from_arrays
from safeopt_torch.gp import regression as preg
from safeopt_torch.gp.hyperopt import sparse_log_marginal_likelihood
from safeopt_torch.ops import fused_posterior as fp
from safeopt_tpu.gp.sparse import SparseGPRegression as JSparse

from reference_impl import RefRBF

TIGHT = dict(rtol=0, atol=1e-10)


def _data(n=60, seed=13):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, size=(n, 1))
    y = np.sin(X[:, 0]) + 0.05 * rng.normal(size=n)
    return X, y[:, None]


def _twins(X, Y, kern, **kw):
    """The same sparse model in both packages: (port, safeopt_tpu)."""
    return (pt.SparseGPRegression(X, Y, kern(pt), device="cpu", **kw),
            JSparse(X, Y, kern(jt), **kw))


def _rbf1(pkg, variance=2.0, lengthscale=1.0):
    return pkg.RBF(1, variance=variance, lengthscale=lengthscale)


def _models2d(n=60, m=10, c=1.0, seed=3, calibration="max"):
    """The floor's configuration at a CPU size: 2-D data, a bump."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, size=(n, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=n))[:, None]

    def kern(pkg):
        return pkg.RBF(2, variance=2.0, lengthscale=1.0)

    plain = pt.SparseGPRegression(X, Y, kern(pt), noise_var=0.05 ** 2,
                                  inducing=m, device="cpu")
    cons = pt.SparseGPRegression(X, Y, kern(pt), noise_var=0.05 ** 2,
                                 inducing=m, conservative=c,
                                 calibration=calibration, device="cpu")
    return X, Y, kern, plain, cons


# ---------------------------------------------------------------------------
# the DTC posterior
# ---------------------------------------------------------------------------

def test_dtc_matches_dense_formula_and_safeopt_tpu():
    X, Y = _data(40)
    s2 = 0.01
    gp, jgp = _twins(X, Y, _rbf1, noise_var=s2, inducing=10)
    Z = gp.Z
    assert_allclose(Z, jgp.Z, rtol=0, atol=0)
    Xq = np.linspace(-4, 4, 15)[:, None]
    rk = RefRBF(1, variance=2.0, lengthscale=1.0)
    Kzz = rk.K(Z) + 1e-8 * np.eye(len(Z))
    Kzx = rk.K(Z, X)
    Kzq = rk.K(Z, Xq)
    A = Kzz + Kzx @ Kzx.T / s2
    alpha = np.linalg.solve(A, Kzx @ Y[:, 0]) / s2
    B = np.linalg.inv(Kzz) - np.linalg.inv(A)
    var_ref = rk.Kdiag(Xq) - np.einsum("mq,mk,kq->q", Kzq, B, Kzq)
    mu, var = gp.predict_noiseless(Xq)
    assert_allclose(mu[:, 0], Kzq.T @ alpha, rtol=1e-7, atol=1e-9)
    assert_allclose(var[:, 0], np.maximum(var_ref, 0), rtol=1e-6, atol=1e-8)
    jmu, jvar = jgp.predict_noiseless(Xq)
    assert_allclose(mu, jmu, **TIGHT)
    assert_allclose(var, jvar, **TIGHT)
    mu_l, var_l = gp.predict(Xq)
    assert_allclose(var_l, var + s2, **TIGHT)
    assert_allclose(mu_l, mu, **TIGHT)


def _state_and_predictions_equal(gp, jgp, Xq):
    st, js = gp.state, jgp.state
    assert st.capacity == js.capacity
    assert int(st.count) == int(js.count) == gp.num_inducing
    for name in ("X", "Y", "L", "Linv", "w", "noise_var"):
        assert_allclose(getattr(st, name).numpy(),
                        np.asarray(getattr(js, name)), err_msg=name, **TIGHT)
    for a, b in zip(gp.predict_f64(Xq), jgp.predict_f64(Xq)):
        assert_allclose(a, b, **TIGHT)


def test_device_state_matches_safeopt_tpu_and_host():
    """The pseudo-factor ``GPState`` (inducing rows, ``L = Linv = R``
    bordered by the identity, ``count = m``, ``capacity =
    _next_capacity(m)``) equals safeopt_tpu's, and ``gp_predict`` on it
    reproduces ``predict_f64`` (tests/test_sparse.py's tolerance)."""
    X, Y = _data(50)
    gp, jgp = _twins(X, Y, _rbf1, noise_var=0.01, inducing=12)
    Xq = np.linspace(-4, 4, 23)[:, None]
    _state_and_predictions_equal(gp, jgp, Xq)
    assert gp.state.capacity == preg._next_capacity(12) == 64
    mu_d, var_d = preg.gp_predict(gp.kern, gp.state, torch.tensor(Xq))
    mu_h, var_h = gp.predict_f64(Xq)
    assert_allclose(mu_d.numpy(), mu_h, rtol=1e-8, atol=1e-10)
    assert_allclose(var_d.numpy(), var_h, rtol=1e-7, atol=1e-9)


def test_whitened_mean_departs_from_alpha_on_an_ill_conditioned_factor():
    """A reference behaviour the port keeps (ROADMAP Queue 3): the device
    state's mean ``V^T w``, with ``w = pinv(R^T, rcond=1e-12) alpha``,
    is not the DTC mean ``k^T alpha`` once K_ZZ is ill-conditioned: 40
    inducing points 0.2 apart on 1-D data (lengthscale 1) part them by
    more than 1e-6 in both packages, by the same amount; the variance
    still agrees. The certified path's oracles use alpha."""
    X, Y = _data(60)
    gp, jgp = _twins(X, Y, _rbf1, noise_var=0.01, inducing=40)
    Xq = np.linspace(-4, 4, 23)[:, None]
    _state_and_predictions_equal(gp, jgp, Xq)
    mu_d, var_d = preg.gp_predict(gp.kern, gp.state, torch.tensor(Xq))
    mu_h, var_h = gp.predict_f64(Xq)
    jmu_d, _ = jt.gp.regression.gp_predict(jgp.kern, jgp.state,
                                           jnp.asarray(Xq))
    gap = np.abs(mu_d.numpy() - mu_h).max()
    assert 1e-6 < gap < 1e-3
    assert_allclose(np.abs(np.asarray(jmu_d) - mu_h).max(), gap, rtol=1e-3)
    assert_allclose(var_d.numpy(), var_h, rtol=0, atol=1e-10)


def test_device_oracle_state_is_the_sparse_kind():
    X, Y = _data(50)
    gp, jgp = _twins(X, Y, _rbf1, noise_var=0.01, inducing=12)
    ost, kind = gp.device_oracle_state()
    jost, jkind = jgp.device_oracle_state()
    assert kind == jkind == "sparse"
    for name in ("X", "F", "w", "alpha"):
        got = getattr(ost, name)
        assert got.dtype == torch.float64
        assert_allclose(got.numpy(), np.asarray(getattr(jost, name)),
                        err_msg=name, **TIGHT)
    assert int(ost.count) == int(jost.count) == 12
    assert gp.device_oracle_state()[0] is ost          # cached
    gp.append_data(np.array([0.5]), 0.4)
    assert gp.device_oracle_state()[0] is not ost      # rebuilt


def test_carried_state_equals_safeopt_tpu():
    """``sparse_from_arrays`` holds the JAX model's host state as it is:
    device state, oracle state and host predictions equal, floor too."""
    X, Y, kern, _, _ = _models2d()
    jgp = JSparse(X, Y, kern(jt), noise_var=0.05 ** 2, inducing=10,
                  conservative=0.75, calibration=0.99)
    gp = sparse_from_arrays(kern(pt), **sparse_arrays(jgp), device="cpu")
    assert gp._floor == jgp._floor > 0.0
    assert isinstance(gp.kern, pt.Sum)
    for name in ("X", "L", "Linv", "w"):
        assert_allclose(getattr(gp.state, name).numpy(),
                        np.asarray(getattr(jgp.state, name)), err_msg=name,
                        rtol=0, atol=0)
    Xq = np.random.default_rng(4).uniform(-5, 5, size=(30, 2))
    for a, b in zip(gp.predict_f64(Xq), jgp.predict_f64(Xq)):
        assert_allclose(a, b, **TIGHT)
    round_trip = sparse_arrays(gp)
    for name, value in sparse_arrays(jgp).items():
        if isinstance(value, np.ndarray):
            assert_allclose(round_trip[name], value, rtol=0, atol=0,
                            err_msg=name)
        else:
            assert round_trip[name] == value, name


def test_carry_checks_shapes():
    X, Y = _data(30)
    jgp = JSparse(X, Y, jt.RBF(1), noise_var=0.01, inducing=6)
    arrays = sparse_arrays(jgp)
    arrays["R"] = arrays["R"][:5]
    with pytest.raises(ValueError, match="R has shape"):
        sparse_from_arrays(pt.RBF(1), **arrays, device="cpu")


def test_inducing_equals_data_recovers_exact_gp():
    """With Z = X the DTC posterior is the exact GP posterior."""
    X, Y = _data(20)
    sparse = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=0.01,
                                   inducing=X, device="cpu")
    exact = pt.GPRegression(X, Y, _rbf1(pt), noise_var=0.01, device="cpu")
    Xq = np.linspace(-4, 4, 17)[:, None]
    mu_s, var_s = sparse.predict_noiseless(Xq)
    mu_e, var_e = exact.predict_noiseless(Xq)
    assert_allclose(mu_s, mu_e.numpy(), rtol=1e-5, atol=1e-7)
    assert_allclose(var_s, var_e.numpy(), rtol=1e-4, atol=1e-6)


def test_inducing_count_tops_up_with_jittered_copies():
    X, Y = _data(5)
    gp, jgp = _twins(X, Y, _rbf1, noise_var=0.01, inducing=9)
    assert gp.Z.shape == (9, 1)
    assert_allclose(gp.Z, jgp.Z, rtol=0, atol=0)
    assert gp.num_inducing == 9 and gp.num_data == 5


# ---------------------------------------------------------------------------
# incremental updates
# ---------------------------------------------------------------------------

def test_incremental_append_matches_full_rebuild_and_safeopt_tpu():
    X, Y = _data(40)
    inc, jinc = _twins(X, Y, _rbf1, noise_var=0.01, inducing=10)
    rng = np.random.default_rng(5)
    for _ in range(12):
        x = rng.uniform(-4, 4, size=(1,))
        y = float(np.sin(x[0]) + 0.05 * rng.normal())
        inc.append_data(x, y)
        jinc.append_data(x, y)
    full = pt.SparseGPRegression(inc.X, inc.Y, _rbf1(pt), noise_var=0.01,
                                 inducing=inc.Z, device="cpu")
    Xq = np.linspace(-4, 4, 21)[:, None]
    mu_i, var_i = inc.predict_noiseless(Xq)
    mu_f, var_f = full.predict_noiseless(Xq)
    assert_allclose(mu_i, mu_f, rtol=1e-9, atol=1e-11)
    assert_allclose(var_i, var_f, rtol=1e-8, atol=1e-10)
    assert_allclose(inc.state.Linv.numpy(), np.asarray(jinc.state.Linv),
                    **TIGHT)
    assert_allclose(mu_i, jinc.predict_noiseless(Xq)[0], **TIGHT)


def test_incremental_pop_matches_full_rebuild():
    X, Y = _data(30)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=0.01, inducing=8,
                               device="cpu")
    Xq = np.linspace(-4, 4, 11)[:, None]
    mu0, var0 = gp.predict_noiseless(Xq)
    gp.append_data(np.array([1.2]), 0.9)
    gp.append_data(np.array([-2.1]), -0.8)
    gp.pop_data()
    gp.pop_data()
    mu1, var1 = gp.predict_noiseless(Xq)
    assert_allclose(mu1, mu0, rtol=1e-9, atol=1e-11)
    assert_allclose(var1, var0, rtol=1e-8, atol=1e-10)
    assert gp.num_data == 30


def test_set_XY_incremental_paths():
    """A pure append and a pure truncation ride the rank-1 path, a
    replacement rebuilds: all agree with a model built from scratch."""
    X, Y = _data(25)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=0.01, inducing=8,
                               device="cpu")
    Z = gp.Z
    rng = np.random.default_rng(11)
    X2 = np.vstack([X, rng.uniform(-4, 4, size=(5, 1))])
    Y2 = np.vstack([Y, rng.normal(size=(5, 1))])
    gp.set_XY(X2, Y2)
    assert gp.num_data == 30 and gp._pending == 5
    gp.set_XY(X2[:27], Y2[:27])
    assert gp.num_data == 27 and gp._pending == 8
    ref = pt.SparseGPRegression(X2[:27], Y2[:27], _rbf1(pt), noise_var=0.01,
                                inducing=Z, device="cpu")
    Xq = np.linspace(-4, 4, 13)[:, None]
    assert_allclose(gp.predict_noiseless(Xq)[0],
                    ref.predict_noiseless(Xq)[0], rtol=1e-9, atol=1e-11)
    Xr, Yr = _data(18, seed=21)
    gp.set_XY(Xr, Yr)
    assert gp._pending == 0
    ref2 = pt.SparseGPRegression(Xr, Yr, _rbf1(pt), noise_var=0.01,
                                 inducing=Z, device="cpu")
    assert_allclose(gp.predict_noiseless(Xq)[0],
                    ref2.predict_noiseless(Xq)[0], rtol=1e-9, atol=1e-11)


def test_refit_every_triggers_full_rebuild():
    X, Y = _data(10)
    gp, jgp = _twins(X, Y, _rbf1, noise_var=0.01, inducing=6, refit_every=3)
    rng = np.random.default_rng(2)
    pending = []
    for _ in range(7):
        x, y = rng.uniform(-4, 4, size=(1,)), float(rng.normal())
        gp.append_data(x, y)
        jgp.append_data(x, y)
        pending.append(gp._pending)
        assert gp._pending == jgp._pending
    assert pending == [1, 2, 0, 1, 2, 0, 1]
    assert_allclose(gp._A, jgp._A, **TIGHT)
    assert_allclose(gp.state.w.numpy(), np.asarray(jgp.state.w), **TIGHT)


def test_append_uploads_a_new_state():
    """Each append rebuilds the device state (the (cap, cap) R anew)."""
    X, Y = _data(20)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=0.01, inducing=6,
                               device="cpu", dtype=torch.float32)
    before = gp.state
    gp.append_data(np.array([0.3]), 0.2)
    assert gp.state is not before
    assert gp.state.Linv.dtype == torch.float32
    assert_allclose(gp.state.Linv.numpy()[:6, :6], gp._R.astype(np.float32),
                    rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the pseudo-factor contract
# ---------------------------------------------------------------------------

def test_pseudo_factor_is_lower_triangular():
    """R's strict upper triangle is exactly zero (K1 sums only c <= r),
    and R^T R equals B as ``_recompute_posterior`` forms it."""
    X, Y = _data(60, seed=5)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=0.01, inducing=20,
                               device="cpu")
    m = gp.num_inducing
    R = gp._R
    assert not np.triu(R, 1).any()
    assert not np.triu(gp.state.Linv.numpy(), 1).any()
    sigma = scipy.linalg.cho_solve(
        scipy.linalg.cho_factor(gp._A, lower=True), np.eye(m))
    kzz_inv = scipy.linalg.cho_solve(gp._Kzz_cho, np.eye(m))
    B = 0.5 * ((kzz_inv - sigma) + (kzz_inv - sigma).T)
    evals, evecs = np.linalg.eigh(B)
    B = (evecs * np.maximum(evals, 0.0)) @ evecs.T
    assert_allclose(R.T @ R, B, rtol=1e-8, atol=1e-10 * np.abs(B).max())


def test_k1_plain_matches_safeopt_tpu_past_one_band():
    """m = 40 spans two of K1's 32-row bands (cap 64): the port's K1 plain
    version on the pseudo-factor state equals safeopt_tpu's Pallas
    intervals (interpret mode) and its own posterior, so no band of R is
    dropped (the counterpart of tests/test_sparse.py:261, whose m=160
    spans two of the TPU's 128-row tiles)."""
    from safeopt_tpu.ops.fused_posterior import fused_intervals as jfused

    rng = np.random.default_rng(11)
    n, m = 60, 40
    X = rng.uniform(-4.0, 4.0, size=(n, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=n))[:, None]
    gp = pt.SparseGPRegression(X, Y, pt.RBF(2, variance=2.0),
                               noise_var=0.0025, inducing=m, device="cpu")
    jgp = JSparse(X, Y, jt.RBF(2, variance=2.0), noise_var=0.0025,
                  inducing=m)
    assert int(gp.state.count) == m > 32
    grid = rng.uniform(-5.0, 5.0, size=(256, 2))
    ops = fp.interval_operands([gp.kern], [gp.state], torch.tensor(grid),
                               2.0)
    l, u = fp.fused_intervals(*ops)[0]
    l_p, u_p = jfused(jgp.kern, jgp.state, jnp.asarray(grid), 2.0,
                      block=128)
    assert_allclose(l.numpy(), np.asarray(l_p), rtol=0, atol=1e-9)
    assert_allclose(u.numpy(), np.asarray(u_p), rtol=0, atol=1e-9)
    mu, var = gp.predict_f64(grid)
    assert_allclose(l.numpy(), mu - 2.0 * np.sqrt(var), rtol=0, atol=1e-9)
    # R's rows past the first band carry part of the moments: without
    # them the intervals move (a kernel that dropped them would fail)
    low = ops[3].clone()
    low[0, 32:, :] = 0.0
    l_drop = fp.fused_intervals_plain(*ops[:3], low, *ops[4:])[0, 0]
    assert (l_drop - l).abs().max() > 1e-3


def test_k1_float32_bound_holds_a_sparse_state_and_sees_a_dropped_band():
    """``float32_bound(..., "intervals")`` (K1's float32 arithmetic: V in
    chains of n products, the gram's error, mu = w . V) holds K1's plain
    version run in float32 on the pseudo-factor state, and a dropped
    first band of R lands past it: the float32 check chip_smoke makes
    where the sparse state's float32 decisions cannot hold the band."""
    from safeopt_torch.ops import interval_experiments as ie

    rng = np.random.default_rng(11)
    X = rng.uniform(-4.0, 4.0, size=(60, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=60))[:, None]
    gp = pt.SparseGPRegression(X, Y, pt.RBF(2, variance=2.0),
                               noise_var=0.0025, inducing=40, device="cpu",
                               dtype=torch.float32)
    grid = torch.tensor(rng.uniform(-5.0, 5.0, size=(2000, 2)),
                        dtype=torch.float32)
    ops32 = fp.interval_operands([gp.kern], [gp.state], grid, 2.0)
    up = tuple(o.double() if torch.is_tensor(o) and o.is_floating_point()
               else o for o in ops32)
    want = fp.fused_intervals_plain(*up)
    bound = ie.float32_bound(*ops32, "intervals")
    got = fp.fused_intervals_plain(*ops32).double()
    assert bool(((got - want).abs() <= bound).all())
    fault = fp.fused_intervals_plain(*ie.drop_band(up, "intervals")) - want
    assert (fault.abs() / bound).max().item() > 1.0


def test_factor_scale_warns_once():
    X, Y = _data(60, seed=5)
    with pytest.warns(RuntimeWarning, match="pseudo-factor max entry"):
        gp = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=1e-4,
                                   inducing=30, jitter=1e-9, device="cpu")
    assert np.abs(gp._R).max() > 1e4
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gp.append_data(np.array([0.1]), 0.1)


# ---------------------------------------------------------------------------
# SafeOpt on a sparse model
# ---------------------------------------------------------------------------

def _f(x):
    rk = RefRBF(1, variance=2.0)
    return rk.K(np.atleast_2d(x), [[0.0], [2.0]]) @ np.array([2.0, 1.0])


@pytest.mark.parametrize("mode", ["plain", "certified_host",
                                  "certified_device"])
def test_safeopt_trajectory_equals_safeopt_tpu(mode):
    """Eight steps of ``optimize`` and ``add_new_data_point`` on a sparse
    model: the port's S/M/G and queries equal safeopt_tpu's at every step
    (certified: host oracle, or the device oracle's 'sparse' kind)."""
    X0 = np.array([[0.0], [0.3], [-0.3]])
    Y0 = _f(X0)[:, None]
    gp, jgp = _twins(X0, Y0, _rbf1, noise_var=1e-3, inducing=8)
    grid = pt.linearly_spaced_combinations([(-5.0, 5.0)], 120)
    kw = dict(fmin=[0.0], threshold=0.1)
    if mode == "plain":
        opt, jopt = pt.SafeOpt(gp, grid, **kw), jt.SafeOpt(jgp, grid, **kw)
    else:
        oracle = mode.split("_")[1]
        opt = pt.SafeOpt(gp, grid, exact_boundaries=True,
                         boundary_band=0.05, oracle=oracle, **kw)
        jopt = jt.SafeOpt(jgp, grid, exact_boundaries=True,
                          boundary_band=0.05, oracle=oracle, **kw)
    bands = 0
    for it in range(8):
        x = opt.optimize()
        jx = jopt.optimize()
        for name in ("S", "M", "G"):
            np.testing.assert_array_equal(getattr(opt, name),
                                          np.asarray(getattr(jopt, name)),
                                          err_msg=f"{name} step {it}")
        assert_allclose(opt.Q, np.asarray(jopt.Q), rtol=0, atol=1e-9)
        assert_allclose(x, np.asarray(jx), rtol=0, atol=0)
        if mode != "plain":
            bands += opt.stats.last.band_population
        y = float(_f(x[None, :])[0])
        opt.add_new_data_point(x, y)
        jopt.add_new_data_point(jx, y)
    assert gp.num_data == 11 and gp.num_inducing == 8
    assert opt.stats.last.eager_gps == 0
    if mode != "plain":
        assert bands > 0, "the band was never populated"
    x_best, lb = opt.get_maximum()
    assert np.isfinite(lb)


def test_device_oracle_sparse_kind_settles_as_predict_f64():
    """``device_oracle`` with kind 'sparse' (mu = k^T alpha) gives the
    host oracle's verdicts; the 'exact' formula on the same state would
    read ``V^T w`` with the zero ``w`` of the oracle state."""
    X, Y = _data(40)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt), noise_var=0.01, inducing=10,
                               device="cpu")
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    grid = t(np.linspace(-4, 4, 400)[:, None])
    k = 64
    Q, packed_t = pcore.interval_scan((gp.kern,), (gp.state,), grid,
                                      t([0.5]), 2.0, t([np.sqrt(2.0)]),
                                      2e-2, k=k)
    ost, kind = gp.device_oracle_state()
    fix_idx, fix_bits, flips, n_within = pcore.device_oracle(
        (gp.kern,), (ost,), grid, Q, packed_t, t([0.5]), 2.0,
        constrained=(True,), k=k, kinds=(kind,))
    within = fix_idx.numpy() >= 0
    assert int(n_within) == within.sum() > 0
    mu, var = gp.predict_f64(grid.numpy()[fix_idx.numpy()[within]])
    np.testing.assert_array_equal(fix_bits.numpy()[within],
                                  mu - 2.0 * np.sqrt(var) > 0.5)
    assert int(flips) == 0
    _, wrong, _, _ = pcore.device_oracle(
        (gp.kern,), (ost,), grid, Q, packed_t, t([0.5]), 2.0,
        constrained=(True,), k=k, kinds=("exact",))
    assert not np.array_equal(wrong.numpy()[within],
                              fix_bits.numpy()[within])


# ---------------------------------------------------------------------------
# LML, samples and fitting
# ---------------------------------------------------------------------------

def test_log_likelihood_matches_safeopt_tpu():
    X, Y = _data(60, seed=3)
    Z = np.linspace(-3.5, 3.5, 6)[:, None]
    for kern in (_rbf1, lambda p: p.Matern52(1, variance=1.3,
                                             lengthscale=1.2)):
        gp, jgp = _twins(X, Y, kern, noise_var=0.05, inducing=Z)
        assert_allclose(gp.log_likelihood(), jgp.log_likelihood(),
                        rtol=1e-10)


def test_sparse_lml_matches_dense_lml_when_z_equals_x():
    from safeopt_torch.gp.hyperopt import log_marginal_likelihood

    X, Y = _data(15, seed=8)
    kern = pt.RBF(1, variance=2.0, lengthscale=1.3)
    dense = float(log_marginal_likelihood(kern, X, Y, 0.05))
    sparse = float(sparse_log_marginal_likelihood(kern, X, Y, X, 0.05))
    assert_allclose(sparse, dense, rtol=1e-5)


def test_posterior_samples_match_safeopt_tpu_given_its_normals():
    X, Y = _data(30)
    gp, jgp = _twins(X, Y, _rbf1, noise_var=0.01, inducing=8)
    Xq = np.linspace(-3, 3, 7)[:, None]
    key = jax.random.key(3)
    normals = np.asarray(jax.random.normal(key, (7, 4)), dtype=np.float64)
    got = gp.posterior_samples_f(Xq, size=4, normals=normals)
    want = jgp.posterior_samples_f(Xq, size=4, key=key)
    assert got.shape == (7, 1, 4)
    assert_allclose(got, np.asarray(want), **TIGHT)
    a = gp.posterior_samples_f(Xq, size=3,
                               generator=torch.Generator().manual_seed(5))
    b = gp.posterior_samples_f(Xq, size=3,
                               generator=torch.Generator().manual_seed(5))
    assert_allclose(a, b, rtol=0, atol=0)


def test_sparse_hyperopt_improves_dtc_lml():
    X, Y = _data(60, seed=3)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt, 0.2, 0.2), noise_var=0.3,
                               inducing=12, device="cpu")
    lml0 = gp.log_likelihood()
    lml = gp.optimize_hyperparameters(steps=50)
    assert lml > lml0 + 5.0
    assert 0.3 < float(gp.kern.lengthscale) < 5.0
    assert_allclose(gp.log_likelihood(), lml, rtol=1e-8)
    full = pt.SparseGPRegression(gp.X, gp.Y, gp.kern, noise_var=gp.noise_var,
                                 inducing=gp.Z, device="cpu")
    Xq = np.linspace(-4, 4, 9)[:, None]
    assert_allclose(gp.predict_noiseless(Xq)[0],
                    full.predict_noiseless(Xq)[0], rtol=1e-8, atol=1e-10)


def test_adam_fit_matches_safeopt_tpu():
    """polish=False: the same Adam steps on the same DTC LML. Tolerance
    1e-8 relative on each fitted parameter and the LML (both run float64;
    the gradients agree to round-off, and 40 Adam steps keep it so)."""
    X, Y = _data(60, seed=3)
    Z = np.linspace(-3.5, 3.5, 6)[:, None]
    gp, jgp = _twins(X, Y, lambda p: _rbf1(p, 0.5, 0.6), noise_var=0.2,
                     inducing=Z)
    from safeopt_torch.gp.hyperopt import fit_hyperparameters as pfit
    from safeopt_tpu.gp.hyperopt import fit_hyperparameters as jfit
    from safeopt_tpu.gp.hyperopt import \
        sparse_log_marginal_likelihood as jsparse

    k, nv, lml = pfit(gp.kern_base, X, Y, 0.2, steps=40, polish=False,
                      device="cpu",
                      lml_fn=lambda kk, s2: sparse_log_marginal_likelihood(
                          kk, X, Y, Z, s2))
    with jax.enable_x64(True):
        jk, jnv, jlml = jfit(jgp.kern_base, X, Y, 0.2, steps=40,
                             polish=False,
                             lml_fn=lambda kk, s2: jsparse(kk, X, Y, Z, s2))
    assert_allclose(float(k.variance), float(jk.variance), rtol=1e-8)
    assert_allclose(float(k.lengthscale), float(jk.lengthscale), rtol=1e-8)
    assert_allclose(nv, jnv, rtol=1e-8)
    assert_allclose(lml, jlml, rtol=1e-8)


def test_optimize_inducing_moves_z_to_informative_locations():
    """Joint Z fitting (GPy's sparse optimize()): with m=4 for 1.3
    periods of a sine, moving Z beats the frozen-Z fit, two points land
    near the extrema +-pi/2, and the model is rebuilt at the new Z."""
    X, Y = _data(60, seed=5)
    Z0 = (np.linspace(-3.5, 3.5, 4) + 0.4)[:, None]
    kern = pt.RBF(1, variance=1.5, lengthscale=1.0)
    frozen = pt.SparseGPRegression(X, Y, kern.copy(), noise_var=0.05,
                                   inducing=Z0.copy(), device="cpu")
    lml_frozen = frozen.optimize_hyperparameters(steps=50)
    moved = pt.SparseGPRegression(X, Y, kern.copy(), noise_var=0.05,
                                  inducing=Z0.copy(), device="cpu")
    lml_moved = moved.optimize_hyperparameters(steps=50,
                                               optimize_inducing=True)
    assert lml_moved > lml_frozen + 10.0
    z = np.sort(moved.Z[:, 0])
    assert np.min(np.abs(z - (-np.pi / 2))) < 0.3
    assert np.min(np.abs(z - (np.pi / 2))) < 0.3
    assert_allclose(moved.log_likelihood(), lml_moved, rtol=1e-6)
    assert_allclose(moved.state.X.numpy()[:4], moved.Z, rtol=0, atol=0)


def test_optimize_inducing_restarts_perturb_only_hypers():
    X, Y = _data(50, seed=6)
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt, 0.3, 0.3), noise_var=0.2,
                               inducing=10, device="cpu")
    lml = gp.optimize_hyperparameters(steps=30, restarts=2, seed=1,
                                      optimize_inducing=True)
    assert np.isfinite(lml)
    assert gp.Z.shape == (10, 1)
    mu, var = gp.predict_noiseless(np.linspace(-3, 3, 7)[:, None])
    assert np.all(np.isfinite(mu)) and np.all(var >= 0)


def test_gpy_aliases():
    """``optimize`` moves the inducing points by default, as GPy's sparse
    models do; ``optimize_inducing=False`` keeps them; GPy-only keywords
    are ignored."""
    X, Y = _data(40, seed=2)
    Z0 = np.linspace(-3, 3, 5)[:, None]
    gp = pt.SparseGPRegression(X, Y, _rbf1(pt, 0.5, 0.5), noise_var=0.2,
                               inducing=Z0, device="cpu")
    lml0 = gp.log_likelihood()
    lml = gp.optimize(max_iters=20, messages=False)
    assert lml > lml0 and not np.array_equal(gp.Z, Z0)
    frozen = pt.SparseGPRegression(X, Y, _rbf1(pt, 0.5, 0.5), noise_var=0.2,
                                   inducing=Z0, device="cpu")
    frozen.optimize_restarts(num_restarts=2, max_iters=20,
                             optimize_inducing=False, optimizer="lbfgs")
    assert np.array_equal(frozen.Z, Z0)
    assert np.isfinite(frozen.log_likelihood())


# ---------------------------------------------------------------------------
# the conservative floor
# ---------------------------------------------------------------------------

class TestConservativeFloor:
    """``conservative=c`` adds a calibrated constant latent-variance floor
    (a White summand on ``kern``): the mean is untouched and the lower
    bounds only drop."""

    def test_floor_equals_safeopt_tpu(self):
        for cal in ("max", 0.99):
            X, Y, kern, _, cons = _models2d(calibration=cal)
            jcons = JSparse(X, Y, kern(jt), noise_var=0.05 ** 2,
                            inducing=10, conservative=1.0, calibration=cal)
            assert_allclose(cons._floor, jcons._floor, rtol=1e-12)
            Xq = np.random.default_rng(0).uniform(-5, 5, size=(20, 2))
            assert_allclose(cons.predict_f64(Xq)[1],
                            jcons.predict_f64(Xq)[1], **TIGHT)

    def test_mean_unchanged_var_floored(self):
        X, Y, kern, plain, cons = _models2d()
        Xq = np.random.default_rng(0).uniform(-5, 5, size=(50, 2))
        mu0, v0 = plain.predict_f64(Xq)
        mu1, v1 = cons.predict_f64(Xq)
        assert cons._floor > 0.0
        assert_allclose(mu1, mu0, atol=0)
        assert_allclose(v1, v0 + cons._floor, rtol=1e-12)
        assert isinstance(cons.kern, pt.Sum)
        assert any(isinstance(p, pt.White) for p in cons.kern.parts)
        assert cons.kern_base is not cons.kern

    def test_floored_model_runs_the_eager_route(self):
        """No grid kernel takes White: the floored model's step takes the
        eager route, whose rows equal the host oracle's."""
        _, _, _, plain, cons = _models2d()
        grid = pt.linearly_spaced_combinations([(-3.0, 3.0)] * 2, 25)
        states = (cons.state,)
        assert pcore.eager_gps((cons.kern,), states, 2) == 1
        assert pcore.eager_gps((plain.kern,), (plain.state,), 2) == 0
        mu, var, _ = pcore._eager_posterior(cons.kern, cons.state,
                                            torch.tensor(grid))
        mu_h, var_h = cons.predict_f64(grid)
        assert_allclose(mu.numpy(), mu_h, atol=1e-12)
        assert_allclose(var.numpy(), var_h, atol=1e-12)

    def test_suppresses_optimistic_drift(self):
        """Against the exact GP on a 120 x 120 grid (scipy float64): the
        plain DTC makes optimistic flips on this configuration and c=1
        removes them all (tests/test_sparse.py's n=800, m=64 case at a
        CPU size)."""
        from safeopt_torch.gp.host_math import np_kdiag, np_kernel

        X, Y, kern, plain, cons = _models2d(n=60, m=20, seed=11)
        grid = np.asarray(pt.linearly_spaced_combinations(
            [(-5.0, 5.0), (-5.0, 5.0)], 120))
        beta, fmin, noise = 2.0, 0.2, 0.05 ** 2
        K = np_kernel(kern(pt), X) + noise * np.eye(len(X))
        cho = scipy.linalg.cho_factor(K, lower=True)
        kv = np_kernel(kern(pt), X, grid)
        mu_e = kv.T @ scipy.linalg.cho_solve(cho, Y[:, 0])
        v = scipy.linalg.solve_triangular(cho[0], kv, lower=True)
        var_e = np.maximum(np_kdiag(kern(pt), grid) - np.sum(v * v, axis=0),
                           0.0)
        S_e = (mu_e - beta * np.sqrt(var_e)) > fmin
        mu0, v0 = plain.predict_f64(grid)
        mu1, v1 = cons.predict_f64(grid)
        S0 = (mu0 - beta * np.sqrt(v0)) > fmin
        S1 = (mu1 - beta * np.sqrt(v1)) > fmin
        assert int(np.count_nonzero(S0 & ~S_e)) > 0, \
            "config must exhibit plain-DTC optimistic drift"
        assert int(np.count_nonzero(S1 & ~S_e)) == 0

    def test_lower_bounds_only_drop(self):
        _, _, _, plain, cons = _models2d()
        grid = np.asarray(pt.linearly_spaced_combinations(
            [(-5.0, 5.0), (-5.0, 5.0)], 60))
        mu0, v0 = plain.predict_f64(grid)
        mu1, v1 = cons.predict_f64(grid)
        assert np.all(mu1 - 2.0 * np.sqrt(v1)
                      <= mu0 - 2.0 * np.sqrt(v0) + 1e-12)

    @pytest.mark.parametrize("oracle", ["host", "device"])
    def test_safeopt_certified_on_conservative_model(self, oracle):
        X, Y, kern, _, cons = _models2d()
        jcons = JSparse(X, Y, kern(jt), noise_var=0.05 ** 2, inducing=10,
                        conservative=1.0)
        grid = pt.linearly_spaced_combinations([(-3.0, 3.0)] * 2, 25)
        opt = pt.SafeOpt(cons, grid, fmin=[0.2], exact_boundaries=True,
                         oracle=oracle)
        jopt = jt.SafeOpt(jcons, grid, fmin=[0.2], exact_boundaries=True,
                          oracle=oracle)
        x, jx = opt.optimize(), jopt.optimize()
        assert_allclose(x, np.asarray(jx), rtol=0, atol=0)
        np.testing.assert_array_equal(opt.S, np.asarray(jopt.S))
        assert opt.S.any()
        assert opt.stats.last.eager_gps == 1

    def test_hyperopt_fits_base_kernel(self):
        _, _, _, _, cons = _models2d(m=8)
        floor0 = cons._floor
        lml = cons.optimize_hyperparameters(steps=20)
        assert np.isfinite(lml)
        assert isinstance(cons.kern, pt.Sum)
        assert any(isinstance(p, pt.White) for p in cons.kern.parts)
        assert not isinstance(cons.kern_base, pt.Sum)
        assert cons._floor != floor0              # recalibrated

    def test_quantile_calibration_trims_outlier_floor(self):
        X, Y, kern, _, cons_max = _models2d()
        cons_p99 = pt.SparseGPRegression(X, Y, kern(pt),
                                         noise_var=0.05 ** 2, inducing=10,
                                         conservative=1.0, calibration=0.99,
                                         device="cpu")
        assert 0.0 < cons_p99._floor <= cons_max._floor
        Xq = np.random.default_rng(0).uniform(-5, 5, size=(30, 2))
        mu0, v0 = cons_max.predict_f64(Xq)
        mu1, v1 = cons_p99.predict_f64(Xq)
        assert_allclose(mu1, mu0, atol=0)
        assert_allclose(v1, v0 - cons_max._floor + cons_p99._floor,
                        rtol=1e-10)

    @pytest.mark.parametrize("kw,match", [
        (dict(conservative=1.0, calibration=1.5), "calibration"),
        (dict(conservative=1.0, calibration=0.0), "calibration"),
        (dict(conservative=-0.5), "conservative")])
    def test_validation(self, kw, match):
        X, Y, kern, _, _ = _models2d(n=30, m=6, c=0.0)
        with pytest.raises(ValueError, match=match):
            pt.SparseGPRegression(X, Y, kern(pt), inducing=6, device="cpu",
                                  **kw)
        with pytest.raises(ValueError, match=match):
            JSparse(X, Y, kern(jt), inducing=6, **kw)

    def test_no_floor_when_data_fits_the_inducing_set(self):
        X, Y, kern, _, _ = _models2d(n=10, m=12, c=0.0)
        gp = pt.SparseGPRegression(X, Y, kern(pt), inducing=12,
                                   conservative=1.0, device="cpu")
        assert gp._floor == 0.0 and gp.kern is gp.kern_base

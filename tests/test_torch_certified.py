"""The port's certified path against safeopt_tpu and float64 truth.

Mirrors ``tests/test_certified.py`` for the dense models the port has
(its sparse and checkpoint cases have no port yet). The CPU runs the
kernels' plain versions: the three-pass interval pass in float64 with
``lo`` unrounded, as the JAX package's Pallas kernels compute it in
interpret mode, which is how safeopt_tpu runs here (``use_pallas=True``,
``interval_precision='high'``). Both packages factor the same data in
float64 on the host. At every step the port's S/M/G and query must
equal safeopt_tpu's, and their intervals agree to 1e-9 (the refined
rows included); the knife-edge cases put a threshold 1e-9 from a
point's float64 lower bound, computed independently with scipy, so only
a float64-certified decision gets them right in a float32 run.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from numpy.testing import assert_allclose
from scipy.spatial.distance import cdist

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import safe_opt as psafe
from safeopt_torch.algorithms import safe_opt_core as pcore

from reference_impl import RefGP, RefRBF, RefSafeOpt

HIGH = dict(exact_boundaries=True, interval_precision="high")


def _l64(X, Y, noise_var, beta, xq, kern):
    """Independent scipy float64 posterior lower bound at ``xq`` for a
    kernel ``kern(A, B)``."""
    cho = scipy.linalg.cho_factor(kern(X, X) + noise_var * np.eye(len(X)),
                                  lower=True)
    kv = kern(X, np.atleast_2d(xq))
    mu = kv.T @ scipy.linalg.cho_solve(cho, Y[:, 0])
    v = scipy.linalg.solve_triangular(cho[0], kv, lower=True)
    kdiag = float(kern(np.atleast_2d(xq), np.atleast_2d(xq))[0, 0])
    var = np.maximum(kdiag - np.sum(v * v, axis=0), 0.0)
    return float(mu[0] - beta * np.sqrt(var[0]))


def _rbf(A, B):
    return 2.0 * np.exp(-0.5 * cdist(A, B, "sqeuclidean"))


def _rbf_bias(A, B):
    return _rbf(A, B) + 0.3


def _twins(X, Y, kern, noise_var=1e-4, dtype=torch.float64, **kw):
    """The same model in both packages: (port, safeopt_tpu)."""
    return (pt.GPRegression(X, Y, kern(pt), noise_var=noise_var,
                            device="cpu", dtype=dtype, **kw),
            jt.GPRegression(X, Y, kern(jt), noise_var=noise_var, **kw))


def _one_rbf(pkg):
    return pkg.RBF(1, variance=2.0, lengthscale=1.0)


def _rbf_plus_bias(pkg):
    return (pkg.RBF(1, variance=2.0, lengthscale=1.0)
            + pkg.Bias(1, variance=0.3))


def _assert_same_step(port, jopt, it=""):
    for name in ("S", "M", "G"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(jopt, name)),
                                      err_msg=f"{name} {it}")
    assert port.stats.last.next_index == jopt.stats.last.next_index, it
    assert_allclose(port.Q, np.asarray(jopt.Q), rtol=0, atol=1e-9,
                    err_msg=f"Q {it}")


# -- knife edges --------------------------------------------------------------

class TestKnifeEdge:
    """A threshold 1e-9 above or below the float64 lower bound at one grid
    point, far below any float32 noise: only the float64 oracle decides
    it, in the port's float32 and float64 runs and in safeopt_tpu."""

    def _setup(self, offset, kern_np, kern, dtype, seed=2, **kw):
        rng = np.random.default_rng(seed)
        X = rng.uniform(-1.5, 1.5, size=(10, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        grid = pt.linearly_spaced_combinations([(-3.0, 3.0)], 200)
        j = 150
        fmin = _l64(X, Y, 1e-4, 2.0, grid[j], kern_np) + offset
        pgp, jgp = _twins(X, Y, kern, dtype=dtype)
        opts = (pt.SafeOpt(pgp, grid, fmin=[fmin], beta=2.0,
                           boundary_band=1e-3, **kw),
                jt.SafeOpt(jgp, grid, fmin=[fmin], beta=2.0,
                           boundary_band=1e-3, use_pallas=True, **kw))
        return opts, j

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    @pytest.mark.parametrize("oracle", ["host", "device"])
    def test_decides_by_float64_truth(self, dtype, offset, expect_safe,
                                      oracle):
        (port, jopt), j = self._setup(offset, _rbf, _one_rbf, dtype,
                                      oracle=oracle, **HIGH)
        port.optimize()
        assert bool(port.S[j]) is expect_safe
        if dtype == torch.float64:
            jopt.optimize()
            _assert_same_step(port, jopt)

    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    def test_composite_kernel(self, offset, expect_safe):
        """The oracle through a Sum (RBF + Bias: a plan GP, K2-3p)."""
        (port32, _), j = self._setup(offset, _rbf_bias, _rbf_plus_bias,
                                     torch.float32, seed=3, **HIGH)
        port32.optimize()
        assert bool(port32.S[j]) is expect_safe
        (port, jopt), j = self._setup(offset, _rbf_bias, _rbf_plus_bias,
                                      torch.float64, seed=3, **HIGH)
        port.optimize()
        jopt.optimize()
        assert bool(port.S[j]) is expect_safe
        _assert_same_step(port, jopt)

    def test_plain_float32_run_may_miss_it(self):
        """The same knife edge without certification is decided by the
        float32 intervals alone; the certified run above is the one that
        must match the truth (this pins that the cases are knife edges:
        the float32 margin is far above 1e-9)."""
        (port, _), j = self._setup(1e-9, _rbf, _one_rbf, torch.float32,
                                   exact_boundaries=False)
        port.optimize()
        l32 = float(port.Q[j, 0])
        assert abs(l32 - port.fmin[0]) > 1e-9


# -- certified equals plain ---------------------------------------------------

def _objective(x):
    x = np.atleast_2d(x)
    return _rbf(x, np.array([[0.0], [2.0]])) @ np.array([2.0, 1.0])


def test_certified_matches_plain_and_safeopt_tpu():
    """Float64: certified (host and device oracle, three-pass intervals)
    and plain runs follow the reference trajectory, step for step equal
    to safeopt_tpu's certified run."""
    x0 = np.array([[0.0]])
    y0 = _objective(x0)[:, None]
    grid = pt.linearly_spaced_combinations([(-4.0, 4.0)], 150)
    kw = dict(fmin=[0.0], threshold=0.1)
    plain = pt.SafeOpt(_twins(x0, y0, _one_rbf)[0], grid, **kw)
    certs = [pt.SafeOpt(_twins(x0, y0, _one_rbf)[0], grid, oracle=o,
                        **HIGH, **kw) for o in ("host", "device")]
    jcert = jt.SafeOpt(_twins(x0, y0, _one_rbf)[1], grid, use_pallas=True,
                       **HIGH, **kw)
    ref = RefSafeOpt(RefGP(x0, y0, RefRBF(1, variance=2.0), noise_var=1e-4),
                     grid, **kw)
    for it in range(6):
        xp = np.asarray(plain.optimize())
        xr = np.asarray(ref.optimize())
        assert_allclose(xp, xr, atol=1e-9)
        for cert in certs:
            assert_allclose(np.asarray(cert.optimize()), xr, atol=1e-9)
            for name in ("S", "M", "G"):
                np.testing.assert_array_equal(getattr(cert, name),
                                              getattr(plain, name))
        jcert.optimize()
        _assert_same_step(certs[0], jcert, it)
        y = np.array([[float(_objective(xp)[0])]])
        for opt in (plain, *certs, jcert, ref):
            opt.add_new_data_point(xp, y)


# -- optimistic stepping ------------------------------------------------------

class TestOptimisticStepping:
    """The host-oracle path pays its second pass only when the float64
    oracle overturns a float32 verdict."""

    def _mk(self, fmin, band=1e-3, dtype=torch.float64, **kw):
        rng = np.random.default_rng(7)
        X = rng.uniform(-1.5, 1.5, size=(8, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        grid = pt.linearly_spaced_combinations([(-3.0, 3.0)], 150)
        gp = _twins(X, Y, _one_rbf, dtype=dtype)[0]
        return pt.SafeOpt(gp, grid, fmin=[fmin], beta=2.0,
                          exact_boundaries=True, boundary_band=band,
                          oracle="host", **kw)

    def _spy(self, monkeypatch):
        calls = []
        orig = psafe.safeopt_step_from_Q
        monkeypatch.setattr(psafe, "safeopt_step_from_Q",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        return calls

    def test_empty_band_skips_pass_2(self, monkeypatch):
        calls = self._spy(monkeypatch)
        opt = self._mk(fmin=-50.0)
        opt.optimize()
        assert opt._band_population == 0
        assert opt._certified_corrections == 0
        assert calls == []

    def test_confirmed_band_skips_pass_2(self, monkeypatch):
        calls = self._spy(monkeypatch)
        opt = self._mk(fmin=0.9, band=0.5)
        opt.optimize()
        assert opt._band_population > 0
        assert opt.stats.last.band_population == opt._band_population
        assert opt._certified_corrections == 0
        assert calls == []

    def test_flip_runs_pass_2(self, monkeypatch):
        """A float32 run whose knife-edge verdict the oracle overturns:
        fmin nudged until the float32 lower bound says safe while the
        float64 truth says unsafe."""
        calls = self._spy(monkeypatch)
        rng = np.random.default_rng(2)
        X = rng.uniform(-1.5, 1.5, size=(10, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        grid = pt.linearly_spaced_combinations([(-3.0, 3.0)], 200)
        j = 150
        l64 = _l64(X, Y, 1e-4, 2.0, grid[j], _rbf)
        gp = _twins(X, Y, _one_rbf, dtype=torch.float32)[0]
        probe = pt.SafeOpt(gp, grid, fmin=[0.0], beta=2.0)
        probe.optimize()
        l32 = float(probe.Q[j, 0])
        # a threshold between the float32 and the float64 lower bound
        fmin = min(l32, l64) + abs(l32 - l64) / 2
        opt = pt.SafeOpt(gp, grid, fmin=[fmin], beta=2.0,
                         exact_boundaries=True, oracle="host")
        opt.optimize()
        assert opt._band_population > 0
        assert bool(opt.S[j]) is (l64 > fmin)
        if (l32 > fmin) != (l64 > fmin):
            assert opt._certified_corrections >= 1
            assert calls == [1]


# -- reduced precision: the three-pass interval pass --------------------------

def test_reduced_precision_trajectory_matches_safeopt_tpu():
    """interval_precision='high': the grid pass takes the three-pass
    product and the rows near a boundary are refined; the port and
    safeopt_tpu take identical decisions at every step, their intervals
    agree to 1e-9 on the refined rows and everywhere else, and both
    follow the plain trajectory."""
    rng = np.random.default_rng(2)
    X = rng.uniform(-2.0, 2.0, size=(20, 2))
    Y = (1.0 + np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.01 * rng.normal(size=20))[:, None]
    grid = pt.linearly_spaced_combinations([(-2.0, 2.0)] * 2, 30)

    def kern(pkg):
        return pkg.RBF(2, variance=2.0, lengthscale=1.0)

    # a budget of the whole grid (safeopt_tpu's default clamped to it;
    # the port's default share would take the full pass here)
    kw = dict(fmin=[1.0], threshold=0.05, boundary_band=1e-2,
              refine_k=64, refine_band=2e-2, refine_band_k=900)
    pgp, jgp = _twins(X, Y, kern)
    port = pt.SafeOpt(pgp, grid, **HIGH, **kw)
    jopt = jt.SafeOpt(jgp, grid, use_pallas=True, **HIGH, **kw)
    plain = pt.SafeOpt(_twins(X, Y, kern)[0], grid, fmin=[1.0],
                       threshold=0.05)
    f = lambda x: 1.0 + np.exp(-0.5 * np.sum(np.square(x)))  # noqa: E731
    for it in range(5):
        x = np.asarray(port.optimize())
        jopt.optimize()
        _assert_same_step(port, jopt, it)
        assert_allclose(np.asarray(plain.optimize()), x, atol=1e-12)
        np.testing.assert_array_equal(port.S, plain.S)
        # the refined rows: full precision in both packages
        consts = port._step_consts()
        Q3, _, _ = pcore._confidence_intervals(
            (pgp.kern,), (pgp.state,), port._grid(), 2.0, three_pass=True)
        _, _, idx = pcore._refine_Q(
            (pgp.kern,), (pgp.state,), port._grid(), Q3, consts["fmin"], 2.0,
            consts["scaling"], port._refine_k, port._refine_band_k,
            port._refine_band)
        rows = idx.numpy()
        assert_allclose(port.Q[rows], np.asarray(jopt.Q)[rows], rtol=0,
                        atol=1e-9)
        assert_allclose(port.Q[rows], plain.Q[rows], rtol=0, atol=1e-12)
        y = np.array([[f(x)]])
        for opt in (port, jopt, plain):
            opt.add_new_data_point(x, y)


# -- budgets and validation ---------------------------------------------------

def _small_gp():
    return pt.GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                           pt.RBF(1, variance=2.0), noise_var=1e-4,
                           device="cpu")


class TestBudgetAndValidation:
    def test_band_overflow_warns_and_runs(self, caplog):
        grid = pt.linearly_spaced_combinations([(-2.0, 2.0)], 100)
        opt = pt.SafeOpt(_small_gp(), grid, fmin=[0.0],
                         exact_boundaries=True, boundary_band=100.0,
                         boundary_k=8)
        with caplog.at_level(logging.WARNING):
            x = opt.optimize()
        assert any("triage budget" in r.message for r in caplog.records)
        assert opt.stats.last.band_overflow
        assert np.isfinite(np.asarray(x)).all()

    def test_requires_a_float64_oracle(self):
        class OracleLess:
            def __init__(self, gp):
                self._gp = gp

            def __getattr__(self, name):
                if name in ("predict_f64", "device_oracle_state"):
                    raise AttributeError(name)
                return getattr(self._gp, name)

        grid = pt.linearly_spaced_combinations([(-1.0, 1.0)], 20)
        with pytest.raises(ValueError, match="OracleLess"):
            pt.SafeOpt(OracleLess(_small_gp()), grid, fmin=[0.0],
                       exact_boundaries=True)
        with pytest.raises(ValueError, match="device_oracle_state"):
            pt.SafeOpt(OracleLess(_small_gp()), grid, fmin=[0.0],
                       exact_boundaries=True, oracle="device")

    def test_settings_resolve_as_safeopt_tpu(self, caplog):
        grid = pt.linearly_spaced_combinations([(-2.0, 2.0)], 50)
        jgp = jt.GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                              jt.RBF(1, variance=2.0), noise_var=1e-4)
        for kw in (dict(), dict(interval_precision="high"),
                   dict(exact_boundaries=True, boundary_k=16),
                   dict(interval_precision="high", refine_k=32,
                        refine_band=0.05, refine_band_k=100)):
            opt = pt.SafeOpt(_small_gp(), grid, fmin=[0.0], **kw)
            jopt = jt.SafeOpt(jgp, grid, fmin=[0.0], use_pallas=False, **kw)
            for name in ("_exact_boundaries", "_boundary_k",
                         "_interval_precision", "_refine_k", "_oracle"):
                assert getattr(opt, name) == getattr(jopt, name), (kw, name)
            # the budget's default is the port's own share of the grid
            assert opt._refine_band_k == (
                jopt._refine_band_k if "refine_band_k" in kw
                else int(50 * psafe.REFINE_BAND_SHARE)), kw
        with pytest.raises(ValueError, match="exact_boundaries"):
            pt.SafeOpt(_small_gp(), grid, fmin=[0.0],
                       interval_precision="high", exact_boundaries=False)
        with pytest.raises(ValueError, match="oracle"):
            pt.SafeOpt(_small_gp(), grid, fmin=[0.0], oracle="nonsense")
        with pytest.raises(ValueError, match="interval_precision"):
            pt.SafeOpt(_small_gp(), grid, fmin=[0.0],
                       interval_precision="default")
        with caplog.at_level(logging.WARNING):
            pt.SafeOpt(_small_gp(), grid, fmin=[0.0],
                       interval_precision="high", refine_k=0)
            pt.SafeOpt(_small_gp(), grid, fmin=[0.0],
                       interval_precision="high", refine_band=2e-3)
        text = " ".join(r.message for r in caplog.records)
        assert "refine_k=0" in text and "noise ceiling" in text

    def test_noise_ceiling_is_below_the_default_slack(self):
        """The port's measured three-pass ceiling fits its default bands
        (refine_band minus boundary_band), so the defaults do not warn."""
        assert (psafe._REDUCED_PRECISION_NOISE_CEILING["high"]
                < psafe.REFINE_BAND - 1e-3)

    def test_refinement_past_its_budget_takes_a_full_pass(self):
        """Past the refinement budget no selection holds every row near a
        boundary: the rows are all recomputed at full float32 (no
        ``idx``), and the step decides as the full-precision step."""
        N = 40
        l = np.concatenate([np.linspace(0.0, 0.05, 10),     # near fmin 0
                            np.full(30, 1.0)])               # far, safe
        Q = torch.tensor(np.stack([l, l + 0.5], axis=1))     # equal widths
        grid = torch.linspace(-1.0, 1.0, N, dtype=torch.float64)[:, None]
        gp = _small_gp()
        t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        full, _, _ = pcore._confidence_intervals((gp.kern,), (gp.state,),
                                                 grid, 2.0)
        args = ((gp.kern,), (gp.state,), grid, Q, t([0.0]), 2.0, t([1.0]))
        Qr, pop, idx = pcore._refine_Q(*args, rk=4, band_k=8,
                                       refine_band=0.1)
        assert idx is None and int(pop) == N
        assert torch.equal(Qr, full)
        Qr, pop, idx = pcore._refine_Q(*args, rk=32, band_k=8,
                                       refine_band=0.1)
        assert idx is not None and int(pop) == N     # fits: as JAX
        grid3 = pt.linearly_spaced_combinations([(-2.0, 2.0)], 300)
        opt = pt.SafeOpt(_small_gp(), grid3, fmin=[0.0], refine_k=4,
                         refine_band_k=8, refine_band=10.0, **HIGH)
        plain = pt.SafeOpt(_small_gp(), grid3, fmin=[0.0])
        np.testing.assert_array_equal(opt.optimize(), plain.optimize())
        assert opt.stats.last.refine_full_pass
        np.testing.assert_array_equal(opt.Q, plain.Q)


def test_refinement_past_its_budget_departs_from_safeopt_tpu():
    """The one deliberate difference of the refinement: past its budget
    safeopt_tpu refines the budget's rows and leaves the others of the
    band at the three-pass precision (and flags the overflow), while the
    port recomputes every row at full precision, so its intervals are
    the plain path's everywhere and its decisions the plain step's."""
    grid = pt.linearly_spaced_combinations([(-2.0, 2.0)], 300)
    kw = dict(fmin=[0.0], refine_k=4, refine_band_k=8, refine_band=10.0,
              **HIGH)
    pgp, jgp = _twins(np.array([[0.0]]), np.array([[1.5]]), _one_rbf)
    port = pt.SafeOpt(pgp, grid, **kw)
    jopt = jt.SafeOpt(jgp, grid, use_pallas=True, **kw)
    plain = pt.SafeOpt(_twins(np.array([[0.0]]), np.array([[1.5]]),
                              _one_rbf)[0], grid, fmin=[0.0])
    np.testing.assert_array_equal(port.optimize(), plain.optimize())
    jopt.optimize()
    assert port.stats.last.refine_full_pass and jopt._refine_band_overflow
    np.testing.assert_array_equal(port.Q, plain.Q)
    off = np.abs(np.asarray(jopt.Q) - plain.Q).max(axis=1)
    assert np.count_nonzero(off <= 1e-12) >= 12      # the refined rows
    assert np.count_nonzero(off > 1e-9) > 0           # three-pass rows left


def test_refine_band_must_cover_boundary_band():
    grid = pt.linearly_spaced_combinations([(-2.0, 2.0)], 50)
    with pytest.raises(ValueError, match="refine_band"):
        pt.SafeOpt(_small_gp(), grid, fmin=[0.0], exact_boundaries=True,
                   interval_precision="high", refine_band=1e-4,
                   boundary_band=1e-3)


def test_refine_head_is_safe_masked(monkeypatch):
    """One top-k over max(-margin, head), the head (width, incumbent and
    maximizer scores) over SAFE rows only; the same key as safeopt_tpu's
    ``_refine_Q`` on the same Q."""
    from safeopt_tpu.algorithms import safe_opt_core as jcore

    gp = _small_gp()
    grid = np.linspace(-2.0, 2.0, 16)[:, None]
    l = np.concatenate([np.full(8, -5.0), np.linspace(0.5, 0.9, 8)])
    u = np.concatenate([np.full(8, 5.0), np.linspace(0.6, 1.2, 8)])
    Q = np.stack([l, u], axis=1)

    def spy(module, name, keys):
        orig = getattr(module, name)
        monkeypatch.setattr(module, name, lambda key, k: keys.append(
            np.asarray(key)) or orig(key, k))

    keys, jkeys = [], []
    spy(pcore, "top_k", keys)
    spy(jcore, "partial_top_k", jkeys)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    Qp, pop, idx = pcore._refine_Q((gp.kern,), (gp.state,), t(grid), t(Q),
                                   t([0.0]), 2.0, t([1.0]), rk=4, band_k=4,
                                   refine_band=5e-3)
    jgp = jt.GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                          jt.RBF(1, variance=2.0), noise_var=1e-4)
    Qj, jpop, jidx = jcore._refine_Q(
        (jgp.kern,), (jgp.state,), jnp.asarray(grid), jnp.asarray(Q),
        jnp.asarray([0.0]), jnp.asarray(2.0), jnp.asarray([1.0]),
        jnp.ones(16, bool), rk=4, band_k=4,
        refine_band=jnp.asarray(5e-3))
    key = keys[0]
    np.testing.assert_array_equal(key, jkeys[0])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(pop) == int(jpop)
    assert_allclose(Qp.numpy(), np.asarray(Qj), rtol=0, atol=1e-12)
    margin = np.abs(Q[:, 0])
    np.testing.assert_allclose(key[:8], -margin[:8])
    assert np.all(key[8:] >= -margin[8:] - 1e-12)
    widths = Q[:, 1] - Q[:, 0]
    best_l = Q[8:, 0].max()
    top = set(np.argsort(key)[-4:].tolist())
    assert 8 + int(np.argmax(widths[8:])) in top
    assert 8 + int(np.argmax(Q[8:, 0])) in top
    assert 8 + int(np.argmin(np.abs(Q[8:, 1] - best_l))) in top


# -- the device oracle --------------------------------------------------------

class TestDeviceOracle:
    """oracle='device': the host oracle's float64 factors on the models'
    device, one classification after the verdicts; same decisions as the
    host-oracle path."""

    def _data(self):
        rng = np.random.default_rng(2)
        X = rng.uniform(-2.0, 2.0, size=(60, 2))
        Y = (1.0 + np.exp(-0.5 * np.sum(X ** 2, axis=1))
             + 0.01 * rng.normal(size=60))[:, None]
        return X, Y

    def _gp(self):
        return pt.GPRegression(*self._data(),
                               pt.RBF(2, variance=2.0, lengthscale=1.0),
                               noise_var=1e-4, device="cpu")

    def _grid(self):
        return pt.linearly_spaced_combinations([(-2.0, 2.0)] * 2, 30)

    @pytest.mark.parametrize("precision", [None, "high"])
    def test_matches_host_oracle_path(self, precision):
        opts = [pt.SafeOpt(self._gp(), self._grid(), fmin=[1.0],
                           exact_boundaries=True,
                           interval_precision=precision, oracle=o)
                for o in ("host", "device")]
        jopt = jt.SafeOpt(jt.GPRegression(*self._data(),
                                          jt.RBF(2, variance=2.0),
                                          noise_var=1e-4),
                          self._grid(), fmin=[1.0], exact_boundaries=True,
                          interval_precision=precision, oracle="device",
                          use_pallas=precision is not None)
        xs = [np.asarray(o.optimize()) for o in opts]
        jopt.optimize()
        np.testing.assert_array_equal(xs[1], xs[0])
        for name in ("S", "M", "G"):
            np.testing.assert_array_equal(getattr(opts[1], name),
                                          getattr(opts[0], name))
        assert opts[1]._band_population == opts[0]._band_population > 0
        assert (opts[1]._certified_corrections
                == opts[0]._certified_corrections)
        _assert_same_step(opts[1], jopt)

    def test_oracle_state_mirrors_the_host_factor(self):
        gp = self._gp()
        st, kind = gp.device_oracle_state()
        assert kind == "exact"
        assert st.X.dtype == st.F.dtype == torch.float64
        np.testing.assert_array_equal(st.F.numpy(), gp._host.Linv)
        np.testing.assert_array_equal(st.w.numpy(), gp._host.w)
        gp.append_data(np.array([0.3, -0.2]), 1.4)
        st2, _ = gp.device_oracle_state()
        assert st2 is st                      # one row written in place
        assert int(st2.count) == 61
        np.testing.assert_array_equal(st2.F.numpy(), gp._host.Linv)
        np.testing.assert_array_equal(st2.X.numpy(), gp._host.X)
        np.testing.assert_array_equal(st2.w.numpy(), gp._host.w)
        gp.pop_data()
        np.testing.assert_array_equal(st.F.numpy(), gp._host.Linv)
        assert int(st.count) == 60
        gp.set_XY(*self._data())              # a rebuild ships it anew
        assert gp.device_oracle_state()[0] is not st

    def test_interval_scan_plus_finish_equals_certified_scan(self):
        """interval_scan -> certified_finish with no fixes reproduces
        certified_scan's classification; manufactured flips through
        certified_finish equal a direct safeopt_step_from_Q."""
        gp = self._gp()
        t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        grid = t(self._grid())
        fmin, scaling, threshold = t([1.0]), t([np.sqrt(2.0)]), t([0.0])
        k = 64
        args = ((gp.kern,), (gp.state,), grid, fmin, 2.0, scaling)
        res, packed = pcore.certified_scan(*args, threshold, 1e-3, k=k,
                                           chunk=16)
        Q, packed_t = pcore.interval_scan(*args, 1e-3, k=k)
        assert torch.equal(Q, res.Q)
        assert torch.equal(packed_t, packed[5:5 + 2 + 2 * k])
        idx = packed_t[2:2 + k].numpy()
        within = packed_t[2 + k:].numpy().astype(bool)
        assert within.any()
        none = torch.full((k,), -1, dtype=torch.int32)
        zero = torch.zeros((), dtype=torch.int32)
        out0, diag0 = pcore.certified_finish(
            (gp.kern,), (gp.state,), grid, Q, packed_t, none,
            torch.zeros(k, dtype=torch.bool), zero, zero, fmin, 2.0,
            scaling, threshold, chunk=16)
        for name in ("S", "M", "G", "next_idx"):
            assert torch.equal(getattr(out0, name), getattr(res, name))
        assert diag0.shape == (9,)
        s32 = res.S.numpy()[idx]
        fix_bits = torch.tensor(np.where(within, ~s32, False))
        fix_idx = torch.tensor(np.where(within, idx, -1).astype(np.int32))
        n = torch.tensor(int(within.sum()), dtype=torch.int32)
        out, diag9 = pcore.certified_finish(
            (gp.kern,), (gp.state,), grid, Q, packed_t, fix_idx, fix_bits,
            n, n, fmin, 2.0, scaling, threshold, chunk=16)
        ref = pcore.safeopt_step_from_Q((gp.kern,), (gp.state,), grid, Q,
                                        fix_idx, fix_bits, fmin, 2.0,
                                        scaling, threshold, chunk=16)
        assert torch.equal(out.S, ref.S)
        assert int(out.next_idx) == int(ref.next_idx)
        assert int(diag9[5]) == int(within.sum())

    def test_device_oracle_settles_as_predict_f64(self):
        gp = self._gp()
        t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        grid = t(self._grid())
        k = 64
        Q, packed_t = pcore.interval_scan((gp.kern,), (gp.state,), grid,
                                          t([1.0]), 2.0, t([np.sqrt(2.0)]),
                                          1e-2, k=k)
        fix_idx, fix_bits, flips, n_within = pcore.device_oracle(
            (gp.kern,), (gp.device_oracle_state()[0],), grid, Q, packed_t,
            t([1.0]), 2.0, constrained=(True,), k=k)
        within = fix_idx.numpy() >= 0
        assert int(n_within) == within.sum() > 0
        mu, var = gp.predict_f64(grid.numpy()[fix_idx.numpy()[within]])
        np.testing.assert_array_equal(fix_bits.numpy()[within],
                                      mu - 2.0 * np.sqrt(var) > 1.0)
        assert int(flips) == 0                # float64 run: same verdicts

    def test_boundary_scan_matches_safeopt_tpu(self):
        """Intervals and the triage alone, as the JAX ``boundary_scan``."""
        from safeopt_tpu.algorithms import safe_opt_core as jcore

        X, Y = self._data()
        gp = self._gp()
        jgp = jt.GPRegression(X, Y, jt.RBF(2, variance=2.0), noise_var=1e-4)
        grid = self._grid()
        t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        Q, idx, within, total = pcore.boundary_scan(
            (gp.kern,), (gp.state,), t(grid), t([1.0]), 2.0,
            t([np.sqrt(2.0)]), 1e-2, k=32)
        jQ, jidx, jwithin, jtotal = jcore.boundary_scan(
            (jgp.kern,), (jgp.state,), jnp.asarray(grid), jnp.asarray([1.0]),
            jnp.asarray(2.0), jnp.asarray([np.sqrt(2.0)]),
            jnp.asarray(1e-2), k=32)
        assert_allclose(Q.numpy(), np.asarray(jQ), rtol=0, atol=1e-10)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(within.numpy(), np.asarray(jwithin))
        assert int(total) == int(jtotal) > 0

    def test_auto_resolves_host_on_the_cpu(self):
        opt = pt.SafeOpt(self._gp(), self._grid(), fmin=[1.0],
                         exact_boundaries=True)
        assert opt._oracle == "host"

"""The port's asynchronous steps and lag-1 campaigns, float64 on the CPU.

Mirrors the grid cases of ``tests/test_pipeline.py``: ``optimize_async``
returns the blocking ``optimize()``'s query, its ``result()`` is
idempotent and records the stats when it runs, and
``run_lagged_campaign`` gives bitwise-identical queries and observations
pipelined and serial on the plain path and the certified path with the
device and the host oracle, and the same queries as safeopt_tpu's.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt


def _opt(pkg=pt, kern=None, **kw):
    rng = np.random.default_rng(4)
    X = rng.uniform(-1.5, 1.5, size=(25, 2))
    Y = (1.0 + np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    kern = (kern or (lambda p: p.RBF(2, variance=2.0, lengthscale=1.0)))(pkg)
    where = dict(device="cpu") if pkg is pt else {}
    gp = pkg.GPRegression(X, Y, kern, noise_var=1e-4, **where)
    grid = pt.linearly_spaced_combinations([(-2.0, 2.0), (-2.0, 2.0)], 25)
    if pkg is jt:
        kw = dict(kw, use_pallas=False)
    return pkg.SafeOpt(gp, grid, fmin=[1.0], **kw)


def _plant(x):
    x = np.asarray(x, dtype=float)
    return float(1.0 + np.exp(-0.5 * np.sum(x ** 2)))


MODES = {"plain": dict(),
         "device-oracle": dict(exact_boundaries=True, oracle="device"),
         "host-oracle": dict(exact_boundaries=True, oracle="host"),
         "eager": dict()}


def _kern(mode):
    if mode == "eager":
        return lambda p: p.RBF(2, variance=2.0) + p.White(2, variance=1e-3)
    return None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipelined_matches_serial_bitwise(mode):
    runs = {}
    for pipelined in (False, True):
        opt = _opt(kern=_kern(mode), **MODES[mode])
        runs[pipelined] = (pt.run_lagged_campaign(opt, _plant, n_iter=5,
                                                  pipelined=pipelined), opt)
    (xs_s, ys_s), serial = runs[False]
    (xs_p, ys_p), piped = runs[True]
    np.testing.assert_array_equal(xs_p, xs_s)
    np.testing.assert_array_equal(ys_p, ys_s)
    assert xs_p.shape == (5, 2) and ys_p.shape == (5,)
    # the models hold the same data and factors afterwards
    np.testing.assert_array_equal(piped.gp._host.L, serial.gp._host.L)
    np.testing.assert_array_equal(piped.x, serial.x)
    assert len(piped.stats.history) == len(serial.stats.history) == 5


@pytest.mark.parametrize("mode", ["plain", "device-oracle", "eager"])
def test_lagged_campaign_matches_safeopt_tpu(mode):
    xs, ys = pt.run_lagged_campaign(_opt(kern=_kern(mode), **MODES[mode]),
                                    _plant, n_iter=5)
    xj, yj = jt.run_lagged_campaign(_opt(jt, kern=_kern(mode),
                                         **MODES[mode]), _plant, n_iter=5)
    assert_allclose(xs, xj, atol=1e-12)
    assert_allclose(ys, yj, atol=1e-12)


def test_empty_output_for_zero_iterations():
    xs, ys = pt.run_lagged_campaign(_opt(), _plant, n_iter=0)
    assert xs.shape == (0,) and ys.shape == (0,)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_async_matches_blocking(mode):
    a, b = _opt(kern=_kern(mode), **MODES[mode]), \
        _opt(kern=_kern(mode), **MODES[mode])
    np.testing.assert_array_equal(np.asarray(b.optimize_async().result()),
                                  np.asarray(a.optimize()))
    for name in ("S", "M", "G"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_result_is_idempotent_and_records_stats_once():
    opt = _opt(exact_boundaries=True, oracle="device")
    p = opt.optimize_async(after=object())        # ``after`` is ignored
    n0 = len(opt.stats.history)
    x = p.result()
    assert len(opt.stats.history) == n0 + 1
    assert p.result() is x
    assert len(opt.stats.history) == n0 + 1
    last = opt.stats.last
    assert last.host_syncs >= 1 and last.eager_gps == 0
    # the device oracle's telemetry arrived with the deferred read
    assert last.band_population == opt._band_population


def test_stats_wait_for_result_in_dispatch_order():
    opt = _opt()
    first = opt.optimize_async()
    second = opt.optimize_async()
    assert len(opt.stats.history) == 0
    x1, x2 = first.result(), second.result()
    assert [s.next_index for s in opt.stats.history] == [
        int(np.flatnonzero((opt.inputs == x).all(axis=1))[0])
        for x in (x1, x2)]


def test_empty_safe_set_raises_at_result():
    gp = pt.GPRegression(np.zeros((1, 1)), np.array([[-5.0]]),
                         pt.RBF(1), noise_var=1e-3, device="cpu")
    opt = pt.SafeOpt(gp, np.linspace(-1, 1, 9)[:, None], fmin=[0.0])
    pending = opt.optimize_async()
    with pytest.raises(EnvironmentError, match="no safe points"):
        pending.result()

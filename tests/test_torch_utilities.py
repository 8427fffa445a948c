"""The port's utilities on the CPU in float64: GP-prior sampling, plotting
and ``profile_trace``.

Mirrors ``tests/test_utilities.py``'s sampling and plotting cases with
the port's models (``device='cpu'``). ``sample_gp_function`` cannot
reproduce threefry, so its private entry ``_sample_gp_function`` is fed
the standard normal the JAX function draws (``jax.random.normal`` on the
split key, in float64) and must give safeopt_tpu's values to 1e-12:
both factor the same float64 gram with SciPy and solve the same way;
only the evaluation's summation order differs.
"""

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import safeopt_torch as pt  # noqa: E402
import safeopt_tpu as jt  # noqa: E402
from safeopt_torch.utils import observability  # noqa: E402
from safeopt_torch.utils.sampling import _sample_gp_function  # noqa: E402

CPU = dict(device="cpu")


def _jax_normal(key, n):
    """The float64 standard normal ``safeopt_tpu.sample_gp_function``
    draws from ``key``."""
    _, draw_key = jax.random.split(key)
    with jax.enable_x64(True):
        return np.asarray(jax.random.normal(draw_key, (n,),
                                            dtype=jnp.float64))


@pytest.mark.parametrize("interpolation", ["kernel", "linear"])
@pytest.mark.parametrize("dims", [1, 2])
def test_sampling_matches_safeopt_tpu_on_its_draw(interpolation, dims):
    bounds = [(-2.0, 2.0)] * dims
    num = 15 if dims == 1 else 9
    key = jax.random.key(5)
    n = num ** dims
    mean = lambda x: 0.5 * x[:, :1]                     # noqa: E731
    ref = jt.sample_gp_function(jt.RBF(dims, variance=1.5, lengthscale=0.7),
                                bounds, 0.01, num, interpolation,
                                mean_function=mean, key=key)
    port = _sample_gp_function(pt.RBF(dims, variance=1.5, lengthscale=0.7),
                               bounds, 0.01, num, _jax_normal(key, n),
                               interpolation, mean_function=mean, **CPU)
    x = np.random.default_rng(0).uniform(-1.9, 1.9, size=(23, dims))
    got = port(x, noise=False)
    assert got.dtype == torch.float64 and got.shape == (23, 1)
    assert_allclose(got.numpy(), np.asarray(ref(x, noise=False)),
                    rtol=0, atol=1e-12)


class TestSampleGPFunction:
    def test_kernel_interpolation_passes_through_grid(self):
        f = pt.sample_gp_function(pt.RBF(1, variance=2.0), [(-3.0, 3.0)],
                                  noise_var=0.01, num_samples=30, seed=1,
                                  **CPU)
        xs = np.linspace(-3, 3, 30)[:, None]
        y1, y2 = f(xs, noise=False), f(xs, noise=False)
        assert y1.shape == (30, 1)
        assert torch.equal(y1, y2)             # deterministic without noise
        yn = f(xs, noise=True)
        assert not torch.allclose(yn, y1)
        assert float((yn - y1).abs().max()) < 1.0

    def test_mean_function(self):
        f = pt.sample_gp_function(pt.RBF(1, variance=1e-10), [(-1.0, 1.0)],
                                  noise_var=0.0, num_samples=10,
                                  mean_function=lambda x: 3.0 * x, **CPU)
        assert_allclose(f(np.array([[0.5]]), noise=False).numpy(), [[1.5]],
                        atol=1e-3)

    def test_linear_interpolation(self):
        f = pt.sample_gp_function(pt.RBF(1, variance=2.0), [(-2.0, 2.0)],
                                  noise_var=0.0, num_samples=20,
                                  interpolation="linear", seed=2, **CPU)
        y = f(np.linspace(-2, 2, 7)[:, None], noise=False)
        assert y.shape == (7, 1) and bool(torch.isfinite(y).all())

    def test_smoothness_statistics(self):
        f = pt.sample_gp_function(pt.RBF(1, variance=1.0, lengthscale=1.0),
                                  [(-5.0, 5.0)], noise_var=0.0,
                                  num_samples=100, seed=7, **CPU)
        y = f(np.linspace(-5, 5, 200)[:, None], noise=False)[:, 0].numpy()
        assert np.max(np.abs(np.diff(y))) < 1.0
        assert np.std(y) < 4.0

    def test_bad_interpolation_mode(self):
        with pytest.raises(ValueError):
            pt.sample_gp_function(pt.RBF(1), [(-1, 1)], 0.1, 5,
                                  interpolation="cubic", **CPU)

    def test_sample_covariance_matches_prior(self):
        """Repeated draws' empirical covariance converges to K (+ jitter),
        as ``tests/test_utilities.py`` checks the JAX draw."""
        from scipy.spatial.distance import cdist

        bounds, n_grid, n_draws = [(-2.0, 2.0)], 12, 600
        grid = pt.linearly_spaced_combinations(bounds, n_grid)
        gen = torch.Generator().manual_seed(1000)
        draws = np.stack([
            pt.sample_gp_function(pt.RBF(1, variance=2.0), bounds, 0.0,
                                  n_grid, generator=gen, **CPU)(
                grid, noise=False)[:, 0].numpy()
            for _ in range(n_draws)])
        emp = (draws.T @ draws) / n_draws
        expected = 2.0 * np.exp(-0.5 * cdist(grid, grid, "sqeuclidean"))
        assert np.max(np.abs(emp - expected)) < 0.35
        # the grand mean's standard error from the prior: sqrt(mean(K) /
        # n_draws) (0.045 here); held at four of them
        assert np.abs(np.mean(draws)) < 4 * np.sqrt(expected.mean() / n_draws)

    def test_noise_stream_is_deterministic_per_call_index(self):
        def two_calls():
            f = pt.sample_gp_function(pt.RBF(1), [(-1.0, 1.0)], 0.1, 10,
                                      seed=3, **CPU)
            x = np.zeros((4, 1))
            return f(x), f(x)

        a1, a2 = two_calls()
        b1, b2 = two_calls()
        assert torch.equal(a1, b1) and torch.equal(a2, b2)
        assert not torch.equal(a1, a2)               # the stream advances
        # call i's noise does not depend on the calls before it
        f = pt.sample_gp_function(pt.RBF(1), [(-1.0, 1.0)], 0.1, 10,
                                  seed=3, **CPU)
        f(np.zeros((7, 1)), noise=False)
        assert torch.equal(f(np.zeros((4, 1))), a1)
        # an explicit generator overrides the internal stream
        e1 = f(np.zeros((4, 1)), generator=torch.Generator().manual_seed(9))
        e2 = f(np.zeros((4, 1)), generator=torch.Generator().manual_seed(9))
        assert torch.equal(e1, e2)


class TestPlotting:
    def test_plot_2d_gp(self):
        gp = pt.GPRegression(np.array([[0.0], [1.0]]),
                             np.array([[1.0], [2.0]]), pt.RBF(1),
                             noise_var=0.01, **CPU)
        assert pt.plot_2d_gp(gp, np.linspace(-1, 2, 20)[:, None],
                             fmin=0.0) is not None

    def test_plot_3d_gp(self):
        gp = pt.GPRegression(np.array([[0.0, 0.0], [1.0, 1.0]]),
                             np.array([[1.0], [2.0]]), pt.RBF(2),
                             noise_var=0.01, **CPU)
        grid = pt.linearly_spaced_combinations([(-1, 1), (-1, 1)], 5)
        surf, data = pt.plot_3d_gp(gp, grid)
        assert surf is not None

    def test_plot_contour_gp(self):
        gp = pt.GPRegression(np.array([[0.0, 0.0], [1.0, 1.0]]),
                             np.array([[1.0], [2.0]]), pt.RBF(2),
                             noise_var=0.01, **CPU)
        inputs = [np.linspace(-1, 1, 5), np.linspace(-1, 1, 6)]
        c, cbar, data = pt.plot_contour_gp(gp, inputs)
        assert data is not None

    def test_plot_via_optimizer(self):
        gp = pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                             pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
        grid = pt.linearly_spaced_combinations([(-2.0, 2.0)], 30)
        pt.SafeOpt(gp, grid, fmin=[0.0]).plot(n_samples=20)

    def test_plot_with_contexts(self):
        kern = pt.RBF(1, active_dims=[0]) * pt.RBF(1, active_dims=[1])
        gp = pt.GPRegression(np.array([[0.0, 0.0]]), np.array([[1.0]]),
                             kern, noise_var=0.01, **CPU)
        params = pt.linearly_spaced_combinations([(-1.0, 1.0)], 15)
        opt = pt.SafeOpt(gp, params, fmin=[0.0], num_contexts=1)
        opt.context = 0.25
        assert opt.context_fixed_inputs == [(1, 0.25)]
        opt.plot(n_samples=10)

    def test_plotted_band_is_the_models_posterior(self):
        """The drawn band is the port's posterior: held against the JAX
        model's on the same data."""
        X, Y = np.array([[0.0], [0.8]]), np.array([[1.0], [1.6]])
        inputs = np.linspace(-1, 2, 20)[:, None]
        axis = pt.plot_2d_gp(pt.GPRegression(X, Y, pt.RBF(1), noise_var=0.01,
                                             **CPU), inputs, beta=2)
        mean, var = jt.GPRegression(X, Y, jt.RBF(1),
                                    noise_var=0.01).predict_noiseless(inputs)
        line = axis.get_lines()[0].get_ydata()
        assert_allclose(line, np.asarray(mean)[:, 0], atol=1e-12)


def test_profile_trace_writes_a_trace(tmp_path):
    gp = pt.GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                         pt.RBF(1, variance=2.0), noise_var=0.01, **CPU)
    opt = pt.SafeOpt(gp, pt.linearly_spaced_combinations([(-2., 2.)], 50),
                     fmin=[0.0])
    with observability.profile_trace(str(tmp_path / "trace")) as prof:
        opt.optimize()
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert len(prof.key_averages()) > 0
    with observability.timed() as t:
        pass
    assert t() >= 0.0

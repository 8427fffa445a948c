"""Host-side matplotlib plots of GP posteriors.

Counterpart of ``safeopt_tpu/utils/plotting.py:20-179`` (the reference
utilities.py:146-381): 1-D mean and confidence band, 2-D trisurf and 2-D
contour plots, with ``fixed_inputs`` pinning columns (the context
columns). Predictions come from the port's models
(``predict_noiseless``), pulled to the host once per plot; the data from
their host float64 copies.

Matplotlib is imported when a plot is drawn, not with this module: the
package imports on a host without it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_2d_gp", "plot_3d_gp", "plot_contour_gp"]


def _require_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as exc:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for plotting utilities") from exc


def _host(a) -> np.ndarray:
    """A tensor or array as host float64."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=float)


def _predict(gp, inputs):
    """The latent posterior (mean, var) at ``inputs``, on the host."""
    mean, var = gp.predict_noiseless(inputs)
    return _host(mean), _host(var)


def _gp_arrays(gp):
    """A GP's data on the host."""
    return _host(gp.X_host), _host(gp.Y_host)


def _apply_fixed_inputs(gp, inputs, fixed_inputs, expected_unfixed):
    """Pin fixed input columns; return the list of unfixed dims."""
    if fixed_inputs is None:
        if gp.kern.input_dim > expected_unfixed:
            raise NotImplementedError(
                f"This only works for {expected_unfixed}D inputs")
        fixed_inputs = []
    elif gp.kern.input_dim - len(fixed_inputs) != expected_unfixed:
        raise NotImplementedError(
            f"This only works for {expected_unfixed}D inputs")

    unfixed = list(range(gp.kern.input_dim))
    for dim, value in fixed_inputs:
        if value is not None:
            inputs[:, dim] = value
        unfixed.remove(dim)
    return unfixed


def plot_2d_gp(gp, inputs, predictions=None, figure=None, axis=None,
               fixed_inputs=None, beta=3, fmin=None, **kwargs):
    """1-D input: posterior mean line, beta-sigma band and the data (the
    last point in red), with an optional dashed ``fmin`` line. Returns
    the matplotlib axis."""
    plt = _require_matplotlib()
    inputs = np.array(inputs, dtype=float)

    ms = kwargs.pop("ms", 10)
    mew = kwargs.pop("mew", 3)
    point_color = kwargs.pop("point_color", "k")

    if axis is None:
        figure = figure or plt.figure()
        axis = figure.gca()

    unfixed = _apply_fixed_inputs(gp, inputs, fixed_inputs,
                                  expected_unfixed=1)

    mean, var = (_predict(gp, inputs) if predictions is None
                 else map(_host, predictions))
    mean = mean.squeeze()
    band = beta * np.sqrt(var.squeeze())

    xs = inputs[:, unfixed[0]]
    axis.fill_between(xs, mean - band, mean + band, facecolor="blue",
                      alpha=0.3)
    axis.plot(xs, mean, **kwargs)

    X, Y = _gp_arrays(gp)
    axis.scatter(X[:-1, unfixed[0]], Y[:-1, 0], s=20 * ms, marker="x",
                 linewidths=mew, color=point_color)
    axis.scatter(X[-1, unfixed[0]], Y[-1, 0], s=20 * ms, marker="x",
                 linewidths=mew, color="r")
    axis.set_xlim([xs.min(), xs.max()])

    if fmin is not None:
        axis.plot(xs[[0, -1]], [fmin, fmin], "k--")
    return axis


def plot_3d_gp(gp, inputs, predictions=None, figure=None, axis=None,
               fixed_inputs=None, beta=3, **kwargs):
    """2-D input: posterior mean as a 3-D triangulated surface and the
    data. Returns (surface, data_plot)."""
    plt = _require_matplotlib()
    inputs = np.array(inputs, dtype=float)

    if axis is None:
        figure = figure or plt.figure()
        axis = figure.add_subplot(projection="3d")

    unfixed = _apply_fixed_inputs(gp, inputs, fixed_inputs,
                                  expected_unfixed=2)

    mean = (_predict(gp, inputs) if predictions is None
            else tuple(map(_host, predictions)))[0]

    surf = axis.plot_trisurf(inputs[:, unfixed[0]], inputs[:, unfixed[1]],
                             mean[:, 0], linewidth=0.2, alpha=0.5,
                             **kwargs)

    X, Y = _gp_arrays(gp)
    data = axis.plot(X[:-1, unfixed[0]], X[:-1, unfixed[1]], Y[:-1, 0], "o")
    axis.plot(X[-1, unfixed[0]], X[-1, unfixed[1]], Y[-1, 0], "ro")

    axis.set_xlim([inputs[:, unfixed[0]].min(), inputs[:, unfixed[0]].max()])
    axis.set_ylim([inputs[:, unfixed[1]].min(), inputs[:, unfixed[1]].max()])
    return surf, data


def plot_contour_gp(gp, inputs, predictions=None, figure=None, axis=None,
                    colorbar=True, **kwargs):
    """2-D input: contour plot of the posterior mean. ``inputs`` is a list
    of per-axis arrays (exactly two non-scalar, the rest pinned).
    Returns (contour, colorbar, data_plot)."""
    plt = _require_matplotlib()

    if axis is None:
        figure = figure or plt.figure()
        axis = figure.gca()

    slices = []
    lengths = []
    for i, inp in enumerate(inputs):
        if isinstance(inp, np.ndarray):
            slices.append(i)
            lengths.append(inp.shape[0])

    mesh = np.meshgrid(*inputs, indexing="ij")
    if predictions is None:
        gp_inputs = np.column_stack([m.ravel() for m in mesh])
        mean = _predict(gp, gp_inputs)[0]
    else:
        mean = _host(predictions[0])

    c = c_bar = None
    if not np.all(mean == mean[0]):
        c = axis.contour(mesh[slices[0]].squeeze(),
                         mesh[slices[1]].squeeze(),
                         mean.squeeze().reshape(*lengths), 20, **kwargs)
        if colorbar:
            c_bar = plt.colorbar(c)

    X, _ = _gp_arrays(gp)
    data = axis.plot(X[:-1, slices[0]], X[:-1, slices[1]], "ob")
    axis.plot(X[-1, slices[0]], X[-1, slices[1]], "or")

    axis.set_xlim([np.min(inputs[slices[0]]), np.max(inputs[slices[0]])])
    axis.set_ylim([np.min(inputs[slices[1]]), np.max(inputs[slices[1]])])
    return c, c_bar, data

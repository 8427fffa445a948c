#!/usr/bin/env python3
"""The host float64 numbers behind ROADMAP Queue 3 entries 8-9, on the CPU.

For the sparse model at the JAX bench's long-campaign data (2000
observations, ``states.sparse_data``) with m = 64, 100, 256 inducing
points, and for the 1-D case that pins entry 8 in
``tests/test_torch_sparse.py`` (60 points of sin(x), m=40): K_ZZ's
condition number, the range of the computed ``B = K_ZZ^-1 - Sigma``'s
eigenvalues and how many the tail floors to 0, max |R|, max |R^T w -
alpha| beside max |alpha|, and the largest gap between the state's mean
``V^T w`` and the DTC mean ``k^T alpha`` over a 500 x 500 grid on
[-5, 5]^2 (the 1-D case: 1000 points on [-5, 5]). Then entry 9: the
port's d LML / d lengthscale of Exponential(2, variance 1.1, lengthscale
1.3) on 1, 2 and 12 points of ``default_rng(12)`` in [-2, 2]^2 (noise
1e-3) beside the central difference. One JSON object a line; a few
seconds:

    python3 tools_torch/sparse_conditioning.py
"""

import json
import os
import sys

import numpy as np
import scipy.linalg
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools_torch.states import sparse_data, sparse_gp  # noqa: E402


def conditioning(label, gp, grid):
    """Entry 8's readings of one sparse model over ``grid``."""
    from safeopt_torch.gp.regression import gp_predict

    m = gp.num_inducing
    sigma = scipy.linalg.cho_solve(scipy.linalg.cho_factor(gp._A, lower=True),
                                   np.eye(m))
    B = scipy.linalg.cho_solve(gp._Kzz_cho, np.eye(m)) - sigma
    evals = np.linalg.eigvalsh(0.5 * (B + B.T))
    mu_state = gp_predict(gp.kern, gp.state, torch.tensor(grid))[0].numpy()
    return dict(
        state=label, m=m, cond_Kzz=float(np.linalg.cond(gp._Kzz)),
        B_eig_min=float(evals.min()), B_eig_max=float(evals.max()),
        B_eig_floored=int((evals <= 0.0).sum()),
        max_abs_R=float(np.abs(gp._R).max()),
        max_abs_RTw_minus_alpha=float(np.abs(gp._R.T @ gp._w
                                             - gp._alpha).max()),
        max_abs_alpha=float(np.abs(gp._alpha).max()),
        max_mean_gap=float(np.abs(mu_state - gp.predict_f64(grid)[0]).max()),
        grid_points=int(grid.shape[0]))


def exponential_gradient(n):
    """Entry 9: the port's autograd lengthscale gradient against the
    central difference on ``n`` points."""
    from safeopt_torch import Exponential
    from safeopt_torch.gp import with_leaves
    from safeopt_torch.gp.hyperopt import log_marginal_likelihood

    X = np.random.default_rng(12).uniform(-2, 2, size=(n, 2))
    Y = np.sin(1.3 * X[:, :1]) + 0.1

    def lml(ls):
        return float(log_marginal_likelihood(
            Exponential(2, variance=1.1, lengthscale=ls), X, Y, 1e-3))

    ls = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    kern = with_leaves(Exponential(2, variance=1.1, lengthscale=1.3),
                       [torch.tensor(1.1, dtype=torch.float64), ls])
    (grad,) = torch.autograd.grad(log_marginal_likelihood(kern, X, Y, 1e-3),
                                  [ls])
    return dict(points=n, autograd=float(grad),
                central_difference=(lml(1.3 + 1e-6) - lml(1.3 - 1e-6))
                / 2e-6)


def main():
    """Print entry 8's readings of each state, then entry 9's."""
    from safeopt_torch import RBF, SparseGPRegression, \
        linearly_spaced_combinations

    grid = linearly_spaced_combinations([(-5.0, 5.0)] * 2, 500)
    data = sparse_data()
    for m in (64, 100, 256):
        gp = sparse_gp(m, "cpu", torch.float64, data)
        print(json.dumps(conditioning("bench, 2000 observations", gp, grid)),
              flush=True)
    rng = np.random.default_rng(13)
    X = rng.uniform(-4, 4, size=(60, 1))
    Y = (np.sin(X[:, 0]) + 0.05 * rng.normal(size=60))[:, None]
    gp = SparseGPRegression(X, Y, RBF(1, variance=2.0), noise_var=0.01,
                            inducing=40, device="cpu")
    print(json.dumps(conditioning("1-D sin, 60 points", gp,
                                  np.linspace(-5, 5, 1000)[:, None])),
          flush=True)
    for n in (1, 2, 12):
        print(json.dumps(exponential_gradient(n)), flush=True)


if __name__ == "__main__":
    main()

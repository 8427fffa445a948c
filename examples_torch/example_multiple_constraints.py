"""1-D optimization with separate objective and safety-constraint GPs
(the reference's 1d_multiple_constraints_example notebook), on the
PyTorch port: the objective is unconstrained (fmin = -inf), safety
comes entirely from a second GP with fmin = 0."""

import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from safeopt_torch import (GPRegression, RBF, SafeOpt,
                           linearly_spaced_combinations, sample_gp_function)


def main():
    """Run SafeOpt with an objective GP and a safety GP."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    bounds = [(-10.0, 10.0)]
    noise_var_f = 0.05 ** 2
    noise_var_g = 1e-5
    kernel_f = RBF(1, variance=2.0, lengthscale=1.0, ARD=True)
    kernel_g = RBF(1, variance=2.0, lengthscale=2.0, ARD=True)

    gen = torch.Generator().manual_seed(args.seed)
    x0 = np.array([[0.0]])
    while True:
        objective = sample_gp_function(kernel_f, bounds, noise_var_f, 100,
                                       generator=gen, seed=args.seed,
                                       device=args.device)
        constraint = sample_gp_function(kernel_g, bounds, noise_var_g, 100,
                                        generator=gen, seed=args.seed + 1,
                                        device=args.device)
        if float(constraint(x0, noise=False)[0, 0]) > 0.2:
            break

    gp_f = GPRegression(x0, objective(x0).cpu().numpy(), kernel_f,
                        noise_var=noise_var_f, device=args.device)
    gp_g = GPRegression(x0, constraint(x0).cpu().numpy(), kernel_g,
                        noise_var=noise_var_g, device=args.device)
    parameter_set = linearly_spaced_combinations(bounds, 1000)
    opt = SafeOpt([gp_f, gp_g], parameter_set, fmin=[-np.inf, 0.0],
                  threshold=0.1)

    for i in range(args.iters):
        x_next = opt.optimize()
        y = float(objective(np.atleast_2d(x_next))[0, 0])
        g = float(constraint(np.atleast_2d(x_next))[0, 0])
        opt.add_new_data_point(x_next, np.array([[y, g]]))
        status = "SAFE" if g >= 0 else "VIOLATION"
        print(f"iter {i:3d}  x={np.asarray(x_next).ravel()}  y={y:+.4f}  "
              f"g={g:+.4f}  [{status}]")

    best = opt.get_maximum()
    if best is not None:
        x_best, y_best = best
        print(f"\nbest: x={np.asarray(x_best).ravel()}  lower-bound={y_best}")


if __name__ == "__main__":
    main()

"""2-D safe optimization (the reference's 2d_example notebook), on the
PyTorch port."""

import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from safeopt_torch import (GPRegression, RBF, SafeOpt, SafeOptSwarm,
                           linearly_spaced_combinations, sample_gp_function)


def main():
    """Sample a safe 2-D objective, then run the optimizer on it."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", choices=["swarm", "grid"], default="swarm")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    noise_var = 0.05 ** 2
    bounds = [(-5.0, 5.0), (-5.0, 5.0)]
    kernel = RBF(2, variance=2.0, lengthscale=1.0, ARD=True)

    gen = torch.Generator().manual_seed(args.seed)
    x0 = np.zeros((1, 2))
    while True:
        fun = sample_gp_function(kernel, bounds, noise_var, 30,
                                 generator=gen, seed=args.seed,
                                 device=args.device)
        if float(fun(x0, noise=False)[0, 0]) > 0.5:
            break

    gp = GPRegression(x0, fun(x0).cpu().numpy(), kernel,
                      noise_var=noise_var, device=args.device)
    if args.algo == "swarm":
        opt = SafeOptSwarm(gp, fmin=[0.0], bounds=bounds, threshold=0.2,
                           seed=args.seed)
    else:
        parameter_set = linearly_spaced_combinations(bounds, 100)
        opt = SafeOpt(gp, parameter_set, fmin=[0.0], threshold=0.2)

    for i in range(args.iters):
        x_next = opt.optimize()
        y_meas = fun(np.atleast_2d(x_next)).cpu().numpy()
        opt.add_new_data_point(x_next, y_meas)
        print(f"iter {i:3d}  x={np.round(np.asarray(x_next).ravel(), 3)}  "
              f"y={float(y_meas[0, 0]):+.4f}")

    x_best, y_best = opt.get_maximum()
    print(f"\nbest: x={np.round(np.asarray(x_best).ravel(), 3)}  "
          f"value={y_best}")


if __name__ == "__main__":
    main()

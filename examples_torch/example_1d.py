"""1-D safe optimization (the reference's 1d_example notebook), on the
PyTorch port.

Samples a test function from the GP prior (drawing again until the seed
point is safe), then alternates optimize() / add_new_data_point(). Run
with --algo swarm for SafeOptSwarm (the notebook's default) or --algo
grid for exact SafeOpt; --device cpu runs the kernels' plain versions.
"""

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
    """Sample a safe objective, then run the optimizer on it."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", choices=["swarm", "grid"], default="swarm")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args()

    # measurement noise and kernel (the notebook's)
    noise_var = 0.05 ** 2
    bounds = [(-10.0, 10.0)]
    kernel = RBF(1, variance=2.0, lengthscale=1.0, ARD=True)

    # a safe-at-x0 objective from the GP prior
    gen = torch.Generator().manual_seed(args.seed)
    x0 = np.array([[0.0]])
    while True:
        fun = sample_gp_function(kernel, bounds, noise_var, 100,
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
        parameter_set = linearly_spaced_combinations(bounds, 1000)
        opt = SafeOpt(gp, parameter_set, fmin=[0.0], threshold=0.2)

    for i in range(args.iters):
        x_next = opt.optimize()
        y_meas = fun(np.atleast_2d(x_next)).cpu().numpy()
        opt.add_new_data_point(x_next, y_meas)
        print(f"iter {i:3d}  x={np.asarray(x_next).ravel()}  "
              f"y={float(y_meas[0, 0]):+.4f}")

    x_best, y_best = opt.get_maximum()
    print(f"\nbest: x={np.asarray(x_best).ravel()}  value={y_best}")

    if args.plot:
        import matplotlib.pyplot as plt

        opt.plot(100)
        plt.savefig("example_1d.png", dpi=100)
        print("saved example_1d.png")


if __name__ == "__main__":
    main()

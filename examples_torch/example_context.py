"""Contextual safe optimization (the reference's context_example
notebook), on the PyTorch port: kernel = RBF(parameter) x RBF(context)
via active_dims, one context column, the context switched 0 -> 0.1
mid-run (K2 and K4 take this kernel on the card)."""

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
    """Optimize at context 0.0, then at context 0.1."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=10,
                        help="iterations per context")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    noise_var = 0.05 ** 2
    # joint bounds: the parameter column, then the context column
    bounds = [(-5.0, 5.0), (-1.0, 1.0)]
    kernel = (RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0]) *
              RBF(1, variance=1.0, lengthscale=1.0, active_dims=[1],
                  name="context"))

    gen = torch.Generator().manual_seed(args.seed)
    x0 = np.array([[0.0, 0.0]])
    while True:
        fun = sample_gp_function(kernel, bounds, noise_var, 50,
                                 generator=gen, seed=args.seed,
                                 device=args.device)
        if float(fun(x0, noise=False)[0, 0]) > 0.5:
            break

    gp = GPRegression(x0, fun(x0).cpu().numpy(), kernel,
                      noise_var=noise_var, device=args.device)
    parameter_set = linearly_spaced_combinations([bounds[0]], 1000)
    opt = SafeOpt(gp, parameter_set, fmin=[0.0], num_contexts=1,
                  threshold=0.1)

    for context in (0.0, 0.1):
        print(f"\n--- context = {context} ---")
        for i in range(args.iters):
            x_next = opt.optimize(context=np.array([context]))
            joint = np.concatenate([np.atleast_1d(x_next), [context]])
            y = fun(joint[None, :]).cpu().numpy()
            opt.add_new_data_point(x_next, y, context=np.array([context]))
            print(f"iter {i:3d}  x={np.asarray(x_next).ravel()}  "
                  f"y={float(y[0, 0]):+.4f}")
        best = opt.get_maximum(context=np.array([context]))
        if best is not None:
            print(f"best at context {context}: x={best[0]}  "
                  f"lower-bound={best[1]:.4f}")


if __name__ == "__main__":
    main()

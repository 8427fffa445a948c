"""Safe-BO campaigns whose objective runs on the device, on the PyTorch
port (no reference counterpart: the reference's loop is host-bound).

When the objective can be computed on the card (a simulation, a
surrogate), the whole campaign stays there: each iteration runs the
step, evaluates the objectives at its query, adds the noise and appends
the observation to the float64 factors with ``gp_append``
(``algorithms/runner.py``). The SafeOpt loop reads the device only for
its expander walk; the swarm loop replays its fused iteration as one
CUDA graph and reads nothing.

Usage: python examples_torch/example_on_device_loop.py [--iters 10]
       [--device cuda]
"""

import argparse
import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    """Run a SafeOpt and a SafeOptSwarm campaign on the device."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import torch

    from safeopt_torch import GPRegression, RBF, linearly_spaced_combinations
    from safeopt_torch.algorithms.runner import (run_safeopt_loop,
                                                 run_swarmopt_loop)
    from safeopt_torch.algorithms.swarm_opt_fused import SwarmIterState

    dev = torch.device(args.device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # a device-computable objective and safety measurement
    def f(x):
        return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    def g(x):
        return 1.0 - 0.1 * torch.sum(x * x)

    # ---- SafeOpt campaign over a 200x200 grid --------------------------
    grid = linearly_spaced_combinations([(-3.0, 3.0), (-3.0, 3.0)], 200)
    x0 = np.zeros((1, 2))
    gp_f = GPRegression(x0, np.array([[2.0]]), RBF(2, variance=2.0),
                        noise_var=1e-4, capacity=64, device=dev)
    gp_g = GPRegression(x0, np.array([[1.0]]),
                        RBF(2, variance=1.0, lengthscale=1.5),
                        noise_var=1e-4, capacity=64, device=dev)
    dtype = gp_f.dtype
    res = run_safeopt_loop(
        (gp_f.kern, gp_g.kern), (gp_f.factor_state(), gp_g.factor_state()),
        t(grid, dtype), t([0.2, 0.5], dtype), 2.0,
        t([np.sqrt(2.0), 1.0], dtype), t([0.0, 0.0], dtype),
        torch.Generator(device=dev).manual_seed(0), objectives=(f, g),
        n_iter=args.iters, noise_std=0.01)
    assert bool(res.has_safe.all()), "lost certification"
    ys = res.ys.cpu().numpy()
    print(f"SafeOpt on-device campaign: {args.iters} iterations, "
          f"best y = {ys[:, 0].max():.4f}, "
          f"final |S| = {int(res.safe_counts[-1])}")

    # ---- SafeOptSwarm campaign in the continuous domain ----------------
    d, cap = 2, 256
    iter_state = SwarmIterState(S=torch.zeros((cap, d), dtype=dtype,
                                              device=dev),
                                count=torch.tensor(1, device=dev),
                                greedy=torch.zeros(d, dtype=dtype,
                                                   device=dev))
    res2 = run_swarmopt_loop(
        (gp_f.kern,), (gp_f.factor_state(),), iter_state,
        t([0.3, 0.3], dtype), t([[-3.0, 3.0]] * d, dtype), t([0.0], dtype),
        t([np.sqrt(2.0)], dtype), t([0.0], dtype),
        np.full(args.iters, 2.0), np.zeros(d), -np.inf,
        torch.Generator(device=dev).manual_seed(1),
        torch.Generator(device=dev).manual_seed(2), objectives=(f,),
        n_iter=args.iters, swarm_size=12, max_iters=30, noise_std=0.01)
    assert bool((res2.num_safe_min > 0).all()), "lost certification"
    ys2 = res2.ys.cpu().numpy()
    print(f"SafeOptSwarm on-device campaign: {args.iters} iterations, "
          f"best y = {ys2[:, 0].max():.4f}, "
          f"final |S| = {int(res2.safe_counts[-1])}")
    print("best:", res.xs.cpu().numpy()[int(np.argmax(ys[:, 0]))],
          f"value={ys[:, 0].max():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

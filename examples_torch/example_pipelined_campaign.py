"""A pipelined lag-1 SafeOptSwarm campaign, on the PyTorch port.

For plants that can evaluate query t while the optimizer computes query
t+1 (lag-1, delayed feedback), ``run_lagged_campaign(pipelined=True)``
dispatches the next iteration before reading the current result, so the
result's copy and the plant's evaluation overlap the next iteration's
device work. The queries are those of the blocking loop: this example
runs both modes on the same problem and asserts that the trajectories
are equal bit for bit.
"""

import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse
import time

import numpy as np

from safeopt_torch import GPRegression, RBF, SafeOptSwarm, run_lagged_campaign


def main():
    """Run the campaign blocking and pipelined; compare."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--dim", type=int, default=6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    d = args.dim
    noise_var = 0.01

    def plant(x):
        """The physical system being tuned (synthetic here)."""
        x = np.asarray(x, dtype=float)
        return float(2.0 * np.exp(-0.5 * np.sum(x ** 2)))

    def fresh_opt():
        rng = np.random.default_rng(args.seed)
        X0 = rng.uniform(-0.3, 0.3, size=(4, d))
        Y0 = np.array([[plant(x)] for x in X0])
        gp = GPRegression(X0, Y0, RBF(d, variance=2.0, lengthscale=2.0),
                          noise_var=noise_var, device=args.device)
        return SafeOptSwarm(gp, fmin=[0.5], bounds=[(-2.0, 2.0)] * d,
                            swarm_size=16, seed=args.seed)

    t0 = time.perf_counter()
    xs_serial, ys_serial = run_lagged_campaign(
        fresh_opt(), plant, args.iters, pipelined=False)
    serial_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    xs_pipe, ys_pipe = run_lagged_campaign(
        fresh_opt(), plant, args.iters, pipelined=True)
    pipe_s = time.perf_counter() - t0

    assert np.array_equal(xs_serial, xs_pipe), \
        "pipelined trajectory diverged from the blocking loop"
    assert (ys_pipe >= 0.5 - 3 * np.sqrt(noise_var)).all(), \
        "a query left the safe region"
    for t, (x, y) in enumerate(zip(xs_pipe, ys_pipe.ravel())):
        print(f"iter {t:3d}  y={y:+.4f}  x={np.round(x, 3)}")
    best = int(np.argmax(ys_pipe.ravel()))
    print(f"blocking {serial_s * 1e3 / args.iters:.1f} ms/iter, "
          f"pipelined {pipe_s * 1e3 / args.iters:.1f} ms/iter "
          f"(identical trajectories)")
    print(f"best: x={np.round(xs_pipe[best], 3)} "
          f"value={ys_pipe.ravel()[best]:.4f}")


if __name__ == "__main__":
    main()

"""Safe optimization of a quasi-periodic objective (a kernel showcase),
on the PyTorch port.

A damped oscillation (a resonance curve, a seasonal response) is
modeled with the quasi-periodic composition ``Cosine * RBF``: the Cosine
part carries the dominant frequency, the wide RBF envelope lets the
amplitude drift.

The loop: seed safely at the central peak, fit the kernel's frequency
and envelope by marginal likelihood every few observations
(``gp.optimize_hyperparameters``: Adam in log space and a BFGS polish),
and let SafeOpt expand outward without ever sampling below the safety
threshold. Between any two peaks the objective dips below it, so the
safe set must grow in steps that only a correct posterior certifies.
"""

import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse

import numpy as np

from safeopt_torch import (Cosine, GPRegression, RBF, SafeOpt,
                           linearly_spaced_combinations)

FMIN = 0.0


def objective(x):
    """Damped oscillation, safe (> 0) only near its peaks."""
    x = np.atleast_2d(x)[:, 0]
    return 1.1 * np.cos(1.5 * x) * np.exp(-0.5 * (x / 6.0) ** 2) + 0.25


def main():
    """Run SafeOpt with periodic refits of the kernel."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--refit-every", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    rng = np.random.default_rng(args.seed)
    noise_std = 0.01
    # The initial frequency is mildly off (lengthscale 0.8, ~1.25 rad per
    # unit against the true 1.5); the refits pull it in from the data.
    # The safety guarantee holds only under a roughly correct prior, as
    # in the reference: a badly wrong frequency makes the posterior
    # confidently wrong between peaks.
    kern = Cosine(1, variance=1.0, lengthscale=0.8) \
        * RBF(1, variance=1.0, lengthscale=8.0)
    x0 = np.array([[0.0]])
    y0 = objective(x0)[:, None] + noise_std * rng.normal(size=(1, 1))
    gp = GPRegression(x0, y0, kern, noise_var=noise_std ** 2,
                      device=args.device)
    grid = linearly_spaced_combinations([(-8.0, 8.0)], 400)
    opt = SafeOpt(gp, grid, fmin=[FMIN], beta=3.0, threshold=0.05)

    worst = np.inf
    for it in range(args.iters):
        if it and it % args.refit_every == 0:
            lml = gp.optimize_hyperparameters(steps=150)
            ls = float(gp.kern.k1.lengthscale)
            print(f"  refit: LML {lml:+.2f}, cosine lengthscale {ls:.3f}")
        x = np.asarray(opt.optimize())
        y_true = float(objective(x)[0])
        worst = min(worst, y_true)
        y = y_true + noise_std * float(rng.normal())
        opt.add_new_data_point(x, np.array([[y]]))
        print(f"iter {it:3d}  x={x[0]:+7.3f}  y={y:+.4f}  "
              f"|S|={int(np.sum(opt.S)):3d}")

    assert worst > FMIN, f"sampled an unsafe point (worst {worst:.3f})"
    m = opt.get_maximum()
    print(f"\nall {args.iters} queries stayed safe "
          f"(worst true value {worst:+.3f} > {FMIN})")
    print(f"best: x={np.asarray(m[0])[0]:+.3f} lower-bound={m[1]:.4f}")


if __name__ == "__main__":
    main()

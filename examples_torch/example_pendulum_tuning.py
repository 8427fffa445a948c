"""Safe PD-controller tuning on a simulated inverted pendulum, on the
PyTorch port.

The reference's motivating application is safe controller tuning on
real hardware (never evaluate a gain setting that destabilizes the
system). This example runs that shape end to end on the device: the
pendulum rollout is computed there, so the whole campaign (the SafeOpt
step, the closed-loop simulation, the exact model update) runs in
``algorithms/runner.run_safeopt_loop`` without NumPy between
iterations.

System: linearized inverted pendulum, theta_ddot = a*theta + b*u with
a = g/l = 4 (unstable), b = 1, controlled by u = -k1*theta - k2*omega.
Tuning domain: (k1, k2) in [0, 12] x [0, 8] on a 101x81 grid.

- objective GP: negative quadratic cost of the rollout (higher = better
  tracking with less effort)
- safety GP: angle margin ``1 - max_t |theta_t| / theta_lim``: a gain
  pair is SAFE iff the closed loop never exceeds the angle limit.
  fmin = 0: SafeOpt only queries controllers it can certify.

Seeded with one conservative stabilizing controller, as the papers seed
with a hand-tuned safe gain set.

``--fleet K`` tunes K DIFFERENT pendulums (pole constants a spread over
[3.2, 6.0]) as one heterogeneous campaign fleet
(``parallel.run_safeopt_campaigns`` with per-campaign
``objective_args_batch``); under ``torchrun`` the fleet splits over the
ranks' mesh, one card each.

Usage: python examples_torch/example_pendulum_tuning.py [--iters 15]
       [--fleet 8] [--device cuda]
"""

import argparse
import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

A_COEF, B_COEF, DT, T = 4.0, 1.0, 0.02, 150
THETA0, THETA_LIM = 0.10, 0.25


def rollout(gains, a_coef=A_COEF):
    """Closed-loop trajectory stats of a (2,) gain tensor: (cost, max
    |theta|), on the gains' device."""
    import torch

    k1, k2 = gains[0], gains[1]
    theta = torch.full((), THETA0, dtype=gains.dtype, device=gains.device)
    omega = torch.zeros_like(theta)
    stages, aths = [], []
    for _ in range(T):
        u = -k1 * theta - k2 * omega
        omega = omega + DT * (a_coef * theta + B_COEF * u)
        theta = theta + DT * omega
        stages.append(theta ** 2 + 0.1 * omega ** 2 + 1e-3 * u ** 2)
        aths.append(torch.abs(theta))
    return torch.sum(torch.stack(stages)) * DT, torch.max(torch.stack(aths))


def objective(gains, a_coef=A_COEF):
    """Negative rollout cost, scaled to O(1) for the unit-variance GP."""
    cost, _ = rollout(gains, a_coef)
    return -cost / 0.05


def safety(gains, a_coef=A_COEF):
    """Angle margin 1 - max |theta| / theta_lim, clipped at -3."""
    import torch

    _, ath = rollout(gains, a_coef)
    # angle margin, clipped below so that divergent rollouts do not put
    # astronomically negative targets into the GP
    return torch.clamp(1.0 - ath / THETA_LIM, min=-3.0)


def main():
    """Tune one pendulum's gains, or a fleet of pendulums."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=15)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fleet", type=int, default=0,
                        help="tune K different pendulums as one "
                             "heterogeneous fleet")
    args = parser.parse_args()

    import torch

    from safeopt_torch import GPRegression, RBF, linearly_spaced_combinations
    from safeopt_torch.algorithms.runner import run_safeopt_loop

    if args.fleet:
        _run_fleet(args)
        return

    dev = torch.device(args.device)
    # conservative but distinctly suboptimal (weak proportional gain,
    # ~3x the optimal cost): the papers' hand-tuned seed
    seed_gains = np.array([[4.8, 1.0]])
    grid = linearly_spaced_combinations([(0.0, 12.0), (0.0, 8.0)],
                                        [101, 81])
    kern_f = RBF(2, variance=4.0, lengthscale=[3.0, 2.0], ARD=True)
    kern_g = RBF(2, variance=1.0, lengthscale=[2.0, 1.5], ARD=True)

    x0 = torch.tensor(seed_gains[0], dtype=torch.float64, device=dev)
    y_f0 = float(objective(x0))
    y_g0 = float(safety(x0))
    assert y_g0 > 0.2, "seed controller must be comfortably safe"

    cap = args.iters + 4
    gp_f = GPRegression(seed_gains, np.array([[y_f0]]), kern_f,
                        noise_var=1e-4, capacity=cap, device=dev)
    gp_g = GPRegression(seed_gains, np.array([[y_g0]]), kern_g,
                        noise_var=1e-4, capacity=cap, device=dev)
    dtype = gp_f.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    print(f"seed gains k=({seed_gains[0][0]}, {seed_gains[0][1]}): "
          f"objective {y_f0:+.3f}, safety margin {y_g0:+.3f}")

    res = run_safeopt_loop(
        (kern_f, kern_g), (gp_f.factor_state(), gp_g.factor_state()),
        t(grid), t([-np.inf, 0.0]),       # the objective is unconstrained
        3.0,                               # beta
        t([2.0, 1.0]),                     # scaling (the prior stds)
        t([0.05, 0.05]), objectives=(objective, safety),
        n_iter=args.iters, chunk=64)

    xs = res.xs.cpu().numpy()
    ys = res.ys.cpu().numpy()
    assert bool(res.has_safe.all()), "lost certification"
    worst_margin = ys[:, 1].min()
    print(f"\n{args.iters} on-device iterations; safe-set size "
          f"{int(res.safe_counts[-1])}")
    for i in range(len(xs)):
        print(f"iter {i:3d}  k=({xs[i, 0]:6.3f}, {xs[i, 1]:6.3f})  "
              f"cost={-ys[i, 0] * 0.05:7.4f}  margin={ys[i, 1]:+.3f}")

    # THE safety property: every queried controller kept |theta| within
    # the limit
    assert worst_margin > 0.0, \
        f"SAFETY VIOLATED: margin {worst_margin:+.3f}"
    best = int(np.argmax(ys[:, 0]))
    base_cost = -y_f0 * 0.05
    best_cost = -ys[best, 0] * 0.05
    print(f"\nall {len(xs)} queried controllers stayed within "
          f"|theta| < {THETA_LIM} (worst margin {worst_margin:+.3f})")
    print(f"best: k=({xs[best, 0]:.3f}, {xs[best, 1]:.3f}) "
          f"cost {best_cost:.4f} vs seed {base_cost:.4f} "
          f"({base_cost / best_cost:.2f}x better)")
    assert best_cost < base_cost, "tuning should improve on the seed"


def _run_fleet(args):
    """K different pendulums (pole constants a in [3.2, 6.0]) tuned as
    one heterogeneous campaign fleet, split over the ranks' mesh under
    torchrun."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from example_campaign_fleet import fleet_mesh, whole
    from safeopt_torch import GPRegression, RBF, linearly_spaced_combinations
    from safeopt_torch.parallel import (run_safeopt_campaigns,
                                        stack_campaign_states)

    dev = torch.device(args.device)
    mesh, rank, world = fleet_mesh(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    K = args.fleet
    a_coefs = np.linspace(3.2, 6.0, K)

    # each plant seeded with a conservative stabilizer scaled to its a
    grid = linearly_spaced_combinations([(0.0, 12.0), (0.0, 8.0)],
                                        [101, 81])
    kern_f = RBF(2, variance=4.0, lengthscale=[3.0, 2.0], ARD=True)
    kern_g = RBF(2, variance=1.0, lengthscale=[2.0, 1.5], ARD=True)
    cap = args.iters + 4
    per_campaign = []
    for a in a_coefs:
        seed = np.array([[a + 1.5, 1.2]])
        x = torch.tensor(seed[0], dtype=torch.float64, device=dev)
        y_f, y_g = float(objective(x, a)), float(safety(x, a))
        assert y_g > 0.2, f"seed for a={a:.2f} must be safe"
        per_campaign.append(tuple(
            GPRegression(seed, np.array([[y]]), k, noise_var=1e-4,
                         capacity=cap, device=dev).factor_state()
            for y, k in ((y_f, kern_f), (y_g, kern_g))))
    dtype = GPRegression(seed, np.zeros((1, 1)), kern_f, device=dev).dtype

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    split = mesh is not None and K % world == 0
    if rank == 0:
        print(f"heterogeneous fleet: {K} pendulums (a in "
              f"[{a_coefs[0]:.2f}, {a_coefs[-1]:.2f}]) x {args.iters} "
              f"iterations on {world if split else 1} device(s)")
    fleet = run_safeopt_campaigns(
        (kern_f, kern_g), stack_campaign_states(per_campaign), t(grid),
        t([-np.inf, 0.0]), 3.0, t([2.0, 1.0]), t([0.05, 0.05]),
        objectives=(objective, safety), n_iter=args.iters,
        mesh=mesh if split else None,
        objective_args_batch=torch.tensor(a_coefs, dtype=torch.float64,
                                          device=dev), chunk=64)

    xs = whole(fleet.xs).numpy()
    ys = whole(fleet.ys).numpy()
    assert bool(whole(fleet.has_safe).all()), "lost certification"
    worst = ys[:, :, 1].min()
    if rank == 0:
        for k in range(K):
            best = int(np.argmax(ys[k, :, 0]))
            print(f"plant a={a_coefs[k]:.2f}: best k="
                  f"({xs[k, best, 0]:6.3f}, {xs[k, best, 1]:6.3f})  "
                  f"cost={-ys[k, best, 0] * 0.05:7.4f}  "
                  f"worst margin={ys[k, :, 1].min():+.3f}")
    assert worst > 0.0, f"SAFETY VIOLATED: margin {worst:+.3f}"
    if rank == 0:
        print(f"\nall {K * args.iters} queries across the fleet stayed "
              f"within |theta| < {THETA_LIM} (worst margin {worst:+.3f})")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""Long production campaign on the PyTorch port: a sparse model, a
mid-run resume, hyperparameter fitting (no reference counterpart: the
reference has no sparse inference, persistence or fitting).

1. A DTC sparse GP bounds the cost of an iteration by its m inducing
   points; its update is an O(m^2) rank-1 information update, so
   appending observation 2,000 costs what appending observation 10 does.
2. The campaign checkpoints its device loop state mid-run
   (``utils.checkpoint.save_state``) and resumes bit for bit: the loop's
   noise is an explicit (n_iter, G) tensor of normals, whose tail the
   resumed run takes.
3. The hyperparameters are fitted from the accumulated data by
   multi-start marginal likelihood (restarts in one batch).

Usage: python examples_torch/example_long_campaign.py [--n-pre 400]
       [--iters 24] [--inducing 32] [--device cuda]
"""

import argparse
import os
import sys
import tempfile

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def main():
    """Fit, run certified SafeOpt, then a resumed device campaign."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-pre", type=int, default=400,
                        help="pre-existing observations (the 'long' part)")
    parser.add_argument("--iters", type=int, default=24)
    parser.add_argument("--inducing", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import torch

    from safeopt_torch import (GPRegression, RBF, SafeOpt,
                               SparseGPRegression,
                               linearly_spaced_combinations)
    from safeopt_torch.algorithms.runner import run_safeopt_loop
    from safeopt_torch.utils.checkpoint import load_state, save_state

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)

    def f_true(x):
        x = np.atleast_2d(x)
        return 2.0 * np.exp(-0.5 * np.sum(x * x, axis=1))

    # ---- a long history of safe operating points -----------------------
    X_pre = rng.uniform(-0.8, 0.8, size=(args.n_pre, 2))
    Y_pre = (f_true(X_pre) + 0.02 * rng.normal(size=args.n_pre))[:, None]

    # the inducing points must cover the search domain, not only the
    # data: a DTC posterior cannot shrink the variance where k(Z, x) ~ 0
    side = max(2, int(np.sqrt(args.inducing)))
    Z = linearly_spaced_combinations([(-2.5, 2.5), (-2.5, 2.5)], side)
    sparse = SparseGPRegression(X_pre, Y_pre,
                                RBF(2, variance=1.0, lengthscale=0.5),
                                noise_var=0.02 ** 2, inducing=Z, device=dev)

    # ---- fit the hyperparameters to the accumulated data ---------------
    lml = sparse.optimize_hyperparameters(steps=150, restarts=3)
    print(f"hyperopt: DTC LML {lml:.1f}, "
          f"lengthscale {float(sparse.kern.lengthscale):.3f}, "
          f"noise {sparse.noise_var:.5f}")

    # ---- host-driven SafeOpt on the sparse model ------------------------
    # exact_boundaries: the near-threshold safe bits are settled by the
    # sparse model's float64 oracle, so the device pseudo-factor's
    # rounding never flips a knife-edge decision
    grid = linearly_spaced_combinations([(-2.5, 2.5), (-2.5, 2.5)], 100)
    opt = SafeOpt(sparse, grid, fmin=[0.5], threshold=0.05,
                  exact_boundaries=True)
    for t in range(args.iters // 3):
        x = np.asarray(opt.optimize())
        y = float(f_true(x)[0] + 0.02 * rng.normal())
        assert f_true(x)[0] > 0.5, "a host query left the safe region"
        opt.add_new_data_point(x, y)
        print(f"host iter {t:2d}  x={np.round(x, 3)}  y={y:+.4f}  "
              f"(n={sparse.num_data}, m={sparse.num_inducing}, "
              f"band={opt._band_population})")

    # ---- an on-device campaign with a mid-run checkpoint and resume ----
    x0 = np.zeros((1, 2))
    gp = GPRegression(x0, np.array([[2.0]]), RBF(2, variance=2.0),
                      noise_var=1e-4, capacity=64, device=dev)
    dtype = gp.dtype

    def f_dev(x):
        return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    def t_(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    loop_args = ((gp.kern,), t_(grid), t_([0.5]), 2.0, t_([np.sqrt(2.0)]),
                 t_([0.0]))
    common = dict(objectives=(f_dev,), noise_std=0.02, chunk=32)
    n_iter = args.iters
    noise = torch.randn((n_iter, 1), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(7))
    half = n_iter // 2
    head = run_safeopt_loop(loop_args[0], (gp.factor_state(),),
                            *loop_args[1:], noise[:half], n_iter=half,
                            **common)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "campaign_ckpt.npz")
        save_state(ckpt, {"states": head.states, "noise": noise, "t": half})
        print(f"checkpointed device state at iteration {half} -> {ckpt}")
        ck = load_state(ckpt, device=dev)       # "the process restarts"
    tail = run_safeopt_loop(loop_args[0], tuple(ck["states"]),
                            *loop_args[1:], ck["noise"][ck["t"]:],
                            n_iter=n_iter - half, **common)
    full = run_safeopt_loop(loop_args[0], (gp.factor_state(),),
                            *loop_args[1:], noise, n_iter=n_iter, **common)
    resumed = torch.cat([head.xs, tail.xs])
    assert torch.equal(resumed, full.xs), "resumed trajectory diverged"
    assert bool(full.has_safe.all())
    ys = full.ys[:, 0].cpu().numpy()
    print(f"resumed == uninterrupted over {n_iter} device iterations "
          f"(best y {ys.max():+.4f})")

    x_best, lb = opt.get_maximum()
    print(f"best: x={np.round(np.asarray(x_best), 3)} "
          f"lower-bound={float(lb):.4f}")


if __name__ == "__main__":
    main()

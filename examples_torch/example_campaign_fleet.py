"""A fleet of safe-BO campaigns as one batched program, on the PyTorch
port (no reference counterpart: the reference is one NumPy process).

Runs K independent on-device SafeOpt campaigns (different safe seeds,
one shared objective) as one fleet: a fleet step launches K1 once and K3
once a walk round for all of them
(``parallel.run_safeopt_campaigns``). Launched under ``torchrun`` (it
sets ``WORLD_SIZE``), the campaign axis splits over the ranks' mesh, one
card each, with no traffic between cards inside the loop:

    torchrun --nproc-per-node 4 examples_torch/example_campaign_fleet.py
    torchrun --nproc-per-node 4 examples_torch/example_campaign_fleet.py \\
        --device cpu          # four gloo processes on the CPU

Otherwise the fleet runs on one device.

Usage: python examples_torch/example_campaign_fleet.py [--campaigns 8]
       [--iters 6] [--device cuda]
"""

import argparse
import os
import sys

# allow running straight from a repo checkout: python examples_torch/<name>.py
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def fleet_mesh(device):
    """``(mesh, rank, world)``: a data mesh over the ``torchrun`` world
    (NCCL on cards, gloo on the CPU), or ``(None, 0, 1)`` outside it."""
    import torch.distributed as dist

    from safeopt_torch.parallel import make_mesh

    if "WORLD_SIZE" not in os.environ:
        return None, 0, 1
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return (make_mesh(device_type=device.type), dist.get_rank(),
            dist.get_world_size())


def whole(t):
    """A fleet result's tensor whole on this rank, on the host."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()


def main():
    """Run the fleet and print each campaign's best."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--campaigns", type=int, default=8)
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import torch

    from safeopt_torch import GPRegression, RBF, linearly_spaced_combinations
    from safeopt_torch.parallel import (run_safeopt_campaigns,
                                        stack_campaign_states)

    dev = torch.device(args.device)
    mesh, rank, world = fleet_mesh(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    K = args.campaigns
    kern = RBF(2, variance=2.0, lengthscale=1.2)

    def objective(x):
        return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    # K campaigns, each seeded at a different (safe) starting point
    rng = np.random.default_rng(0)
    per_campaign = []
    for _ in range(K):
        x0 = rng.uniform(-0.4, 0.4, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        gp = GPRegression(x0, np.array([[y0]]), kern, noise_var=1e-4,
                          capacity=max(16, args.iters + 2), device=dev)
        per_campaign.append((gp.factor_state(),))
    dtype = gp.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    grid = t(linearly_spaced_combinations([(-2.0, 2.0), (-2.0, 2.0)], 33))
    split = mesh is not None and K % world == 0
    if rank == 0:
        print(f"fleet: {K} campaigns x {args.iters} iterations on "
              f"{world if split else 1} device(s)")

    fleet = run_safeopt_campaigns(
        (kern,), stack_campaign_states(per_campaign), grid, t([0.5]), 2.0,
        t([np.sqrt(2.0)]), t([0.0]),
        torch.Generator(device=dev).manual_seed(0),
        objectives=(objective,), n_iter=args.iters, noise_std=0.01,
        mesh=mesh if split else None, chunk=16)

    xs = whole(fleet.xs).numpy()                    # (K, T, d)
    ys = whole(fleet.ys).numpy()[:, :, 0]           # (K, T)
    ok = whole(fleet.has_safe).numpy().all(axis=1)  # (K,)
    if rank == 0:
        for k in range(K):
            tag = "ok " if ok[k] else "LOST-CERT"
            print(f"campaign {k}: best y = {ys[k].max():+.4f}  "
                  f"final x = {np.round(xs[k, -1], 3)}  [{tag}]")
        kbest = int(ys.max(axis=1).argmax())
        print(f"\nfleet best: campaign {kbest}, y = {ys[kbest].max():.4f}")
    assert ok.all(), "a campaign lost safety certification"
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the certified path's ``optimize()`` at several refinement budgets.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/time_certified.py [--shares 0.1 0.2 0.55]
        [--iters 10] [--out chiprun_out/certified.json]

The certified path (``exact_boundaries=True``,
``interval_precision='high'``, the device oracle) on chip_smoke's
cap-512 state (two RBF GPs, 400 observations, capacity 512, the 1000 x
1000 grid) and its contextual state (two GPs of the contextual kernel,
240 observations, capacity 256, a 1e6-point parameter grid; context 0
for the first half of the iterations, 0.1 after), in float32, with the
refinement budget ``refine_band_k`` set to each share of the grid's N
rows. The refinement recomputes the budget's rows (the top of its
boundary key) whenever the band fits it, and the whole grid when it
does not, so a share sets both what a refined step costs and which
steps refine. Each (state, share) is a fresh run of ``--iters``
iterations of ``optimize()`` and ``add_new_data_point()`` against the
plant; the shares run in turns, the list and then the list reversed, in
one process. Prints the card's ``nvidia-smi`` line and one JSON object
per run: the median CUDA-event ms of ``optimize()`` over iterations 2
on, and the steps that refined within the budget; writes all to
``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (BETA, CTX_FMIN, FMIN, SCALING,  # noqa: E402
                        context_gps, context_truth, plant, timed_ms)
from tools_torch.states import build_gps  # noqa: E402


def states():
    """{name: (make(refine_band_k), contexts, grid rows)}."""
    from safeopt_torch import SafeOpt, linearly_spaced_combinations

    grid = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    params = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)
    high = dict(exact_boundaries=True, interval_precision="high",
                oracle="device", expander_chunk=32)
    f32 = torch.float32

    def cap512(k):
        gps = build_gps(np.random.default_rng(512), 400, 512, "cuda", f32,
                        spread=4.0)
        return SafeOpt(gps, grid, fmin=FMIN, beta=BETA, scaling=SCALING,
                       refine_band_k=k, **high)

    def contextual(k):
        return SafeOpt(context_gps(2, 240, 256, "cuda", f32), params,
                       fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                       refine_band_k=k, **high)

    return {"cap512": (cap512, None, grid.shape[0]),
            "contextual": (contextual, [0.0, 0.1], params.shape[0])}


def run(make, contexts, budget, iters, seed):
    """One fresh run at refine budget ``budget``: (median ms from
    iteration 2, refined steps, band rows per step)."""
    rng = np.random.default_rng(seed)
    opt = make(budget)
    ms, refined, pops = [], 0, []
    for it in range(iters):
        c = None if contexts is None else contexts[2 * it // iters]
        kw = {} if c is None else {"context": c}
        x, t = timed_ms(lambda: opt.optimize(**kw))
        ms.append(t)
        refined += not opt.stats.last.refine_full_pass
        pops.append(int(opt._refine_band_population))
        if c is None:
            y = plant(rng, x)
        else:
            y = context_truth([[float(x[0]), c]]) + 0.05 * rng.normal(
                size=(1, 2))
        opt.add_new_data_point(x, y, **kw)
    return float(np.median(ms[1:])), refined, pops


def main():
    """Time every (state, share); returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shares", type=float, nargs="+",
                        default=[0.1, 0.2, 0.55])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--out", default="chiprun_out/certified.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_certified: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    results = []
    for name, (make, contexts, n_rows) in states().items():
        for share in args.shares + args.shares[::-1]:
            med, refined, pops = run(make, contexts, int(share * n_rows),
                                     args.iters, 5)
            r = {"state": name, "share": share, "optimize_ms": med,
                 "refined_steps": refined, "band_rows": pops}
            print(json.dumps(r), flush=True)
            results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"nvidia_smi": smi,
                                          "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

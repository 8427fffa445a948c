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

``--compare`` names long-campaign states (``COMPARE``: ``measure.py``'s
``cap1024``, ``cap2048`` and ``context2048``, float32, stepped at
context 0) on which the certified step (device oracle, the default
budget) and the plain step run in turns, certified, plain, plain,
certified, each a fresh run of ``--iters`` iterations; beside them, on
each state's first factor, the float32 K1 (K2 for a plan GP) over the
whole grid, K1-3p (K2-3p) over it and K1 (K2) over the budget's rows
(``REFINE_BAND_SHARE`` of N, the grid's first rows), CUDA-event ms, and
the break-even share (K1 - K1-3p) / K1: the budget at which a refined
certified step costs what the plain step's interval pass does. The
float32 ``'auto'`` path is the plain one (``interval_precision='auto'``);
these runs read whether certification could be the default at a
capacity on this card.
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
                        SPARSE_FMIN, SPARSE_SCALING, context_gps,
                        context_truth, plant, timed_ms)
from tools_torch.states import (build_gps, cuda_ms,  # noqa: E402
                                sparse_exact_gp)

COMPARE = ("cap1024", "cap2048", "context2048")


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


def compare_states():
    """{name: (make(certified), contexts, G)} of ``COMPARE``: the
    certified step (device oracle, default budget) or the plain one."""
    from safeopt_torch import SafeOpt, linearly_spaced_combinations

    grid = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    params = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)
    f32 = torch.float32

    def kw(certified):
        return (dict(exact_boundaries=True, interval_precision="high",
                     oracle="device", expander_chunk=32) if certified
                else dict(expander_chunk=32))

    def cap1024(certified):
        gps = build_gps(np.random.default_rng(1024), 600, 1024, "cuda", f32,
                        spread=4.0)[:1]
        return SafeOpt(gps, grid, fmin=FMIN[:1], beta=BETA,
                       scaling=SCALING[:1], **kw(certified))

    def cap2048(certified):
        return SafeOpt(sparse_exact_gp("cuda", f32), grid, fmin=SPARSE_FMIN,
                       beta=BETA, scaling=SPARSE_SCALING, **kw(certified))

    def context2048(certified):
        return SafeOpt(context_gps(2, 2000, 2048, "cuda", f32,
                                   spread_contexts=True), params,
                       fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                       **kw(certified))

    return {"cap1024": (cap1024, None, 1), "cap2048": (cap2048, None, 1),
            "context2048": (context2048, [0.0, 0.0], 2)}


def pass_times(opt, reps=5):
    """CUDA-event ms of the float32 grid passes on ``opt``'s first GP
    group: the full-float32 kernel over the grid, the three-pass kernel
    over it and the full-float32 kernel over the budget's rows (the
    grid's first ``refine_band_k`` rows), and the break-even share."""
    from safeopt_torch.algorithms.safe_opt import REFINE_BAND_SHARE
    from safeopt_torch.ops import fused_posterior as fp

    kernels, states = opt._model_args()
    grid = opt._grid()
    rows = grid[:int(grid.shape[0] * REFINE_BAND_SHARE)]
    if fp.supports_kernel(kernels[0], grid.shape[1]):
        def full(g, three=False):
            return fp.fused_intervals_batched(kernels, states, g, BETA,
                                              three_pass=three)
    else:
        def full(g, three=False):
            return fp.fused_intervals_single(kernels[0], states[0], g, BETA,
                                             three_pass=three)
    k1 = cuda_ms(lambda: full(grid), reps=reps)
    k3p = cuda_ms(lambda: full(grid, True), reps=reps)
    budget = cuda_ms(lambda: full(rows), reps=reps)
    return {"full_ms": k1, "three_pass_ms": k3p, "budget_rows": rows.shape[0],
            "budget_ms": budget, "break_even_share": (k1 - k3p) / k1,
            "refine_band_share": REFINE_BAND_SHARE}


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
            y = plant(rng, x)[:, :len(opt.gps)]
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
    parser.add_argument("--states", nargs="*",
                        default=["cap512", "contextual"],
                        choices=["cap512", "contextual"])
    parser.add_argument("--compare", nargs="*", default=[], choices=COMPARE)
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
        if name not in args.states:
            continue
        for share in args.shares + args.shares[::-1]:
            med, refined, pops = run(make, contexts, int(share * n_rows),
                                     args.iters, 5)
            r = {"state": name, "share": share, "optimize_ms": med,
                 "refined_steps": refined, "band_rows": pops}
            print(json.dumps(r), flush=True)
            results.append(r)
    compared = []
    for name, (make, contexts, G) in compare_states().items():
        if name not in args.compare:
            continue
        r = {"state": name, "gps": G, "passes": pass_times(make(True)),
             "certified_ms": [], "plain_ms": [], "refined_steps": [],
             "band_rows": []}
        for certified in (True, False, False, True):
            med, refined, pops = run(lambda k, c=certified: make(c),
                                     contexts, None, args.iters, 5)
            r["certified_ms" if certified else "plain_ms"].append(med)
            if certified:
                r["refined_steps"].append(refined)
                r["band_rows"].append(pops)
        print(json.dumps(r), flush=True)
        compared.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"nvidia_smi": smi,
                                          "runs": results,
                                          "compare": compared}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the PyTorch port of SafeOpt on one CUDA card, stage by stage.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/measure.py [--caps 64 512] [--reps 10]
                                   [--out chiprun_out/measure.json]

For each capacity it builds the flagship problem of ``chip_smoke.py`` in
float32: two RBF GPs on a 1000 x 1000 grid, expander chunk 32. Capacity
64 holds the 50 observations from ``default_rng(0)`` in [-1.5, 1.5]^2,
capacity 512 the 400 from ``default_rng(512)`` in [-4, 4]^2, as
chip_smoke's K1 checks do. It measures:

- ``optimize_ms`` / ``add_ms``: 10 iterations of ``optimize()`` and
  ``add_new_data_point()`` against chip_smoke's plant, CUDA-event ms per
  call, median of iterations 2-10;
- ``kernels``: K1 and K3 against their plain versions, CUDA-event ms per
  call over ``--reps`` calls after 2 warm-ups, on the starting state (K3
  on the first chunk of the walk);
- ``stages``: one ``safeopt_step`` on the starting state split into
  intervals, classify, expander walk and select + pack + diag pull;
  host-clock ms with a device sync after each stage, median of ``--reps``;
- ``profile``: 5 ``optimize()`` calls under ``torch.profiler``: wall ms,
  the summed duration of every CUDA kernel, their ratio (the device's
  busy share; the profiler adds host time of its own) and the kernels
  with the most device time. ``device_ms`` is null when the profiler
  recorded no kernel.

Prints one JSON object per capacity and writes them all, after the
card's ``nvidia-smi`` line, to ``--out``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BETA, FMIN, SCALING, build_gps,  # noqa: E402
                        cuda_ms, plant, timed_ms)


# capacity -> (observations, seed, spread of the observations)
CONFIGS = {64: (50, 0, 1.5), 512: (400, 512, 4.0)}


def problem(cap, grid_np):
    """A float32 SafeOpt on the card at capacity ``cap``."""
    from safeopt_torch import SafeOpt

    n_obs, seed, spread = CONFIGS[cap]
    gps = build_gps(np.random.default_rng(seed), n_obs, cap, "cuda", None,
                    spread=spread)
    return SafeOpt(gps, grid_np, fmin=FMIN, beta=BETA, scaling=SCALING,
                   expander_chunk=32)


def stage_ms(opt, reps):
    """Median host ms of each stage of one step on ``opt``'s state, plus
    the float32 K3 operands of the walk's first chunk."""
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.ops import fused_expander as fe

    kernels, states = opt._model_args()
    c = opt._step_consts()
    grid = opt._grid()
    names = ("intervals", "classify", "walk", "select_pack_pull")
    times = {name: [] for name in names}
    for _ in range(reps):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        Q, mu, sigma = core._confidence_intervals(kernels, states, grid, BETA)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        S, M, cand, width, has_safe = core._classify(
            Q, c["fmin"], c["scaling"], c["threshold"], BETA)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        G, chunks = core._find_first_expander(
            kernels, states, grid, Q, ~S, mu, sigma, c["fmin"], BETA, None,
            cand, width, opt._expander_chunk)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        idx = core._select_query(Q, S, M, G, c["scaling"], False)
        core._pack_result(Q, S, M, G, idx, has_safe, chunks).diag.tolist()
        marks.append(time.perf_counter())
        for name, t0, t1 in zip(names, marks, marks[1:]):
            times[name].append((t1 - t0) * 1e3)
    gidx = core._visit_order(torch.where(cand, width, float("-inf")), 32)
    k3_ops = fe.expander_operands(
        kernels, states, grid, ~S, mu, sigma, grid[gidx],
        Q[gidx][:, 1::2].T.clone(),
        torch.ones(32, dtype=torch.bool, device=grid.device), BETA,
        c["fmin"])
    return {name: statistics.median(v) for name, v in times.items()}, k3_ops


def profile(opt, calls=5, top=6):
    """Wall ms, summed kernel ms and the top kernels of ``calls`` steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            opt.optimize()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(per_kernel.values()) or None
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"calls": calls, "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms and device_ms / wall_ms,
            "top_kernels_ms": {name[:80]: ms for name, ms in ranked}}


def measure(cap, grid_np, reps):
    """Every measurement of one capacity, as a dict. The iterations run
    first, on a problem of their own, so that no profiler session has
    run in the process before them."""
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp

    opt = problem(cap, grid_np)
    rng = np.random.default_rng(1)
    opt_ms, add_ms, chunks = [], [], []
    for _ in range(10):
        x, ms = timed_ms(opt.optimize)
        opt_ms.append(ms)
        chunks.append(opt.stats.last.walk_chunks)
        y = plant(rng, x)
        add_ms.append(timed_ms(lambda: opt.add_new_data_point(x, y))[1])

    opt = problem(cap, grid_np)
    opt.optimize()                                   # warm-up
    stages, k3_ops = stage_ms(opt, reps)
    kernels, states = opt._model_args()
    k1_ops = fp.interval_operands(kernels, states, opt._grid(), BETA)
    result = {
        "capacity": cap, "observations": CONFIGS[cap][0],
        "kernels": {
            "K1": {"kernel_ms": cuda_ms(lambda: fp.fused_intervals(*k1_ops),
                                        reps=reps),
                   "plain_ms": cuda_ms(
                       lambda: fp.fused_intervals_plain(*k1_ops), reps=reps)},
            "K3": {"kernel_ms": cuda_ms(lambda: fe.fused_expander(*k3_ops),
                                        reps=reps),
                   "plain_ms": cuda_ms(
                       lambda: fe.fused_expander_plain(*k3_ops), reps=reps)},
        },
        "stages_ms": stages,
        "profile": profile(opt),
        "optimize_ms": statistics.median(opt_ms[1:]),
        "add_ms": statistics.median(add_ms[1:]),
        "optimize_ms_all": opt_ms, "walk_chunks": chunks,
    }
    return result


def main():
    """Measure every requested capacity; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--caps", type=int, nargs="+", default=[64, 512],
                        choices=sorted(CONFIGS))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default="chiprun_out/measure.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from safeopt_torch import linearly_spaced_combinations

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    results = []
    for cap in args.caps:
        results.append(measure(cap, grid_np, args.reps))
        print(json.dumps(results[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                               "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the PyTorch port of SafeOpt on one CUDA card, stage by stage.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/measure.py [--configs flagship cap512 context]
                                   [--reps 10]
                                   [--out chiprun_out/measure.json]
                                   [--package-root DIR]

``--package-root`` measures the ``safeopt_torch`` of another tree (for
example a parent commit, ``tools_torch/compare_trees.py``) with this
script, so that two trees go through the same measurements.

Each configuration is one of ``chip_smoke.py``'s problems in float32,
expander chunk 32:

- ``flagship``: two RBF GPs on a 1000 x 1000 grid, capacity 64 with the
  50 observations from ``default_rng(0)`` in [-1.5, 1.5]^2 (K1, K3);
- ``cap512``: the same GPs at capacity 512 with the 400 observations
  from ``default_rng(512)`` in [-4, 4]^2 (K1, K3);
- ``context``: two GPs with the contextual kernel RBF(parameter) x
  RBF(context), 240 observations at context 0, capacity 256, a 1e6-point
  parameter grid on [-3, 3] at context 0 (K2, K4).

For each it measures:

- ``optimize_ms`` / ``add_ms``: 10 iterations of ``optimize()`` and
  ``add_new_data_point()`` against chip_smoke's plant, CUDA-event ms per
  call, median of iterations 2-10;
- ``kernels``: its interval and expander kernels and the interval
  kernel's three-pass form (K1-3p, K2-3p) against their plain versions,
  CUDA-event ms per call over ``--reps`` calls after 2 warm-ups, on the
  starting state (the expander kernel on the first chunk of the walk,
  for the contextual GP 0), beside ``bound_ms``, the least time the card
  could take for the same work (``chip_smoke.interval_bound`` /
  ``expander_bound`` / ``split_bound``); beside K1, the
  multiply-adds per point and GP that K1 executes against the n(n+1)/2
  its bound counts (``chip_smoke.band_macs``), beside K3/K4 the
  multiply-adds per point and GP they execute against the C n their
  bound counts (``chip_smoke.expander_macs``), and beside K1 one FP32
  ``torch.matmul`` of an (n, n) by an (n, 65536) matrix with TF32 off:
  the rate the card's FP32 pipe reaches on the product's shapes, a
  ceiling for K1's product share (the port never calls it);
- ``stages``: one ``safeopt_step`` on the starting state split into
  intervals, classify, expander walk and select + pack + diag pull;
  host-clock ms with a device sync after each stage, median of ``--reps``;
  ``intervals_host`` is the host's part of the interval stage: the ms
  until the stage returns, before its sync (operand preparation and the
  launches, on an idle device);
- ``profile``: 5 ``optimize()`` calls under ``torch.profiler``: wall ms,
  the summed duration of every CUDA kernel, their ratio (the device's
  busy share; the profiler adds host time of its own) and the kernels
  with the most device time. ``device_ms`` is null when the profiler
  recorded no kernel.

Prints one JSON object per configuration and writes them all, after the
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

from chip_smoke import (BETA, CTX_FMIN, FMIN, SCALING,  # noqa: E402
                        band_macs, build_gps, context_gps, context_truth,
                        cuda_ms, expander_bound, expander_macs,
                        interval_bound, plan_leaves, plant, split_bound,
                        timed_ms)


# name -> (capacity, observations, seed, spread of the observations)
CONFIGS = {"flagship": (64, 50, 0, 1.5), "cap512": (512, 400, 512, 4.0),
           "context": (256, 240, 3, 3.0)}


def problem(name, grids):
    """A float32 SafeOpt on the card, its plant and its step keywords."""
    from safeopt_torch import SafeOpt

    cap, n_obs, seed, spread = CONFIGS[name]
    if name == "context":
        opt = SafeOpt(context_gps(2, n_obs, cap, "cuda", None),
                      grids["context"], fmin=CTX_FMIN, beta=BETA,
                      num_contexts=1, expander_chunk=32)
        rng = np.random.default_rng(2)
        return (opt, lambda x: (context_truth([[float(x[0]), 0.0]])
                                + 0.05 * rng.normal(size=(1, 2))),
                {"context": 0.0})
    gps = build_gps(np.random.default_rng(seed), n_obs, cap, "cuda", None,
                    spread=spread)
    rng = np.random.default_rng(1)
    return (SafeOpt(gps, grids["flagship"], fmin=FMIN, beta=BETA,
                    scaling=SCALING, expander_chunk=32),
            lambda x: plant(rng, x), {})


def stage_ms(opt, reps):
    """Median host ms of each stage of one step on ``opt``'s state, plus
    the walk's first chunk (grid indices) and the step's intermediates."""
    from safeopt_torch.algorithms import safe_opt_core as core

    kernels, states = opt._model_args()
    c = opt._step_consts()
    grid = opt._grid()
    names = ("intervals", "classify", "walk", "select_pack_pull")
    times = {name: [] for name in names + ("intervals_host",)}
    for _ in range(reps):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        Q, mu, sigma = core._confidence_intervals(kernels, states, grid, BETA)
        times["intervals_host"].append((time.perf_counter() - marks[0]) * 1e3)
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
    return ({name: statistics.median(v) for name, v in times.items()},
            (gidx, Q, S, mu, sigma, c["fmin"]))


def matmul_ceiling(n, reps, cols=1 << 16):
    """ms and TFLOP/s of one FP32 ``torch.matmul`` of (n, n) by (n,
    cols), TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((n, n), device="cuda", generator=gen)
    b = torch.randn((n, cols), device="cuda", generator=gen)
    ms = cuda_ms(lambda: torch.matmul(a, b), reps=reps)
    return {"n": n, "cols": cols, "ms": ms,
            "tflops": 2 * n * n * cols / ms / 1e9}


def kernel_times(opt, chunk, reps):
    """Interval and expander kernel vs plain ms and bounds on ``opt``'s
    state: K1/K3 for the stationary GPs, K2/K4 for the contextual GP 0."""
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp

    kernels, states = opt._model_args()
    grid = opt._grid()
    gidx, Q, S, mu, sigma, fmin = chunk
    N, d = grid.shape
    C, cap, n = gidx.shape[0], states[0].capacity, int(states[0].count)
    valid = torch.ones(C, dtype=torch.bool, device=grid.device)
    U = int((~S).sum())
    f32 = torch.float32
    if fp.supports_kernel(kernels[0], d):
        G = len(kernels)
        iv = fp.interval_operands(kernels, states, grid, BETA)
        ex = fe.expander_operands(kernels, states, grid, ~S, mu, sigma,
                                  grid[gidx], Q[gidx][:, 1::2].T.clone(),
                                  valid, BETA, fmin)
        runs = {"K1": (fp.fused_intervals, fp.fused_intervals_plain, iv,
                       interval_bound(f32, G, N, d, cap, n)),
                "K3": (fe.fused_expander, fe.fused_expander_plain, ex,
                       expander_bound(f32, G, N, U, d, cap, n, C)),
                "K1-3p": (fp.fused_intervals3, fp.fused_intervals3_plain, iv,
                          split_bound("bf16", N, d, cap, n, G=G))}
    else:
        iv = fp.interval_plan_operands(kernels[0], states[0], grid, BETA)
        ex = fe.expander_plan_operands(kernels[0], states[0], grid, ~S,
                                       mu[0], sigma[0], grid[gidx],
                                       Q[gidx, 1], valid, BETA, fmin[0])
        leaves = plan_leaves(iv[4], iv[6])
        runs = {"K2": (fp.fused_intervals_plan, fp.fused_intervals_plan_plain,
                       iv, interval_bound(f32, 1, N, d, cap, n, leaves)),
                "K4": (fe.fused_expander_plan, fe.fused_expander_plan_plain,
                       ex, expander_bound(f32, 1, N, U, d, cap, n, C, leaves)),
                "K2-3p": (fp.fused_intervals_plan3,
                          fp.fused_intervals_plan3_plain, iv,
                          split_bound("bf16", N, d, cap, n, leaves=leaves))}
    out = {key: {"kernel_ms": cuda_ms(lambda: kern(*ops), reps=reps),
                 "plain_ms": cuda_ms(lambda: plain(*ops), reps=reps),
                 "bound_ms": b[0], "bound_by": b[1]}
           for key, (kern, plain, ops, b) in runs.items()}
    interval = "K1" if "K1" in out else "K2"
    out[interval]["macs_per_point"] = {"executed": band_macs(n),
                                       "counted": n * (n + 1) // 2}
    expander = "K3" if "K3" in out else "K4"
    out[expander]["macs_per_point"] = {"executed": expander_macs(n, C, f32),
                                       "counted": C * n}
    if interval == "K1":
        out["K1"]["fp32_matmul"] = matmul_ceiling(n, reps)
    return out


def profile(opt, kw, calls=5, top=6):
    """Wall ms, summed kernel ms and the top kernels of ``calls`` steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            opt.optimize(**kw)
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


def measure(name, grids, reps):
    """Every measurement of one configuration, as a dict. The iterations
    run first, on a problem of their own, so that no profiler session
    has run in the process before them."""
    opt, plant_fn, kw = problem(name, grids)
    opt_ms, add_ms, chunks = [], [], []
    for _ in range(10):
        x, ms = timed_ms(lambda: opt.optimize(**kw))
        opt_ms.append(ms)
        chunks.append(opt.stats.last.walk_chunks)
        y = plant_fn(x)
        add_ms.append(timed_ms(lambda: opt.add_new_data_point(x, y,
                                                              **kw))[1])

    opt, _, kw = problem(name, grids)
    opt.optimize(**kw)                               # warm-up
    stages, chunk = stage_ms(opt, reps)
    return {
        "config": name, "capacity": CONFIGS[name][0],
        "observations": CONFIGS[name][1],
        "kernels": kernel_times(opt, chunk, reps),
        "stages_ms": stages,
        "profile": profile(opt, kw),
        "optimize_ms": statistics.median(opt_ms[1:]),
        "add_ms": statistics.median(add_ms[1:]),
        "optimize_ms_all": opt_ms, "walk_chunks": chunks,
    }


def main():
    """Measure every requested capacity; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS),
                        choices=list(CONFIGS))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default="chiprun_out/measure.json")
    parser.add_argument("--package-root", default=None,
                        help="a tree whose safeopt_torch is measured")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if args.package_root is not None:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
    from safeopt_torch import linearly_spaced_combinations

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    grids = {"flagship": linearly_spaced_combinations([(-5.0, 5.0),
                                                      (-5.0, 5.0)], 1000),
             "context": linearly_spaced_combinations([(-3.0, 3.0)],
                                                     1_000_000)}
    results = []
    for name in args.configs:
        results.append(measure(name, grids, args.reps))
        print(json.dumps(results[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    import safeopt_torch

    out.write_text(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                               "package": safeopt_torch.__file__,
                               "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

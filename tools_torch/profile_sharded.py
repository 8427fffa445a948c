#!/usr/bin/env python3
"""Where the sharded flagship step spends its time beyond the unsharded one.

    python3 tools_torch/profile_sharded.py [--device cuda|cpu] [--reps N]
                                           [--side S] [--trace-dir DIR]

sets up a process group of one rank (NCCL on a card, gloo on the CPU), a
(1, 1) ``make_mesh`` and chip_smoke's phase-22 flagship in float64: two
RBF GPs of 50 observations at capacity 64, the ``side`` x ``side`` grid
(1000 on the card), chunk 32. It times the sharded and the unsharded
step in turns (CUDA events on the card, medians of ``reps``), then runs
``reps`` of each under ``torch.profiler`` with a ``record_function``
span around each stage of both steps (the stages are wrapped here, at
run time; the package holds no spans). It prints, for each step, ms per
step on the host's clock inside the profiler and the device's busy time
(its kernels and copies), then
each span's calls and inclusive host ms per step, so that the sharded
step's extra host time is named stage by stage. ``--trace-dir`` writes
both Chrome traces there.
"""

import argparse
import functools
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (module, attribute) of each stage that gets a span: the unsharded
# step's, then the sharded step's (its own names for the functions it
# imports, since it calls them through those)
CORE_STAGES = ("_grid_posterior", "_decide", "_classify",
               "_find_first_expander", "_select_query")
SHARDED_STAGES = ("_setup", "_full_states", "_grid_posterior", "_classify",
                  "_walk", "_offer", "merge_order", "_predicates",
                  "_first_max", "_result", "_stats", "_gather")
SHARDS_METHODS = ("__init__", "valid", "reduce", "sharded")


def _span(name, fn):
    import torch

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


def instrument():
    """Wrap every stage of both steps in a span named after it."""
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.parallel import sharded_step as ss

    for name in CORE_STAGES:
        if hasattr(core, name):
            setattr(core, name, _span(f"core.{name}", getattr(core, name)))
    for name in SHARDED_STAGES:
        setattr(ss, name, _span(f"sharded.{name}", getattr(ss, name)))
    for name in SHARDS_METHODS:
        setattr(ss._Shards, name, _span(f"sharded._Shards.{name}",
                                        getattr(ss._Shards, name)))


def profile(fn, reps, label, trace_dir):
    """``reps`` calls of ``fn`` under the profiler: (host ms a step,
    device ms a step, {span: (calls, host ms) a step})."""
    import time

    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            with torch.profiler.record_function(label):
                fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host = (time.perf_counter() - start) * 1e3 / reps
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"{label}.trace.json"))
    # the raw events, not key_averages(): a span that launches device
    # work also has a device-side annotation of its name, which the
    # averages would merge with the host-side range
    from torch.autograd import DeviceType

    spans, device = {}, 0.0
    names = ("core.", "sharded.")
    for evt in prof.events():
        us = evt.time_range.elapsed_us()
        if evt.device_type == DeviceType.CPU and evt.name.startswith(names):
            calls, total = spans.get(evt.name, (0, 0.0))
            spans[evt.name] = (calls + 1, total + us)
        elif (evt.device_type == DeviceType.CUDA
              and not evt.name.startswith(names) and evt.name != label):
            device += us
    return host, device / 1e3 / reps, {
        k: (calls / reps, total / 1e3 / reps)
        for k, (calls, total) in spans.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--side", type=int, default=None)
    parser.add_argument("--trace-dir", default=None)
    args = parser.parse_args()
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.algorithms.safe_opt_core import safeopt_step
    from safeopt_torch.parallel import (make_mesh, replicate, shard_grid,
                                        shard_state)
    from tools_torch.states import BETA, build_gps

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("profile_sharded: no CUDA device", file=sys.stderr)
        return 1
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        if cuda:
            from safeopt_torch.ops._build import library
            library()
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        else:
            smi = "CPU"
        dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
        dtype = torch.float64
        side = args.side or (1000 if cuda else 60)
        grid = torch.tensor(linearly_spaced_combinations(
            [(-5.0, 5.0), (-5.0, 5.0)], side), dtype=dtype, device=dev)
        gps = build_gps(np.random.default_rng(0), 50, 64, dev, dtype)
        kernels = tuple(g.kern for g in gps)
        states = tuple(g.state for g in gps)
        t = functools.partial(torch.tensor, dtype=dtype, device=dev)
        a = (t(cs.FMIN), BETA, t(cs.SCALING), t([0.0, 0.0]))
        mesh = make_mesh(device_type=args.device)
        sgrid, _ = shard_grid(grid, mesh)
        sstates = tuple(shard_state(st, mesh) for st in states)
        sargs = replicate(a, mesh)
        steps = {
            "unsharded": lambda: safeopt_step(kernels, states, grid, *a,
                                              chunk=32),
            "sharded": lambda: safeopt_step(kernels, sstates, sgrid, *sargs,
                                            num_valid=grid.shape[0],
                                            chunk=32)}
        for fn in steps.values():
            fn()
        ms = {k: [] for k in steps}
        for _ in range(args.reps):
            for k, fn in steps.items():
                if cuda:
                    ms[k].append(cs.timed_ms(fn)[1])
                else:
                    import time
                    start = time.perf_counter()
                    fn()
                    ms[k].append((time.perf_counter() - start) * 1e3)
        print(f"profile_sharded ({smi}), flagship float64, {side}^2 grid, "
              f"mesh (1, 1), {args.reps} steps each:", flush=True)
        print("  unprofiled, in turns, medians: " + ", ".join(
            f"{k} {np.median(v):.3f} ms" for k, v in ms.items()),
            flush=True)
        instrument()
        for k, fn in steps.items():
            fn()                                     # warm the spans
            host, device, spans = profile(fn, args.reps, k, args.trace_dir)
            print(f"  {k} under the profiler: {host:.3f} ms a step on the "
                  f"host's clock, device {device:.3f} ms a step", flush=True)
            for name, (calls, cpu) in sorted(spans.items(),
                                             key=lambda kv: -kv[1][1]):
                print(f"    {name}: {calls:g} calls, {cpu:.3f} ms "
                      "(inclusive host time a step)", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

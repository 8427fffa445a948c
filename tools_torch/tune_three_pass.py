#!/usr/bin/env python3
"""Time build variants of the float32 wgmma K1-3p and K2-3p on one CUDA
card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/tune_three_pass.py [--reps 5]
        [--only default no_gram ...] [--states cap512 cap2048 ...]
        [--root TREE] [--out chiprun_out/tune3.json]

Each variant in ``VARIANTS`` is a copy of the ``safeopt_torch/ops/csrc``
of ``--root`` (default: this tree; ``build/compare/parent`` after
``tools_torch/compare_trees.py unpack REV`` measures a parent) under
``build/tune3_src/<name>/`` with its bodies patched: the resident body's
consumer warpgroups and factor chunks in flight per ring (``kGroups3``,
``kStages3``), the tiled body's warpgroups (``groups3``: three, bands of
three tiles; ``kGroups3t``), or, in the ablations, one stage of both
bodies taken out (their rows are wrong by design; only their times
count): ``no_gram`` computes no gram (the resident body's resident rows
and its chunks past them, the tiled body's steps), ``no_loads`` arrives
on the ring barriers without copying the factor, ``no_product`` issues
no wgmma and ``one_pass`` issues the first of the three limb products
only. A patch whose file the tree lacks (a parent without ``intervals3_tiled.cuh``) is skipped; the
patches match the text of the bodies templated on their limb format
(``Limbs3``), and a tree from before that template stops with "patch not
found". The
time that goes when a stage goes is that stage's share. Each variant
builds ``fused_intervals3.cu`` alone (one nvcc each, all started
together) and is timed in float32 on each state of ``STATES``: K1-3p on
chip_smoke's cap-512 state (two RBF GPs, 400 observations), on
``measure.py``'s ``cap1024`` (one GP, 600 observations) and ``cap2048``
(the exact GP, 2000 observations) over the 1e6-point flagship grid,
K2-3p on GP 0 of ``context1024`` and ``context2048`` (600 and 2000
observations over contexts in [-1, 1]) over the 1e6-point parameter grid
at context 0: CUDA-event ms per call over ``--reps`` calls after two
warm-ups, each variant twice in turns, beside its kernels' registers and
spills (ptxas), their HGMMA counts (SASS), its largest ratio to the
float32 bound of the plain version, the body the capacity takes
(``fused_posterior.three_pass_body``), the state's bound
(``chip_smoke.split_bound``) and the factor's bytes a launch streams
from L2 (``chip_smoke.three_pass_l2_bytes``). Prints the card's
``nvidia-smi`` line first and one JSON object per variant, and writes
them all to ``--out``.
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

from chip_smoke import (context_gps, plan_leaves, split_bound,  # noqa: E402
                        three_pass_l2_bytes)
from tools_torch.states import (BETA, build_gps, cap512_operands,  # noqa: E402
                                cuda_ms, sparse_exact_gp)
from tools_torch.variants import (build_all, load_entries,  # noqa: E402
                                  patched_copy, ptxas_usage)

H = "intervals3.cuh"
T = "intervals3_tiled.cuh"
# the gram's calls: this tree's (with the experiment B3-3p's sum of u k),
# then a parent's from before it
_GRAM = ("    fill_gram3_d<L>(ghi, glo, I.xs, zs, 0, 0, rows / L::kCoreK * "
         "kP3, n, d,\n                    I.gram, ct, kCons, "
         "usum.only(true));\n",
         "    fill_gram3_d<L>(ghi, glo, I.xs, zs, 0, 0, rows / L::kCoreK * "
         "kP3, n, d,\n                    I.gram, ct, kCons);\n")
_GRAM_PAST = ("          fill_gram3_d<L>(shi, slo, I.xs, zs, k0 / L::kCoreK, "
              "0,\n                          L::kKC / L::kCoreK * kP3, n, d, "
              "I.gram, ct & 127,\n                          128, "
              "usum.only(m == k0 / kTM3));\n",
              "          fill_gram3_d<L>(shi, slo, I.xs, zs, k0 / L::kCoreK, "
              "0,\n                          L::kKC / L::kCoreK * kP3, n, d, "
              "I.gram, ct & 127,\n                          128);\n")
_GRAM_TILED = ("      gram_task3t_d<L>(h, h + kStepBytes3t, I.xs, zs, k0, "
               "wg + C * i,\n                       ct & (kP3t - 1), bend, d, "
               "I.gram,\n                       usum.only(band == nb - 1));\n",
               "      gram_task3t_d<L>(h, h + kStepBytes3t, I.xs, zs, k0, "
               "wg + C * i,\n                       ct & (kP3t - 1), bend, d, "
               "I.gram);\n")
_LOAD = ("          mbar_expect_tx(f + s, L::kLanded);\n"
         "          bulk_load(buf + (size_t)s * kChunkBytes3,\n"
         "                    src + (size_t)(k0 / L::kKC) * L::kLanded, "
         "L::kLanded,\n                    f + s);\n")
_NO_LOAD = "          mbar_arrive(f + s);\n"
_PRODUCT = ("            wg_mma<L>(acc, ahi + o, bhi + o);\n"
            "            wg_mma<L>(acc, ahi + o, blo + o);\n"
            "            wg_mma<L>(acc, alo + o, bhi + o);\n")
_PRODUCT_TILED = ("      wg_mma<L>(acc, ahi + oa, bhi + ob);\n"
                  "      wg_mma<L>(acc, ahi + oa, blo + ob);\n"
                  "      wg_mma<L>(acc, alo + oa, bhi + ob);\n")
_LOAD_TILED = ("      mbar_expect_tx(f + st, L::kLanded);\n"
               "      bulk_load(buf + (size_t)st * kChunkBytes3, cursor.src(), "
               "L::kLanded,\n                f + st);\n")
_NO_LOAD_TILED = "      mbar_arrive(f + st);\n"


def first_pass(text):
    """The first of three product lines alone."""
    return text.splitlines(True)[0]


def shape(groups, stages):
    """Patches setting the consumer warpgroups and chunks in flight."""
    return [(H, "constexpr int kGroups3 = 3;",
             f"constexpr int kGroups3 = {groups};"),
            (H, "constexpr int kStages3 = 3;",
             f"constexpr int kStages3 = {stages};")]


# name -> [(source file, old text or a tuple of alternatives, new text)]
VARIANTS = {
    "default": [],
    "groups2_stages4": shape(2, 4),
    "groups4_stages2": shape(4, 2),
    "no_gram": [(H, _GRAM, ""), (H, _GRAM_PAST, ""), (T, _GRAM_TILED, "")],
    "no_loads": [(H, _LOAD, _NO_LOAD), (T, _LOAD_TILED, _NO_LOAD_TILED)],
    "no_loads_no_gram": [(H, _GRAM, ""), (H, _GRAM_PAST, ""),
                         (T, _GRAM_TILED, ""), (H, _LOAD, _NO_LOAD),
                         (T, _LOAD_TILED, _NO_LOAD_TILED)],
    "no_product": [(H, _PRODUCT, ""), (T, _PRODUCT_TILED, "")],
    "one_pass": [(H, _PRODUCT, first_pass(_PRODUCT)),
                 (T, _PRODUCT_TILED, first_pass(_PRODUCT_TILED))],
    # the tiled body with three warpgroups a block: bands of three tiles
    "groups3": [(T, "constexpr int kGroups3t = 4;",
                 "constexpr int kGroups3t = 3;")],
}
# the kernels whose ptxas lines and HGMMA counts are reported
KERNELS = ("intervals3_wg_kernelILi3E", "intervals3_tiled_kernel",
           "intervals_plan3_wg_kernelILi3ELb0E",
           "intervals_plan3_tiled_kernelILb0E")


def states(names):
    """{name: (wrapper, plain, operands, capacity, count, bound, bound_by)}
    of the float32 states ``names``."""
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops import fused_posterior as fp

    f32 = torch.float32
    flag = torch.tensor(linearly_spaced_combinations(
        [(-5.0, 5.0), (-5.0, 5.0)], 1000), dtype=f32, device="cuda")
    params = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)
    ctx = torch.tensor(np.hstack([params, np.zeros_like(params)]), dtype=f32,
                       device="cuda")
    N = flag.shape[0]
    out = {}
    for name in names:
        if name.startswith("context"):
            cap, n_obs = {"context1024": (1024, 600),
                          "context2048": (2048, 2000)}[name]
            gp = context_gps(1, n_obs, cap, "cuda", f32,
                             spread_contexts=True)[0]
            ops = fp.interval_plan_operands(gp.kern, gp.state, ctx, BETA)
            out[name] = (fp.fused_intervals_plan3,
                         fp.fused_intervals_plan3_plain, ops, cap, n_obs,
                         *split_bound("bf16", N, 2, cap, n_obs,
                                      leaves=plan_leaves(ops[4], ops[6])))
            continue
        if name == "cap512":
            ops, G, cap, n_obs = cap512_operands(f32), 2, 512, 400
        else:
            if name == "cap1024":
                gps = build_gps(np.random.default_rng(1024), 600, 1024,
                                "cuda", f32, spread=4.0)[:1]
            else:
                gps = [sparse_exact_gp("cuda", f32)]
            ops = fp.interval_operands([g.kern for g in gps],
                                       [g.state for g in gps], flag, BETA)
            G, cap, n_obs = 1, ops[2].shape[1], int(gps[0].state.count)
        out[name] = (fp.fused_intervals3, fp.fused_intervals3_plain, ops,
                     cap, n_obs, *split_bound("bf16", N, 2, cap, n_obs, G=G))
    return out


STATES = ("cap512", "cap1024", "cap2048", "context1024", "context2048")


def build(names, csrc):
    """{name: (library path, {kernel: ptxas line}, nvcc log)}, built in
    parallel from patched copies of ``csrc``."""
    base = ROOT / "build" / "tune3_src"
    try:
        built = build_all({
            name: (patched_copy(base / name, VARIANTS[name], csrc,
                                skip_missing=True), ["fused_intervals3.cu"])
            for name in names})
    except ValueError as err:
        raise SystemExit(str(err))
    out = {}
    for name, (so, log) in built.items():
        if so is None:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        usage = {k: v for k, v in ptxas_usage(log).items()
                 if any(kern in k for kern in KERNELS)}
        out[name] = (so, usage, log)
    return out


def load(so):
    """The K1-3p and K2-3p entry points of a library built from
    ``fused_intervals3.cu`` alone, as the wrappers call them."""
    return load_entries(so, ("safeopt_intervals3_f32",
                             "safeopt_intervals_plan3_f32"))


def main():
    """Build, check and time the variants; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--only", nargs="*", default=list(VARIANTS))
    parser.add_argument("--states", nargs="*", default=list(STATES),
                        choices=STATES)
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--out", default="chiprun_out/tune3.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_three_pass: no CUDA card", file=sys.stderr)
        return 1
    from safeopt_torch.ops import _build
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    built = build(args.only, Path(args.root) / "safeopt_torch" / "ops"
                  / "csrc")
    cases = states(args.states)
    checks = {}
    for name, (kern, plain, ops, cap, n, b_ms, b_by) in cases.items():
        plan = kern is fp.fused_intervals_plan3
        bound = (ie.float32_bound_plan(*ops) if plan
                 else ie.float32_bound(*ops, "split", limb="bf16"))
        body = fp.three_pass_body(cap)
        checks[name] = (plain(*ops).double(), bound)
        print(json.dumps({
            "state": name, "capacity": cap, "count": n, "body": body,
            "bound_ms": b_ms, "bound_by": b_by,
            "l2_bytes": three_pass_l2_bytes(ops[0].shape[1], n, body,
                                            G=1 if plan else ops[2].shape[0])
        }), flush=True)
    runs = {}
    for name, (so, usage, _) in built.items():
        _build._lib = load(so)
        hgmma = {k: v for k, v in _build.sass_opcodes("HGMMA", so).items()
                 if any(kern in k for kern in KERNELS)}
        r = {"variant": name, "ptxas": usage, "hgmma": hgmma,
             "bound_ratio": {}, "ms": {s: [] for s in cases}, "lib": so}
        for state, (kern, _, ops, *_) in cases.items():
            want, bound = checks[state]
            r["bound_ratio"][state] = ((kern(*ops).double() - want).abs()
                                       / bound).max().item()
        runs[name] = r
    for _ in range(2):       # every variant twice, in turns
        for name, r in runs.items():
            _build._lib = load(r["lib"])
            for state, (kern, _, ops, *_) in cases.items():
                r["ms"][state].append(cuda_ms(lambda: kern(*ops),
                                              reps=args.reps))
    results = []
    for r in runs.values():
        r["lib"] = str(r["lib"])
        print(json.dumps(r), flush=True)
        results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"nvidia_smi": smi,
                                          "root": args.root,
                                          "variants": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time build variants of the tiled interval body
(``csrc/intervals_tiled.cuh``: K1's, and K2's with the plan gram) on one
CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/tune_tiled.py [--only shipped rows128 ...]
                                      [--reps 5]
                                      [--out chiprun_out/tune_tiled.json]

Each variant in ``VARIANTS`` is a copy of ``safeopt_torch/ops/csrc``
under ``build/tune_tiled/<name>`` with text of ``intervals_tiled.cuh``,
``fused_intervals.cu`` or ``fused_intervals_plan.cu`` replaced;
``fused_intervals.cu`` (and, for the variants in ``PLAN``,
``fused_intervals_plan.cu``) is built into one library with the
package's nvcc flags, every variant at once, and the wrappers of
``ops/fused_posterior.py`` launch it. ``shipped`` is the sources as
they are; ``rows128`` the first design (128-row tiles, 128 points a
block); ``stages4`` a ring of four steps; ``threads512`` one block of
512 threads an SM (128 points a block); ``everywhere`` takes the tiled
body at every capacity (K1 and K2), so that it is timed beside the
resident body at caps 64, 256 and 512; ``resident`` takes the resident
body at every capacity (K1 and K2: the body both ran past the resident
rows before the tiled one); ``plan_by_list`` has the plan gram of
the tiled body read each leaf's columns through its column list
(``PlanGram::rows``, as the resident body does) instead of
``PlanGram::rows_d``. ``ABLATIONS`` take one stage out of the
tiled body (their rows are wrong by design; only their times count):
``no_gram`` writes a constant for the gram, ``no_product`` skips every
FMA of the product.

For each variant, on K1's float32 states of ``tools_torch/measure.py``
(the flagship at cap 64 and cap 512, two GPs each; cap 1024 with 600
observations and the exact GP at cap 2048 with 2000, one GP each; a
1000 x 1000 grid) and, for the variants in ``PLAN``, on K2's (GP 0 of
measure.py's ``context``, ``context1024`` and ``context2048``: the
contextual kernel at cap 256, 1024 and 2048, the 1e6-point contextual
grid at context 0), it reports ptxas's registers and spills, the
largest float64 distance from the plain version on the cap-1024 and
cap-2048 states (variants only), and the CUDA-event ms of a launch,
mean of ``--reps`` after 2 warm-ups, beside ``chip_smoke.interval_bound``
and its share. Beside the timings of a launch on the tiled body it
prints, from its tile sizes and the state, what bounds it: the FMAs a
point executes and the FP32 pipe's share they reach (at the card's 67
TFLOP/s), the bytes a launch stages from L2, and the gram entries a
point computes. ``shipped`` and ``resident`` also time the float64 K1
at caps 512, 1024 and 2048 beside its bound; the float64 plain version
is timed once. Once, at cap 2048: the float32 plain version, and the
product alone: one FP32 ``torch.matmul`` of the (2048, 2048) factor by
the gram of 65,536 grid points, TF32 off (a reference for the product's
rate, not a call the port makes).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools_torch"))

from chip_smoke import (BETA, PEAK_FLOPS, context_gps,  # noqa: E402
                        interval_bound, plan_leaves)
from states import build_gps, cuda_ms, sparse_exact_gp  # noqa: E402
from variants import (build_all, load_entries,  # noqa: E402
                      patched_copy, ptxas_usage)

TILED = "intervals_tiled.cuh"
LAUNCH = "fused_intervals.cu"
PLAN_LAUNCH = "fused_intervals_plan.cu"
RULE = "if (!three_pass && lay.res < cap)"


def _set(name, old, new, src=TILED):
    """A patch of ``src`` that sets the constant ``name`` to ``new``."""
    return (src, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


VARIANTS = {
    "shipped": [],
    "rows128": [_set("kTileR", 256, 128)],
    "stages4": [_set("kTileStages", 3, 4)],
    "threads512": [_set("kTileThreads", 256, 512),
                   _set("kTiledMinBlocks", 2, 1)],
    "everywhere": [(LAUNCH, RULE, "if (!three_pass)"),
                   (PLAN_LAUNCH, RULE, "if (!three_pass)")],
    "resident": [(LAUNCH, RULE, "if (false)"),
                 (PLAN_LAUNCH, RULE, "if (false)")],
    "plan_by_list": [(TILED, "tile_rows<D>(gram, v, x, zs, p, dd, kTileP);",
                      "gram.rows(v, x, zs, p, dd, kTileP);")],
}
ABLATIONS = {
    "no_gram": [(TILED, "tile_rows<D>(gram, v, x, zs, p, dd, kTileP);",
                 "for (int r = 0; r < R; ++r) v[r] = zs[p] * T(1e-3);")],
    "no_product": [(TILED, "if (q * kTileK < wend)",
                    "if (q * kTileK < wend && n < 0)")],
}
# (rows of a row tile, points of a block) of each variant that keeps the
# tiled body
TILES = {"shipped": (256, 64), "rows128": (128, 128), "stages4": (256, 64),
         "threads512": (256, 128), "everywhere": (256, 64),
         "plan_by_list": (256, 64)}
STEP = 16                       # columns of a step
# the variants that also build and time K2 (the plan stages over
# kThreads, so threads512 does not build it)
PLAN = ("shipped", "everywhere", "resident", "plan_by_list", "no_gram",
        "no_product")
# the variants that also time the float64 K1 at caps 512, 1024 and 2048
FLOAT64 = ("shipped", "resident")


def build(todo):
    """{name: (library path or None, ptxas log)} of the variants ``todo``
    ({name: patches}), every one at once."""
    return build_all({
        name: (patched_copy(ROOT / "build" / "tune_tiled" / name, patches),
               [LAUNCH] + ([PLAN_LAUNCH] if name in PLAN else []))
        for name, patches in todo.items()})


def load(so, plan):
    """The variant's K1 (and, with ``plan``, K2) C entries, for the
    wrappers."""
    names = ["safeopt_intervals_f32", "safeopt_intervals_f64"]
    if plan:
        names += ["safeopt_intervals_plan_f32", "safeopt_intervals_plan_f64"]
    return load_entries(so, names)


def states(grid):
    """{name: {dtype: K1's operands}} of the four states."""
    from safeopt_torch.ops import fused_posterior as fp

    def ops(gps, dtype):
        return fp.interval_operands([g.kern for g in gps],
                                    [g.state for g in gps], grid.to(dtype),
                                    BETA)

    out = {}
    for name, (n_obs, cap, seed, spread, G) in {
            "cap64": (50, 64, 0, 1.5, 2), "cap512": (400, 512, 512, 4.0, 2),
            "cap1024": (600, 1024, 1024, 4.0, 1)}.items():
        out[name] = {dt: ops(build_gps(np.random.default_rng(seed), n_obs,
                                       cap, "cuda", dt, spread=spread)[:G],
                             dt)
                     for dt in (torch.float32, torch.float64)}
    out["cap2048"] = {dt: ops([sparse_exact_gp("cuda", dt)], dt)
                      for dt in (torch.float32, torch.float64)}
    return out


def plan_states(grid):
    """{name: K2's float32 operands} of GP 0 of measure.py's contextual
    states on the contextual ``grid`` (parameter, context 0)."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {}
    for name, n_obs, cap, spread in (("context", 240, 256, False),
                                     ("context1024", 600, 1024, True),
                                     ("context2048", 2000, 2048, True)):
        gp = context_gps(1, n_obs, cap, "cuda", torch.float32,
                         spread_contexts=spread)[0]
        out[name] = fp.interval_plan_operands(gp.kern, gp.state, grid, BETA)
    return out


def executed_fmas(n):
    """FMAs a point executes: a warp's 32 rows take the steps below
    min(its last row + 1, n)."""
    return sum(32 * -(-min(r + 32, n) // STEP) * STEP
               for r in range(0, n, 32))


def tiled_costs(n, cap, N, rows, points, size):
    """(gram entries a point, bytes a launch stages from L2) of the tiled
    body with row tiles of ``rows`` and ``points`` a block: each row tile
    computes the gram of the columns below its end and stages those
    columns of its rows (rows past the factor's stride land as zeros)."""
    ldl = -(-cap // 32) * 32
    gram, per_block = 0, 0
    for r0 in range(0, n, rows):
        kend = min(r0 + rows, n)
        gram += kend
        per_block += -(-kend // STEP) * STEP * min(rows, ldl - r0) * size
    return gram, -(-N // points) * per_block


def tiled_row(name, ms, G, N, n, cap, tiled):
    """What bounds a launch on the tiled body (``tiled``) of ``name``'s
    tiles: the FMAs a point executes and the FP32 pipe's share, the bytes
    staged from L2, the gram entries a point."""
    if name not in TILES or not tiled:
        return {}
    rows, points = TILES[name]
    fmas = executed_fmas(n)
    gram, l2 = tiled_costs(n, cap, N, rows, points, 4)
    return dict(executed_fmas_per_point=fmas,
                fp32_pipe_share=2 * G * N * fmas / (ms * 1e-3)
                / PEAK_FLOPS[torch.float32],
                l2_bytes=G * l2, gram_entries_per_point=gram)


def time_plan(name, plan_all, reps):
    """K2's float32 timings of the variant on ``plan_states``."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {}
    for key, o in plan_all.items():
        cap, d = o[1].shape
        N, n = o[0].shape[1], int(o[7][3])
        ms = cuda_ms(lambda: fp.fused_intervals_plan(*o), reps=reps)
        b_ms, b_by = interval_bound(torch.float32, 1, N, d, cap, n,
                                    plan_leaves(o[4], o[6]))
        row = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
               "share": b_ms / ms,
               **tiled_row(name, ms, 1, N, n, cap,
                           name != "resident"
                           and (cap > 512 or name == "everywhere"))}
        out[key] = row
        print(f"{name} K2 {key}: {json.dumps(row)}", flush=True)
    return out


def time_float64(name, ops_all, reps):
    """The float64 K1's ms of the variant at caps 512, 1024 and 2048."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {}
    for key in ("cap512", "cap1024", "cap2048"):
        o = ops_all[key][torch.float64]
        G, cap, d = o[2].shape
        N, n = o[0].shape[1], int(o[5][0, 3])
        ms = cuda_ms(lambda: fp.fused_intervals(*o), reps=reps)
        b_ms, b_by = interval_bound(torch.float64, G, N, d, cap, n)
        out[key] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                    "share": b_ms / ms}
        print(f"{name} float64 K1 {key}: {json.dumps(out[key])}", flush=True)
    return out


def time_variant(name, ops_all, reps, check):
    """The variant's K1 timings (and, with ``check``, its errors)."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {"ms": {}}
    if check:
        out["max_abs_err_f64"] = {}
        for key in ("cap1024", "cap2048"):
            o = ops_all[key][torch.float64]
            err = (fp.fused_intervals(*o)
                   - fp.fused_intervals_plain(*o)).abs().max().item()
            out["max_abs_err_f64"][key] = err
    for key, by_dtype in ops_all.items():
        o = by_dtype[torch.float32]
        G, cap, d = o[2].shape
        N, n = o[0].shape[1], int(o[5][0, 3])
        ms = cuda_ms(lambda: fp.fused_intervals(*o), reps=reps)
        b_ms, b_by = interval_bound(torch.float32, G, N, d, cap, n)
        row = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
               "share": b_ms / ms,
               **tiled_row(name, ms, G, N, n, cap,
                           name != "resident"
                           and (cap > 512 or name == "everywhere"))}
        out["ms"][key] = row
        print(f"{name} {key}: {json.dumps(row)}", flush=True)
    return out


def reference(ops_all, plan_all):
    """The float32 plain versions of K1 at cap 2048 and of K2 at its
    states, the float64 plain K1 at caps 512, 1024 and 2048, and the
    product alone at cap 2048."""
    from safeopt_torch.ops import fused_posterior as fp

    o32, o64 = ops_all["cap2048"][torch.float32], ops_all["cap2048"][
        torch.float64]
    zt, ils, xs, lm, w, scal, kind = o32
    cols = 1 << 16
    gram = fp.gram(kind, xs[0], zt[:, :cols] * ils[0][:, None], scal[0, 0])
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = cuda_ms(lambda: torch.matmul(lm[0], gram), reps=10)
    cap = lm.shape[-1]
    return {"plain_ms": cuda_ms(lambda: fp.fused_intervals_plain(*o32),
                                reps=3),
            "plan_plain_ms": {
                key: cuda_ms(lambda: fp.fused_intervals_plan_plain(*o),
                             reps=3)
                for key, o in plan_all.items()},
            "f64_plain_ms": {
                key: cuda_ms(lambda: fp.fused_intervals_plain(
                    *ops_all[key][torch.float64]), reps=3)
                for key in ("cap512", "cap1024", "cap2048")},
            "product_alone": {"shape": [cap, cap, cols], "ms": ms,
                              "tflops": 2 * cap * cap * cols / ms / 1e9}}


def main():
    """Build and time every requested variant; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", default=None)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", default="chiprun_out/tune_tiled.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_tiled: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    todo = {k: v for k, v in {**VARIANTS, **ABLATIONS}.items()
            if args.only is None or k in args.only}
    start = time.perf_counter()
    built = build(todo)
    print(f"built {len(built)} variants in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    grid = torch.tensor(linearly_spaced_combinations([(-5.0, 5.0),
                                                      (-5.0, 5.0)], 1000),
                        dtype=torch.float64, device="cuda")
    ops_all = states(grid)
    ctx = torch.tensor(linearly_spaced_combinations([(-3.0, 3.0)],
                                                    1_000_000),
                       dtype=torch.float32, device="cuda")
    plan_all = plan_states(torch.cat([ctx, torch.zeros_like(ctx)], dim=1))
    results, rc, libs = {}, 0, {}
    for name, (so, log) in built.items():
        usage = {k: v for k, v in ptxas_usage(log).items()
                 if "tiled_kernel" in k}
        if so is None:
            print(f"{name}: build failed\n{log[-4000:]}", flush=True)
            results[name] = {"build_failed": log[-4000:]}
            rc = 1
            continue
        _build._lib = libs[name] = load(so, name in PLAN)
        results[name] = {"ptxas": usage,
                         **time_variant(name, ops_all, args.reps,
                                        name in VARIANTS)}
        if name in PLAN:
            results[name]["K2"] = time_plan(name, plan_all, args.reps)
        if name in FLOAT64:
            results[name]["float64_K1"] = time_float64(name, ops_all, 3)
    if "shipped" in libs:
        _build._lib = libs["shipped"]
        results["reference"] = reference(ops_all, plan_all)
        print(f"reference: {json.dumps(results['reference'])}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "results": results},
                              indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())

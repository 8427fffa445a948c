#!/usr/bin/env python3
"""Time build variants of K1's tiled body (``csrc/intervals_tiled.cuh``)
on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/tune_tiled.py [--only shipped rows128 ...]
                                      [--reps 5]
                                      [--out chiprun_out/tune_tiled.json]

Each variant in ``VARIANTS`` is a copy of ``safeopt_torch/ops/csrc``
under ``build/tune_tiled/<name>`` with text of ``intervals_tiled.cuh``
or ``fused_intervals.cu`` replaced; only ``fused_intervals.cu`` is
built (with the package's nvcc flags, every variant at once), and the
wrappers of ``ops/fused_posterior.py`` launch it. ``shipped`` is the
sources as they are; ``rows128`` the first design (128-row tiles, 128
points a block); ``stages4`` a ring of four steps; ``threads512`` one
block of 512 threads an SM (128 points a block); ``everywhere`` takes
the tiled body at every capacity, so that it is timed beside the
resident body at caps 64 and 512. ``ABLATIONS`` take one stage out of
the body (their rows are wrong by design; only their times count):
``no_gram`` writes a constant for the gram, ``no_product`` skips every
FMA of the product.

For each variant, on K1's float32 states of ``tools_torch/measure.py``
(the flagship at cap 64 and cap 512, two GPs each; cap 1024 with 600
observations and the exact GP at cap 2048 with 2000, one GP each; a
1000 x 1000 grid), it reports ptxas's registers and spills, the
largest float64 distance from the plain version on the cap-1024 and
cap-2048 states (variants only), and the CUDA-event ms of a launch,
mean of ``--reps`` after 2 warm-ups, beside ``chip_smoke.interval_bound``
and its share. Beside the timings of a variant that keeps the tiled
layout it prints, from its tile sizes and the state, what bounds it:
the FMAs a point executes and the FP32 pipe's share they reach (at the
card's 67 TFLOP/s), the bytes a launch stages from L2, and the gram
entries a point computes. Once, at cap 2048: the plain version, the
shipped float64 K1, and the product alone: one FP32 ``torch.matmul``
of the (2048, 2048) factor by the gram of 65,536 grid points, TF32 off
(a reference for the product's rate, not a call the port makes).
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools_torch"))

from chip_smoke import BETA, PEAK_FLOPS, interval_bound  # noqa: E402
from states import build_gps, cuda_ms, sparse_exact_gp  # noqa: E402
from tune_intervals import ptxas_usage  # noqa: E402

TILED = "intervals_tiled.cuh"
LAUNCH = "fused_intervals.cu"


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
    "everywhere": [(LAUNCH, "if (!three_pass && lay.res < cap)",
                    "if (!three_pass)")],
}
ABLATIONS = {
    "no_gram": [(TILED, "gram.rows(v, x, zs, p, dd, kTileP);",
                 "for (int r = 0; r < R; ++r) v[r] = zs[p] * T(1e-3);")],
    "no_product": [(TILED, "if (q * kTileK < wend)",
                    "if (q * kTileK < wend && n < 0)")],
}
# (rows of a row tile, points of a block) of each variant that keeps the
# tiled body
TILES = {"shipped": (256, 64), "rows128": (128, 128), "stages4": (256, 64),
         "threads512": (256, 128), "everywhere": (256, 64)}
STEP = 16                       # columns of a step


def build(name, patches):
    """(name, library path or None, ptxas log) of one variant."""
    src = ROOT / "safeopt_torch" / "ops" / "csrc"
    out = ROOT / "build" / "tune_tiled" / name
    subprocess.run(["rm", "-rf", str(out)], check=True)
    out.mkdir(parents=True)
    for f in src.iterdir():
        text = f.read_text()
        for fname, old, new in patches:
            if f.name == fname:
                if old not in text:
                    raise ValueError(f"{name}: {old!r} not in {fname}")
                text = text.replace(old, new)
        (out / f.name).write_text(text)
    from safeopt_torch.ops import _build

    so = out / "lib.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o",
                           str(so), str(out / LAUNCH)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    return name, (so if proc.returncode == 0 else None), log


def load(so):
    """The variant's library with K1's C signatures."""
    from safeopt_torch.ops import _build

    lib = ctypes.CDLL(str(so))
    for name in ("safeopt_intervals_f32", "safeopt_intervals_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.safeopt_error_string.argtypes = [ctypes.c_int]
    lib.safeopt_error_string.restype = ctypes.c_char_p
    return lib


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


def time_variant(name, ops_all, reps, check):
    """The variant's timings (and, with ``check``, its errors)."""
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
               "share": b_ms / ms}
        if name in TILES and (cap > 512 or name == "everywhere"):
            rows, points = TILES[name]
            fmas = executed_fmas(n)
            gram, l2 = tiled_costs(n, cap, N, rows, points, 4)
            row.update(executed_fmas_per_point=fmas,
                       fp32_pipe_share=2 * G * N * fmas / (ms * 1e-3)
                       / PEAK_FLOPS[torch.float32],
                       l2_bytes=G * l2, gram_entries_per_point=gram)
        out["ms"][key] = row
        print(f"{name} {key}: {json.dumps(row)}", flush=True)
    return out


def reference(ops_all):
    """The plain version, the shipped float64 K1 and the product alone at
    cap 2048."""
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
            "f64_ms": cuda_ms(lambda: fp.fused_intervals(*o64), reps=3),
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
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(lambda kv: build(*kv), todo.items()))
    print(f"built {len(built)} variants in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    grid = torch.tensor(linearly_spaced_combinations([(-5.0, 5.0),
                                                      (-5.0, 5.0)], 1000),
                        dtype=torch.float64, device="cuda")
    ops_all = states(grid)
    results, rc, libs = {}, 0, {}
    for name, so, log in built:
        usage = {k: v for k, v in ptxas_usage(log).items()
                 if "intervals_tiled_kernel" in k}
        if so is None:
            print(f"{name}: build failed\n{log[-4000:]}", flush=True)
            results[name] = {"build_failed": log[-4000:]}
            rc = 1
            continue
        _build._lib = libs[name] = load(so)
        results[name] = {"ptxas": usage,
                         **time_variant(name, ops_all, args.reps,
                                        name in VARIANTS)}
    if "shipped" in libs:
        _build._lib = libs["shipped"]
        results["reference"] = reference(ops_all)
        print(f"reference: {json.dumps(results['reference'])}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "results": results},
                              indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())

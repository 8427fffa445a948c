#!/usr/bin/env python3
"""Time build variants of the grid kernels K1-K4 on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/tune_intervals.py [--reps 10]
                                          [--only default ex_tile_4x4 ...]
                                          [--out chiprun_out/tune.json]

Each variant in ``VARIANTS`` is a copy of ``safeopt_torch/ops/csrc``
under ``build/tune_src/`` with some of the constants of
``intervals.cuh`` (K1/K2) or ``expander.cuh`` (K3/K4, the ``ex_``
variants) changed. For K1/K2: the gram a block keeps resident in shared
memory (at 64 KB two blocks fit on an SM, at 128 KB one), the blocks
per SM of ``__launch_bounds__``, the most slices of 32 points per
block, and the columns of a staged piece of the factor and the pieces
in flight per warp. For K3/K4: the register tile (candidates per
thread), the M2 a block keeps resident (none: every piece streamed),
the blocks per SM of ``__launch_bounds__`` and the rows of a piece.
Others change a block of code (a copy path at the edge of the factor,
the plan gram's loop over a leaf's columns, which K4 shares). Each copy
also gets C functions that ask the occupancy calculator how many blocks
of each instance fit on an SM (the shipped library has none), and for
K3/K4 the launch's layout. For each variant this builds the kernel
library and, on the float32 states of ``tools_torch/measure.py`` (K1 and
K3 at the flagship and cap 512, K2 and K4 on the contextual GP 0, the
expander kernels on the walk's first chunk), reports:

- each kernel's CUDA-event ms per call over ``--reps`` calls after 2
  warm-ups, beside its bound (``chip_smoke.interval_bound`` /
  ``expander_bound``) and the share of the bound it reaches;
- its largest distance from the float64 plain version on the same state
  (``max_abs_err``; K3/K4: ``predicates_differing``);
- the blocks resident on an SM (the occupancy calculator); for K3/K4
  also the launch's shared bytes, resident M2 rows, candidates of a
  pass, points of a tile and the M2 bytes the launch reads (every block
  its resident rows once, every tile the streamed rest), beside those
  of the parent design (every block of 64 points all of M2 for each 32
  candidates); and ptxas's registers and spills of every instance.

The first variant is the sources as they are. ``ABLATIONS`` are copies
with one stage of a block body taken out (their results are wrong by
design; only their times count): the time that goes when a stage goes
is that stage's share. ``--only`` builds the named variants and
ablations alone. Prints one JSON object per variant and writes them
all, after the card's ``nvidia-smi`` line, to ``--out``.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools_torch"))

from chip_smoke import (BETA, cuda_ms, expander_bound,  # noqa: E402
                        interval_bound, plan_leaves)
from measure import CONFIGS, problem, stage_ms  # noqa: E402


def constants(**values):
    """Patches of ``intervals.cuh`` and ``expander.cuh`` that set their
    constants ``k<Name>`` to ``values`` (default: K1/K2 64 KB of gram, 2
    blocks per SM, 8 slices, 16-column pieces, 2 in flight; K3/K4 8
    candidates x 4 points a thread, 80 KB of resident M2, 2 blocks per SM
    in f32 at passes of 32, 16-row pieces)."""
    lines = {"GramBytes": "constexpr size_t kGramBytes = 64 * 1024;",
             "IvMinBlocks": "constexpr int kIvMinBlocks = 2;",
             "MaxSlices": "constexpr int kMaxSlices = 8;",
             "KS": "constexpr int kKS = 16;",
             "Stages": "constexpr int kStages = 2;",
             "ExTM": "constexpr int kExTM = 8;",
             "ExM2Bytes": "constexpr size_t kExM2Bytes = 80 * 1024;",
             "ExMinBlocks": "constexpr int kExMinBlocks = 2;",
             "ExKS": "constexpr int kExKS = 16;"}
    return [("expander.cuh" if name.startswith("Ex") else "intervals.cuh",
             lines[name], lines[name].rsplit("=", 1)[0] + f"= {value};")
            for name, value in values.items()]


# name -> [(source file, old text, new text)]; the first is the sources
# as they are
VARIANTS = {
    "default": [],
    "gram128k": constants(GramBytes=128 * 1024),
    # fewer points per block at small capacities (the flagship)
    "max_slices4": constants(MaxSlices=4),
    # 8-column pieces: 3 or 4 in flight in the same ring
    "piece8_stages4": constants(KS=8, Stages=4),
    "piece8_stages3": constants(KS=8, Stages=3),
    # three blocks on an SM: 44 KB of gram (352 rows at cap 512), a ring
    # of two 8-column pieces, at most 85 registers
    "three_blocks": constants(KS=8, IvMinBlocks=3, GramBytes=45056),
    # an element-by-element copy path for bands past cap beside the
    # asynchronous one (what an unpadded factor needs); never taken here
    "edge_copy": [("intervals.cuh", """    if (k0 + c < cend)
      cp_async16(at + c * kBand + r, lmt + (size_t)(k0 + c) * ldl + r0 + r);
""", """    if (k0 + c >= cend) continue;
    const T* src = lmt + (size_t)(k0 + c) * ldl + r0 + r;
    if (ldl % V == 0 && r0 + kBand <= ldl) {
      cp_async16(at + c * kBand + r, src);
    } else {
      for (int e = 0; e < V; ++e)
        at[c * kBand + r + e] = r0 + r + e < ldl ? src[e] : T(0);
    }
""")],
    # the plan gram over every column of a leaf (zero scales included),
    # and over its active columns in a loop bounded by their count
    "plan_all_columns": [(
        "common.cuh",
        "for (int j = 0; j < d; ++j) {\n"
        "          if (j == ncols[q]) break;\n"
        "          const int k = cq[j];",
        "for (int k = 0; k < d; ++k) {")],
    "plan_columns_by_count": [(
        "common.cuh",
        "for (int j = 0; j < d; ++j) {\n          if (j == ncols[q]) break;",
        "for (int j = 0; j < ncols[q]; ++j) {")],
    # K3/K4: 4 candidates x 4 points a thread (8 x 4 is K1's tile)
    "ex_tile_4x4": constants(ExTM=4),
    # no resident M2: every piece streamed through the block's ring
    "ex_m2_streamed": constants(ExM2Bytes=0),
    # one or three blocks on an SM (at most 255 or 85 registers)
    "ex_min_blocks1": constants(ExMinBlocks=1),
    "ex_min_blocks3": constants(ExMinBlocks=3),
    # 8- and 32-row pieces of gram (and of streamed M2)
    "ex_piece8": constants(ExKS=8),
    "ex_piece32": constants(ExKS=32),
    # four gram rows a call (fewer exps in flight)
    "ex_gram_rows4": [("expander.cuh", "constexpr int kExRows = 8;",
                       "constexpr int kExRows = 4;")],
    # two candidates a gram.rows call in the epilogue
    "ex_epi2": [("expander.cuh", "constexpr int kExEpi = 4;",
                 "constexpr int kExEpi = 2;")],
    # float32 exp as exp2f of a scaled argument (every kernel's gram)
    "exp2": [("common.cuh",
              "float dexp(float x) { return expf(x); }",
              "float dexp(float x) { return exp2f(x * 1.44269504088896341f); }")],
}
# ablations: one stage of the block body taken out
ABLATIONS = {
    # the resident gram's entries are not evaluated
    "no_gram": [
        ("intervals.cuh", "gram.rows(v, x, zs, p, dd, P);",
         "for (int r = 0; r < R; ++r) v[r] = T(0.5);"),
        ("intervals.cuh",
         "gk[(size_t)c * P + p] = gram(xs + (size_t)c * dd, zs, p, dd, P);",
         "gk[(size_t)c * P + p] = T(0.5);")],
    # the factor's pieces are not copied (the ring holds stale values)
    "no_factor_copy": [
        ("intervals.cuh", "      cp_async16(at + c * kBand + r, lmt",
         "      if (cend < 0) cp_async16(at + c * kBand + r, lmt")],
    # no rank-1 steps
    "no_product": [
        ("intervals.cuh", "  if (steps == kKS) {", "  if (steps < 0) {"),
        ("intervals.cuh", "for (int c = 0; c < steps; ++c) step(c);",
         "for (int c = 0; c < 0; ++c) step(c);")],
    # K3/K4: the gram pieces' entries are not evaluated
    "ex_no_gram": [
        ("expander.cuh", "gram.rows(v, x, zs, p, dd, PTS);",
         "for (int r = 0; r < R; ++r) v[r] = T(0.5);"),
        ("expander.cuh",
         "? gram(xs + (size_t)(r0 + k0 + c) * dd, zs, p, dd, PTS)",
         "? T(0.5)")],
    # M2 is not copied (resident rows and ring hold stale values)
    "ex_no_m2_copy": [
        ("expander.cuh", "      cp_async16(s, g);", "      if (C < 0) cp_async16(s, g);"),
        ("expander.cuh", "        s[e] = j0 + j < C && c + e < cap ? g[e] : T(0);",
         "        if (C < 0) s[e] = g[e];")],
    # no contraction steps
    "ex_no_product": [
        ("expander.cuh", "  if (steps == kExKS) {", "  if (steps < 0) {"),
        ("expander.cuh", "for (int c = 0; c < steps; c += V) round(c);",
         "for (int c = 0; c < 0; c += V) round(c);")],
}

# the occupancy query appended to each kernel's source in a copy: the
# float32 instance's resident blocks per SM at a launch over (cap, d)
OCCUPANCY = """
extern "C" int safeopt_tune_%s_blocks(int cap, int d) {
  using namespace safeopt;
  const IvLayout<float> lay = interval_layout<float>(cap, d);
  cudaError_t err = cudaFuncSetAttribute(
      %s<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, %s<float>, kThreads, lay.bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}
"""
BLOCKS = {"fused_intervals.cu": ("k1", "intervals_kernel"),
          "fused_intervals_plan.cu": ("k2", "intervals_plan_kernel")}
# the expander kernels' float32 layout at a launch over (cap, C, d):
# out = [blocks per SM, shared bytes, resident M2 rows, candidates of a
# pass, points of a tile, rows of a piece]
EX_LAYOUT = """
extern "C" int safeopt_tune_%s_layout(int cap, int C, int d, int* out) {
  using namespace safeopt;
  return with_pass_width(C, [&](auto cw) {
    constexpr int CW = decltype(cw)::value;
    const ExLayout<float, CW> lay(cap, d);
    cudaError_t err = cudaFuncSetAttribute(
        %s<float, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.bytes);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, %s<float, CW>, kThreads, lay.bytes);
    out[0] = blocks;
    out[1] = (int)lay.bytes;
    out[2] = lay.res;
    out[3] = CW;
    out[4] = lay.TP;
    out[5] = kExKS;
    return (int)err;
  });
}
"""
EX_BLOCKS = {"fused_expander.cu": ("k3", "expander_kernel"),
             "fused_expander_plan.cu": ("k4", "expander_plan_kernel")}


def patched_sources(name, patches):
    """A copy of ``csrc`` under ``build/`` with ``patches`` applied and
    the occupancy query appended."""
    from safeopt_torch.ops import _build

    dst = ROOT / "build" / "tune_src" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build._CSRC, dst)
    for fname, old, new in patches:
        path = dst / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {fname}")
        path.write_text(text.replace(old, new))
    for fname, (label, kernel) in BLOCKS.items():
        with open(dst / fname, "a") as f:
            f.write(OCCUPANCY % (label, kernel, kernel))
    for fname, (label, kernel) in EX_BLOCKS.items():
        with open(dst / fname, "a") as f:
            f.write(EX_LAYOUT % (label, kernel, kernel))
    return dst


def ptxas_usage(log):
    """``{kernel: "N registers, M bytes spill stores"}`` of every kernel
    instance, from nvcc's ``-Xptxas -v`` log."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "Used" in line:
            usage[name] = line.split(":", 1)[1].strip()
        elif name and "spill" in line:
            usage[name + " spills"] = line.strip()
    return usage


def cases(grids):
    """(label, kernel, plain, operands, bound, geometry) of K1 and K3 at
    the flagship and cap 512, and K2 and K4 on the contextual GP 0 (the
    expander kernels on the walk's first chunk), in float32; geometry is
    (cap, d) for K1/K2 and (cap, C, d, G, N, n) for K3/K4."""
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp

    f32 = torch.float32
    out = []
    for name in ("flagship", "cap512", "context"):
        opt = problem(name, grids)[0]
        kernels, states = opt._model_args()
        grid = opt._grid()
        N, d = grid.shape
        cap, n = CONFIGS[name][0], int(states[0].count)
        gidx, Q, S, mu, sigma, fmin = stage_ms(opt, 1)[1]
        C, U = gidx.shape[0], int((~S).sum())
        valid = torch.ones(C, dtype=torch.bool, device=grid.device)
        if name == "context":
            ops = fp.interval_plan_operands(kernels[0], states[0], grid, BETA)
            leaves = plan_leaves(ops[4], ops[6])
            out.append((f"K2 {name}", fp.fused_intervals_plan,
                        fp.fused_intervals_plan_plain, ops,
                        interval_bound(f32, 1, N, d, cap, n, leaves),
                        (cap, d)))
            ex = fe.expander_plan_operands(
                kernels[0], states[0], grid, ~S, mu[0], sigma[0], grid[gidx],
                Q[gidx, 1], valid, BETA, fmin[0])
            out.append((f"K4 {name}", fe.fused_expander_plan,
                        fe.fused_expander_plan_plain, ex,
                        expander_bound(f32, 1, N, U, d, cap, n, C, leaves),
                        (cap, C, d, 1, N, n)))
        else:
            G = len(states)
            ops = fp.interval_operands(kernels, states, grid, BETA)
            out.append((f"K1 {name}", fp.fused_intervals,
                        fp.fused_intervals_plain, ops,
                        interval_bound(f32, G, N, d, cap, n), (cap, d)))
            ex = fe.expander_operands(kernels, states, grid, ~S, mu, sigma,
                                      grid[gidx], Q[gidx][:, 1::2].T.clone(),
                                      valid, BETA, fmin)
            out.append((f"K3 {name}", fe.fused_expander,
                        fe.fused_expander_plain, ex,
                        expander_bound(f32, G, N, U, d, cap, n, C),
                        (cap, C, d, G, N, n)))
    return out


def expander_layout(lib, label, geometry):
    """The float32 K3/K4 launch's layout (``EX_LAYOUT``) and the M2 bytes
    it reads: every block its resident rows once per pass, every tile
    the streamed rest (an upper bound: tiles with no unsafe point skip
    it); beside the bytes of the parent design, in which each block of
    64 points read all of M2 (cap rows) for every 32 candidates."""
    cap, C, d, G, N, n = geometry
    fn = getattr(lib, f"safeopt_tune_{label[:2].lower()}_layout")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    got = (ctypes.c_int * 6)()
    err = fn(cap, C, d, got)
    blocks, nbytes, res, cw, tp, ks = list(got)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-N // tp)
    grid_x = min(tiles, max(1, blocks * sms // G))
    rows = -(-n // ks) * ks
    passes = -(-C // cw)
    m2 = 4 * G * passes * cw * (grid_x * min(res, rows)
                                + tiles * max(0, rows - res))
    return {"layout_error": err, "blocks_per_sm": blocks,
            "shared_bytes": nbytes, "resident_m2_rows": res,
            "candidates_per_pass": cw, "points_per_tile": tp,
            "blocks": grid_x * G, "m2_bytes_per_call": m2,
            "m2_bytes_parent_design": 4 * G * -(-N // 64) * -(-C // 32)
            * 32 * cap}


def main():
    """Build and time every variant; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default="chiprun_out/tune.json")
    parser.add_argument("--only", nargs="+", default=None,
                        help="variants and ablations to build (default all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_intervals: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    grids = {"flagship": linearly_spaced_combinations([(-5.0, 5.0),
                                                      (-5.0, 5.0)], 1000),
             "context": linearly_spaced_combinations([(-3.0, 3.0)],
                                                     1_000_000)}
    runs = cases(grids)
    refs = [plain(*[o.double() if torch.is_tensor(o) and o.is_floating_point()
                    else o for o in ops])
            for _, _, plain, ops, _, _ in runs]
    results = []
    todo = [(v, p) for v, p in VARIANTS.items()]
    todo += [(f"ablation_{a}", p) for a, p in ABLATIONS.items()]
    builds = [(v, p, patched_sources(v, p)) for v, p in todo
              if args.only is None or v.replace("ablation_", "") in args.only
              or v in args.only]
    for variant, patches, csrc in builds:
        lib = _build.load(_build.build(csrc))
        for label, _ in BLOCKS.values():
            fn = getattr(lib, f"safeopt_tune_{label}_blocks")
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _build._lib = lib              # the wrappers launch this variant
        row = {"variant": variant,
               "patches": [new for _, _, new in patches],
               "ptxas": ptxas_usage(_build.build_info()["log"]),
               "kernels": {}}
        for (label, kernel, _, ops, (b_ms, _), geom), ref in zip(runs, refs):
            got = kernel(*ops)
            ms = cuda_ms(lambda: kernel(*ops), reps=args.reps)
            entry = row["kernels"][label] = {"ms": ms, "bound_ms": b_ms,
                                             "share_of_bound": b_ms / ms}
            if label[:2] in ("K3", "K4"):
                entry["predicates_differing"] = int((got != ref).sum())
                entry.update(expander_layout(lib, label, geom))
                continue
            blocks = getattr(lib, f"safeopt_tune_{label[:2].lower()}_blocks")
            entry["max_abs_err"] = (got.double() - ref).abs().max().item()
            entry["blocks_per_sm"] = blocks(*geom)
        results.append(row)
        print(json.dumps(row), flush=True)
    _build._lib = None
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                               "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time build variants of B2/B5's gram-only body (``csrc/gram_rows.cuh``)
on one CUDA card, and count the MUFU operations of one gram entry.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/tune_gram_rows.py [--only shipped t256 ...]
        [--reps 10] [--mufu] [--out chiprun_out/tune_gram_rows.json]

Each variant in ``VARIANTS`` is a copy of ``safeopt_torch/ops/csrc``
under ``build/tune_gram_rows/<name>`` with the constants of
``gram_rows.cuh`` replaced (threads a block, points a thread, bytes of a
staged chunk; ``tools_torch/variants.py``), whose
``interval_experiments.cu`` is built with the package's nvcc flags into
a library of its own (one ``nvcc`` a variant, all at once); the
package's wrapper ``interval_ablation`` launches it through the
unchanged C entry ``safeopt_interval_ablation_f32/_f64``. On the float32
states of ``tools_torch/states.py`` (cap 512, G=2, 400 observations:
B2's gram sums over both GPs, B5's modes over GP 0 as the harness takes
it; the long campaigns ``cap1024`` and ``cap2048``, G=1) and on the
cap-512 state in float64, each variant's rows must be the shipped
variant's bits (the order of a point's rows does not depend on these
constants); it reports the CUDA-event ms of a launch (mean of ``--reps``
after 2 warm-ups), ``chip_smoke.ablation_bound`` and its share, and
ptxas's registers and spills of each ``gram_rows_kernel`` instance.

``--mufu`` builds one gram entry of each kind (``common.cuh`` kfun, the
function every gram calls) in float32 and float64 into a probe library
and prints the MUFU instructions of each, and those of the shipped
variant's ``gram_rows_kernel`` instances (``_build.sass_opcodes``): the
counts ``chip_smoke.GRAM_MUFU`` states.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import ablation_bound  # noqa: E402
from tools_torch.states import (cap512_operands, cuda_ms,  # noqa: E402
                                first_gp, long_operands)
from tools_torch.variants import (build_all, load_entries,  # noqa: E402
                                  patched_copy, ptxas_usage)

OUT = ROOT / "build" / "tune_gram_rows"
HEADER = "gram_rows.cuh"
SOURCE = "interval_experiments.cu"
ENTRIES = ("safeopt_interval_ablation_f32", "safeopt_interval_ablation_f64")


def _set(name, old, new):
    """A patch of ``gram_rows.cuh`` that sets ``name`` to ``new``."""
    return (HEADER, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


THREADS = ("kGrThreads", 128)
POINTS = ("kGrPoints", 4)
CHUNK = ("kGrChunkBytes", 4096)
VARIANTS = {
    "shipped": [],
    "p2": [_set(*POINTS, 2)],
    "p8": [_set(*POINTS, 8)],
    "t64": [_set(*THREADS, 64)],
    "t256": [_set(*THREADS, 256)],
    "t256_p2": [_set(*THREADS, 256), _set(*POINTS, 2)],
    "t64_p8": [_set(*THREADS, 64), _set(*POINTS, 8)],
    "c8k": [_set(*CHUNK, 8192)],
    "c2k": [_set(*CHUNK, 2048)],
}
# one gram entry of each kind, kfun as every gram calls it (Cos true
# takes the cosine too)
MUFU_PROBE = """#include "common.cuh"
using namespace safeopt;
template <typename T, int K>
__global__ void entry_kernel(const T* r2, T* out) {
  out[threadIdx.x] = kfun<true>(K, r2[threadIdx.x], T(1.5));
}
#define SAFEOPT_PROBE(T, K) \\
  template __global__ void entry_kernel<T, K>(const T*, T*);
SAFEOPT_PROBE(float, 0) SAFEOPT_PROBE(float, 1) SAFEOPT_PROBE(float, 2)
SAFEOPT_PROBE(float, 3) SAFEOPT_PROBE(float, 4)
SAFEOPT_PROBE(double, 0) SAFEOPT_PROBE(double, 1) SAFEOPT_PROBE(double, 2)
SAFEOPT_PROBE(double, 3) SAFEOPT_PROBE(double, 4)
"""
# the MUFU opcodes of the kinds' transcendentals
MUFU_OPS = ("MUFU.EX2", "MUFU.RSQ", "MUFU.RCP", "MUFU.SIN", "MUFU.COS",
            "MUFU.LG2")
KIND_NAMES = ("RBF", "Matern32", "Matern52", "Exponential", "Cosine")
MODES = {"gram_sums": 0, "no_product": 2, "epilogue": 3}


def build(names, probe=False):
    """{name: (library path or None, nvcc's log)} of the variants
    ``names`` and, with ``probe``, of the MUFU probe, every one at once."""
    jobs = {n: (patched_copy(OUT / n, VARIANTS[n]), [SOURCE]) for n in names}
    if probe:
        src = patched_copy(OUT / "mufu_probe", [])
        (src / "mufu_probe.cu").write_text(MUFU_PROBE)
        jobs["mufu_probe"] = (src, ["mufu_probe.cu"])
    return build_all(jobs)


def launcher(lib, ops, mode):
    """A call of the wrapper ``interval_ablation`` that launches the
    variant ``lib``'s kernel on K1's operands ``ops``."""
    from safeopt_torch.ops import _build
    from safeopt_torch.ops import interval_experiments as ie

    def run():
        _build._lib = lib
        return ie.interval_ablation(*ops, mode)
    return run


def cases():
    """(label, mode, K1's operands) of each timed launch."""
    f32 = torch.float32
    cap512 = cap512_operands(f32)
    out = [("cap512", "gram_sums", cap512),
           ("cap512", "no_product", first_gp(cap512)),
           ("cap512", "epilogue", first_gp(cap512))]
    for name in ("cap1024", "cap2048"):
        ops = long_operands(name, f32)
        out += [(name, mode, ops) for mode in MODES]
    ops64 = cap512_operands(torch.float64)
    out += [("cap512 float64", "gram_sums", ops64),
            ("cap512 float64", "no_product", first_gp(ops64))]
    return out


def mufu(probe, shipped):
    """MUFU instructions of one gram entry of each kind and dtype (the
    probe library ``probe``) and of each ``gram_rows_kernel`` instance of
    the shipped library ``shipped``."""
    from safeopt_torch.ops import _build

    counts = {op: _build.sass_opcodes(op, probe) for op in MUFU_OPS}
    out = {"probe": {}, "shipped": {}}
    for fn in counts[MUFU_OPS[0]]:
        dtype = "float64" if "IdL" in fn else "float32"
        kind = KIND_NAMES[int(fn.split("Li")[-1].split("E")[0])]
        ops = {op: c[fn] for op, c in counts.items() if c[fn]}
        out["probe"][f"{dtype} {kind}"] = ops
        print(f"mufu probe {dtype} {kind}: {sum(ops.values())} {ops}",
              flush=True)
    for fn, n in _build.sass_opcodes("MUFU", shipped).items():
        if "gram_rows_kernel" in fn:
            out["shipped"][fn] = n
            print(f"mufu shipped {fn}: {n}", flush=True)
    return out


def main():
    """Build, check and time the variants; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="*", default=None)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--mufu", action="store_true")
    parser.add_argument("--out", default="chiprun_out/tune_gram_rows.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_gram_rows: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    names = ["shipped"] + [n for n in (args.only or VARIANTS)
                           if n != "shipped"]
    built = build(names, probe=args.mufu)
    libs, report = {}, {"nvidia_smi": smi, "variants": {}}
    for name in names:
        so, log = built[name]
        usage = {k: v for k, v in ptxas_usage(log).items()
                 if "gram_rows_kernel" in k}
        report["variants"][name] = {"ptxas": usage, "cases": {}}
        if so is None:
            print(f"{name}: build failed\n{log[:3000]}", flush=True)
            continue
        libs[name] = load_entries(so, ENTRIES)
        spills = sorted({v for k, v in usage.items() if k.endswith("spills")})
        print(f"{name}: built, {len(usage) // 2} instances, spills "
              f"{spills}", flush=True)
    if "shipped" not in libs:
        return 1
    rc = 0
    for label, mode, ops in cases():
        zt, _, xs, _, _, scal, _ = ops
        G, cap, d = xs.shape
        n = int(scal[0, 3])
        b_ms, b_by = ablation_bound(mode, zt.dtype, G, zt.shape[1], d, cap, n)
        want = launcher(libs["shipped"], ops, mode)()
        for name, lib in libs.items():
            run = launcher(lib, ops, mode)
            same = bool(torch.equal(run(), want))
            ms = cuda_ms(run, reps=args.reps)
            report["variants"][name]["cases"][f"{label} {mode}"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                "bits_of_shipped": same}
            rc |= 0 if same else 1
            print(f"{label} {mode} {name}: {ms:.4f} ms, bound {b_ms:.4f} "
                  f"({b_by}), share {b_ms / ms:.1%}, shipped's bits "
                  f"{same}", flush=True)
    if args.mufu:
        probe, log = built["mufu_probe"]
        if probe is None:
            print(f"the MUFU probe failed to build\n{log[:3000]}", flush=True)
            return 1
        report["mufu"] = mufu(probe, built["shipped"][0])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time build variants of the float32 wgmma K1-3p on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/tune_three_pass.py [--reps 5]
        [--only default no_gram ...] [--out chiprun_out/tune3.json]

Each variant in ``VARIANTS`` is a copy of ``safeopt_torch/ops/csrc``
under ``build/tune3_src/<name>/`` with ``intervals3.cuh`` patched: the
consumer warpgroups and the factor chunks in flight per ring
(``kGroups3``, ``kStages3``), or, in the ablations, one stage of the body
taken out (their rows are wrong by design; only their times count):
``no_gram`` skips each item's gram fill, ``no_loads`` arrives on the ring
barriers without copying the factor, ``no_product`` issues no wgmma
and ``one_pass`` issues the first of the three limb products only. The
time that goes when a stage goes is that stage's share. Each variant
builds ``fused_intervals3.cu`` alone (one nvcc each, all started
together) and is timed on the cap-512 state of ``tools_torch/states.py``
(two RBF GPs, 400 observations, N = 1e6) in float32: CUDA-event ms per
call over ``--reps`` calls after two warm-ups, each variant twice in
turns, beside its registers and spills (ptxas), its HGMMA count (SASS)
and its largest ratio to the float32 bound of K1-3p's plain version.
Prints the card's ``nvidia-smi`` line first and one JSON object per
variant, and writes them all to ``--out``.
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

from tools_torch.states import cap512_operands, cuda_ms  # noqa: E402

H = "intervals3.cuh"
_GRAM = ("    fill_gram3_d(ghi, glo, I.xs, zs, 0, 0, rows / 8 * kP3, n, d, "
         "I.gram, ct,\n                 kCons);\n")
_LOAD = ("          mbar_expect_tx(f + s, kChunkBytes3);\n"
         "          bulk_load(buf + (size_t)s * kChunkBytes3,\n"
         "                    src + (size_t)(k0 / kKC3) * kChunkBytes3, "
         "kChunkBytes3,\n                    f + s);\n")
_PRODUCT = ("            wgmma_64x64(acc, ahi + o, bhi + o);\n"
            "            wgmma_64x64(acc, ahi + o, blo + o);\n"
            "            wgmma_64x64(acc, alo + o, bhi + o);\n")


def first_pass(text):
    """The first of three product lines alone."""
    return text.splitlines(True)[0]


def shape(groups, stages):
    """Patches setting the consumer warpgroups and chunks in flight."""
    return [(H, "constexpr int kGroups3 = 3;",
             f"constexpr int kGroups3 = {groups};"),
            (H, "constexpr int kStages3 = 3;",
             f"constexpr int kStages3 = {stages};")]


# name -> [(source file, old text, new text)]; the first is the sources
VARIANTS = {
    "default": [],
    "groups2_stages4": shape(2, 4),
    "groups4_stages2": shape(4, 2),
    "no_gram": [(H, _GRAM, "")],
    "no_loads": [(H, _LOAD, "          mbar_arrive(f + s);\n")],
    "no_loads_no_gram": [(H, _GRAM, ""),
                         (H, _LOAD, "          mbar_arrive(f + s);\n")],
    "no_product": [(H, _PRODUCT, "")],
    "one_pass": [(H, _PRODUCT, first_pass(_PRODUCT))],
}


def build(names):
    """{name: (library path, ptxas line, nvcc log)}, built in parallel."""
    from safeopt_torch.ops import _build

    base = ROOT / "build" / "tune3_src"
    shutil.rmtree(base, ignore_errors=True)
    procs = {}
    for name in names:
        src = base / name
        shutil.copytree(_build._CSRC, src)
        for file, old, new in VARIANTS[name]:
            text = (src / file).read_text()
            if old not in text:
                raise SystemExit(f"{name}: patch not found in {file}")
            (src / file).write_text(text.replace(old, new))
        so = src / "lib.so"
        cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so),
               str(src / "fused_intervals3.cu")]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry function" in line
                  and "intervals3_wg_kernel" in line)
        usage = " | ".join(line.split(":", 1)[-1].strip()
                           for line in lines[at + 1:at + 4]
                           if "Used" in line or "spill" in line)
        out[name] = (so, usage, log)
    return out


def main():
    """Build, check and time the variants; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--only", nargs="*", default=list(VARIANTS))
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
    built = build(args.only)
    ops = cap512_operands(torch.float32)
    zt, ils, xs, lm, w, scal, kind = ops
    G, cap, d = xs.shape
    N = zt.shape[1]
    chunks = fp.factor_chunks(lm)
    want = fp.fused_intervals3_plain(*ops).double()
    bound = ie.float32_bound(*ops, "split", limb="bf16")
    runs = {}
    for name, (so, usage, _) in built.items():
        fn = ctypes.CDLL(str(so)).safeopt_intervals3_f32
        fn.argtypes = _build._SIGNATURES["safeopt_intervals3_f32"]
        fn.restype = ctypes.c_int
        out = torch.empty((G, 2, N), device="cuda")

        def call(fn=fn, out=out):
            err = fn(*(ctypes.c_void_p(t.data_ptr())
                       for t in (zt, ils, xs, chunks, w, scal, out)),
                     G, N, d, cap, kind, ctypes.c_void_p(
                         torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        hgmma = sum(v for k, v in _build.sass_opcodes("HGMMA", so).items()
                    if "intervals3_wg_kernel" in k)
        runs[name] = {"variant": name, "ptxas": usage, "hgmma": hgmma,
                      "bound_ratio": ((out.double() - want).abs()
                                      / bound).max().item(),
                      "ms": [], "call": call}
    for _ in range(2):       # every variant twice, in turns
        for name, r in runs.items():
            r["ms"].append(cuda_ms(r["call"], reps=args.reps))
    results = []
    for r in runs.values():
        del r["call"]
        print(json.dumps(r), flush=True)
        results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"nvidia_smi": smi,
                                          "variants": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the interval stage's experiment kernels B1-B5 on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/bench_interval_experiments.py [--reps 10]
        [--out chiprun_out/interval_experiments.json]

The counterpart of the JAX package's five TPU harnesses
(``benchmarks/bench_interval_mosaic.py``, ``bench_interval_mosaic3.py``,
``bench_interval_mosaic4.py``, ``bench_interval_variants.py``,
``bench_interval_ablation.py``), on ``measure.py``'s cap-512 state in
float32: two RBF GPs, 400 observations from ``default_rng(512)`` in
[-4, 4]^2, capacity 512, the 1000 x 1000 grid on [-5, 5]^2 (N = 1e6).
B4 and B5 take GP 0 alone. Times are CUDA-event ms per call over
``--reps`` calls after two warm-ups. One JSON object per harness; B1-B3
also carry their ``3pass`` columns, as the TPU harnesses printed them.
Their kernels keep K1-3p's mma.sync body as it stood before K1-3p's
``wgmma`` redesign (``csrc/intervals.cuh`` ``ThreePassProduct``): the
``3pass_mma_sync_*`` keys time that body, and ``K1-3p_wgmma_ms`` times
K1-3p as the certified path runs it (``fused_intervals3``,
``csrc/fused_intervals3.cu``), beside them in the same run:

- ``B1``: K1 (``fused_intervals``) and each launch layout (slices per
  block, resident gram rows, shared-memory carveout) of
  ``intervals_launch``: ms and whether its rows are K1's bits;
  ``K1-3p_wgmma_ms`` and, per layout ``s<slices>_r<res>_c<carveout>``,
  ``3pass_mma_sync_<layout>_ms`` and
  ``3pass_mma_sync_<layout>_bits_of_auto`` (the bits of B1-3p at its
  automatic layout ``s0_r0_c-1``), and ``3pass_mma_sync_vs_wgmma``, the
  mma.sync body at its automatic layout over the wgmma K1-3p;
- ``B2``: ``gram_sums``, ``solve_rank1`` and K1 (total) ms and
  ``(gram + solve) / total``; ``3pass_solve_only_ms`` (B2-3p),
  ``3pass_mma_sync_total_ms`` (B1-3p at its automatic layout, the body
  B2-3p splits), ``3pass_sum_vs_mma_sync_total`` and ``K1-3p_wgmma_ms``;
- ``B3``: ``intervals_mu_from_gram`` and K1 ms, max |dQ| against K1;
  ``3pass_mxu_emit_ms`` (B3-3p), ``3pass_mma_sync_base_ms`` (B1-3p at
  its automatic layout), ``3pass_max_dq`` against it and
  ``K1-3p_wgmma_ms``;
- ``B4``: ``intervals_split`` ms for each limb format, in-kernel and
  hoisted (Lm's limbs from ``split_factor``, split once outside the
  timed calls, as the TPU harness splits them outside its loop), whether
  the pair gives the same bits, max |dQ| against K1 on GP 0;
- ``B5``: GP 0's full intervals through K1 (float32 pipe) and through
  B4 (bf16, hoisted: the TPU harness's 3-pass ``full``), ``no_product``
  and ``epilogue`` ms, and the shares they give: product = (full -
  no_product) / full, gram = (no_product - epilogue) / full.

Prints the card's ``nvidia-smi`` name and power limit first and writes
everything to ``--out``.
"""

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools_torch.states import (LAYOUTS, cap512_operands,  # noqa: E402
                                 cuda_ms, first_gp, one_gp)


def max_dq(a, b):
    """max |a - b| in float64."""
    return (a.double() - b.double()).abs().max().item()


def layout_tag(slices, res, carveout):
    """B1's name of a launch layout in its ``3pass_<layout>_*`` keys."""
    return f"s{slices}_r{res}_c{carveout}"


def b1(ops, reps):
    """K1 and each launch layout, with the FP32 and the three-pass
    mma.sync product: ms and bits against K1 (against B1-3p at its
    automatic layout); the wgmma K1-3p's ms."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    k1 = fp.fused_intervals(*ops)
    auto3 = ie.intervals_launch(*ops, three_pass=True)
    out = {"K1_ms": cuda_ms(lambda: fp.fused_intervals(*ops), reps=reps),
           "K1-3p_wgmma_ms": cuda_ms(lambda: fp.fused_intervals3(*ops),
                                     reps=reps),
           "variants": []}
    for slices, res, carveout in LAYOUTS[512][ops[0].dtype]:
        run = functools.partial(ie.intervals_launch, *ops, slices=slices,
                                res=res, carveout=carveout)
        out["variants"].append({
            "slices": slices, "res": res, "carveout": carveout,
            "bitexact": bool(torch.equal(run(), k1)),
            "ms": cuda_ms(run, reps=reps)})
        run3 = functools.partial(run, three_pass=True)
        tag = layout_tag(slices, res, carveout)
        out[f"3pass_mma_sync_{tag}_bits_of_auto"] = bool(
            torch.equal(run3(), auto3))
        out[f"3pass_mma_sync_{tag}_ms"] = cuda_ms(run3, reps=reps)
    out["3pass_mma_sync_vs_wgmma"] = (
        out[f"3pass_mma_sync_{layout_tag(0, 0, -1)}_ms"]
        / out["K1-3p_wgmma_ms"])
    return out


def b2(ops, reps):
    """The gram alone, the rank-1 solve alone and K1; the solve and the
    mma.sync body's full intervals with the three-pass product, and the
    wgmma K1-3p."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {f"{m}_ms": cuda_ms(lambda: ie.interval_ablation(*ops, m),
                              reps=reps)
           for m in ("gram_sums", "solve_rank1")}
    out["total_ms"] = cuda_ms(lambda: fp.fused_intervals(*ops), reps=reps)
    out["sum_vs_total"] = ((out["gram_sums_ms"] + out["solve_rank1_ms"])
                           / out["total_ms"])
    out["3pass_solve_only_ms"] = cuda_ms(lambda: ie.interval_ablation(
        *ops, "solve_rank1", three_pass=True), reps=reps)
    out["3pass_mma_sync_total_ms"] = cuda_ms(
        lambda: ie.intervals_launch(*ops, three_pass=True), reps=reps)
    out["3pass_sum_vs_mma_sync_total"] = (
        (out["gram_sums_ms"] + out["3pass_solve_only_ms"])
        / out["3pass_mma_sync_total_ms"])
    out["K1-3p_wgmma_ms"] = cuda_ms(lambda: fp.fused_intervals3(*ops),
                                    reps=reps)
    return out


def b3(ops, reps):
    """mu from the gram against K1, and with the three-pass product
    against the mma.sync body it shares (B1-3p at its automatic layout);
    the wgmma K1-3p."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    base3 = functools.partial(ie.intervals_launch, *ops, three_pass=True)
    return {"mu_from_gram_ms": cuda_ms(
                lambda: ie.intervals_mu_from_gram(*ops), reps=reps),
            "K1_ms": cuda_ms(lambda: fp.fused_intervals(*ops), reps=reps),
            "max_dq": max_dq(ie.intervals_mu_from_gram(*ops),
                             fp.fused_intervals(*ops)),
            "3pass_mxu_emit_ms": cuda_ms(lambda: ie.intervals_mu_from_gram(
                *ops, three_pass=True), reps=reps),
            "3pass_mma_sync_base_ms": cuda_ms(base3, reps=reps),
            "3pass_max_dq": max_dq(ie.intervals_mu_from_gram(
                *ops, three_pass=True), base3()),
            "K1-3p_wgmma_ms": cuda_ms(lambda: fp.fused_intervals3(*ops),
                                      reps=reps)}


def b4(ops, reps):
    """GP 0 through the split-limb product, each limb format in-kernel
    and hoisted (Lm's limbs split once, before the timed launches)."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    one = one_gp(ops)
    k1 = fp.fused_intervals(*first_gp(ops))[0]
    out = {}
    for limb in ie.LIMBS:
        limbs = ie.split_factor(one[3], limb)
        pair = [ie.intervals_split(*one, limb=limb, limbs=h)
                for h in (None, limbs)]
        out[limb] = {
            "inkernel_ms": cuda_ms(lambda: ie.intervals_split(
                *one, limb=limb), reps=reps),
            "hoisted_ms": cuda_ms(lambda: ie.intervals_split(
                *one, limb=limb, limbs=limbs), reps=reps),
            "hoisted_bitexact": bool(torch.equal(*pair)),
            "max_dq_vs_K1": max_dq(pair[0], k1)}
    return out


def b5(ops, reps):
    """GP 0: full intervals (float32 pipe and 3-pass bf16), no product,
    epilogue only, and the shares."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    ops1, one = first_gp(ops), one_gp(ops)
    limbs = ie.split_factor(one[3], "bf16")
    out = {"full_ms": cuda_ms(lambda: fp.fused_intervals(*ops1), reps=reps),
           "full_3pass_ms": cuda_ms(lambda: ie.intervals_split(
               *one, limb="bf16", limbs=limbs), reps=reps)}
    for m in ("no_product", "epilogue"):
        out[f"{m}_ms"] = cuda_ms(lambda: ie.interval_ablation(*ops1, m),
                                 reps=reps)
    for tag in ("", "_3pass"):
        full = out[f"full{tag}_ms"]
        out[f"product_share{tag}"] = (full - out["no_product_ms"]) / full
        out[f"gram_share{tag}"] = (out["no_product_ms"]
                                   - out["epilogue_ms"]) / full
    return out


def run(ops, reps):
    """Every harness on K1's float32 operands ``ops``: {name: result}."""
    return {"B1": b1(ops, reps), "B2": b2(ops, reps), "B3": b3(ops, reps),
            "B4": b4(ops, reps), "B5": b5(ops, reps)}


def main():
    """Run the five harnesses; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out",
                        default="chiprun_out/interval_experiments.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_interval_experiments: torch.cuda.is_available() is "
              "false", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    results = run(cap512_operands(torch.float32), args.reps)
    for name, res in results.items():
        print(json.dumps({"harness": name, **res}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                               "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

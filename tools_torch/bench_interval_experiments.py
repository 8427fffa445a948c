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
B4 and B5 take GP 0 alone; B2's and B3's three-pass columns, B2's gram
sums, B4 and B5 also ``measure.py``'s long-campaign states ``cap1024``
and ``cap2048`` (``states.long_operands``, G = 1, the tiled body). Times are CUDA-event
ms per call over ``--reps`` calls after two warm-ups. One JSON object per
harness; B1-B3 also carry their ``3pass`` columns, as the TPU harnesses
printed them. B1-3p, B2-3p and B3-3p run K1-3p's float32 ``wgmma``
bodies (``csrc/interval_experiments3.cu``: the resident one at cap 512,
the tiled one at the long states), so that B2's and B3's three-pass
ratios set one body against itself; ``K1-3p_ms`` times K1-3p as the
certified path runs it (``fused_intervals3``) beside them in the same
run:

- ``B1``: K1 (``fused_intervals``) and each launch layout (slices per
  block, resident gram rows, shared-memory carveout) of
  ``intervals_launch``: ms and whether its rows are K1's bits;
  ``K1-3p_ms`` and, per float32 B1-3p layout
  ``g<groups>_s<stages>_r<res>_c<carveout>`` (``states.LAYOUTS3``),
  ``3pass_wgmma_<layout>_ms`` and ``3pass_wgmma_<layout>_bits_of_K1-3p``
  (whether its rows are K1-3p's bits: every layout with K1-3p's count of
  consumer warpgroups), and ``3pass_auto_vs_K1-3p``, B1-3p at its
  automatic layout ``g0_s0_r0_c-1`` over K1-3p;
- ``B2``: ``gram_sums``, ``solve_rank1`` and K1 (total) ms and
  ``(gram + solve) / total``; ``3pass_solve_only_ms`` (B2-3p),
  ``3pass_wgmma_total_ms`` (B1-3p at its automatic layout: K1-3p's
  function, which B2-3p's solve and B2's gram split),
  ``3pass_sum_vs_wgmma_total`` (the harness's question: is gram + solve
  the total?) and ``K1-3p_ms``; the three-pass keys, with the gram
  sums', also per long state under its name;
- ``B3``: ``intervals_mu_from_gram`` and K1 ms, max |dQ| against K1;
  ``3pass_mxu_emit_ms`` (B3-3p), ``3pass_wgmma_base_ms`` (B1-3p at its
  automatic layout), ``3pass_mxu_emit_vs_wgmma_base`` (the harness's
  question: is mu from the gram cheaper?), ``3pass_max_dq`` against it
  and ``K1-3p_ms``; the three-pass keys also per long state;
- ``B4``: ``intervals_split`` ms for each limb format, in-kernel and
  hoisted (Lm's limbs from ``split_factor``, cut once outside the timed
  calls, as the TPU harness splits them outside its loop), whether the
  pair gives the same bits, max |dQ| against K1 on GP 0; K1's ms on GP 0
  (``K1_ms``) and each format's in-kernel time over it
  (``<limb>_vs_K1``); the same per long-campaign state under its name;
- ``B5``: GP 0's full intervals through K1 (float32 pipe) and through
  B4 (bf16, hoisted: the TPU harness's 3-pass ``full``), ``no_product``
  and ``epilogue`` ms, and the shares they give: product = (full -
  no_product) / full, gram = (no_product - epilogue) / full; the same
  per long-campaign state under its name.

B2's gram sums and B5's two modes run one body (``csrc/gram_rows.cuh``).
Beside every time each harness keeps a digest of the rows it timed
(``digests``: sha256 of the output's bytes, by key), so that two trees'
runs show whether they give the same bits.

Prints the card's ``nvidia-smi`` name and power limit first and writes
everything to ``--out``. ``--package-root`` times the ``safeopt_torch``
of another tree (its kernels build into that tree's ``build/``) with
this tree's harnesses, as ``measure.py`` does.
"""

import argparse
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools_torch.states import (LAYOUTS, LAYOUTS3,  # noqa: E402
                                 b1_3p_groups, cap512_operands, cuda_ms,
                                 first_gp, long_operands, one_gp)


def max_dq(a, b):
    """max |a - b| in float64."""
    return (a.double() - b.double()).abs().max().item()


def digest(t):
    """sha256 of a tensor's bytes (its dtype, shape and values)."""
    return hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode()
                          + t.cpu().numpy().tobytes()).hexdigest()


def layout_tag(groups, stages, res, carveout):
    """The float32 B1-3p's name of a launch layout in its
    ``3pass_wgmma_<layout>_*`` keys."""
    return f"g{groups}_s{stages}_r{res}_c{carveout}"


def b1(ops, reps):
    """K1 and each launch layout of B1 (the FP32 product): ms and bits
    against K1; each float32 B1-3p layout (K1-3p's wgmma bodies): ms and
    bits against K1-3p, whose ms is taken between them."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    cap = ops[2].shape[1]
    k1 = fp.fused_intervals(*ops)
    k13 = fp.fused_intervals3(*ops)
    out = {"K1_ms": cuda_ms(lambda: fp.fused_intervals(*ops), reps=reps),
           "K1-3p_ms": cuda_ms(lambda: fp.fused_intervals3(*ops),
                               reps=reps),
           "variants": []}
    for slices, res, carveout in LAYOUTS[cap][ops[0].dtype]:
        run = functools.partial(ie.intervals_launch, *ops, slices=slices,
                                res=res, carveout=carveout)
        out["variants"].append({
            "slices": slices, "res": res, "carveout": carveout,
            "bitexact": bool(torch.equal(run(), k1)),
            "ms": cuda_ms(run, reps=reps)})
    for groups, stages, res, carveout in LAYOUTS3[cap]:
        run3 = functools.partial(ie.intervals_launch, *ops, three_pass=True,
                                 groups=groups, stages=stages, res=res,
                                 carveout=carveout)
        tag = layout_tag(groups, stages, res, carveout)
        same = bool(torch.equal(run3(), k13))
        out[f"3pass_wgmma_{tag}_bits_of_K1-3p"] = same
        if groups in (0, b1_3p_groups(cap)) and not same:
            out["3pass_order_kept_bitexact"] = False
        out[f"3pass_wgmma_{tag}_ms"] = cuda_ms(run3, reps=reps)
    out.setdefault("3pass_order_kept_bitexact", True)
    out["K1-3p_ms_after"] = cuda_ms(lambda: fp.fused_intervals3(*ops),
                                    reps=reps)
    out["3pass_auto_vs_K1-3p"] = (
        out[f"3pass_wgmma_{layout_tag(0, 0, 0, -1)}_ms"]
        / (0.5 * (out["K1-3p_ms"] + out["K1-3p_ms_after"])))
    return out


def b2_3pass(ops, reps, gram_sums_ms=None):
    """B2's gram sums (``gram_sums_ms`` when already timed), B2-3p's
    solve and B1-3p at its automatic layout (the full intervals), the
    latter two on the same wgmma body, and K1-3p."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    if gram_sums_ms is None:
        gram_sums_ms = cuda_ms(
            lambda: ie.interval_ablation(*ops, "gram_sums"), reps=reps)
    out = {"gram_sums_ms": gram_sums_ms,
           "3pass_solve_only_ms": cuda_ms(lambda: ie.interval_ablation(
               *ops, "solve_rank1", three_pass=True), reps=reps),
           "3pass_wgmma_total_ms": cuda_ms(
               lambda: ie.intervals_launch(*ops, three_pass=True),
               reps=reps)}
    out["3pass_sum_vs_wgmma_total"] = (
        (out["gram_sums_ms"] + out["3pass_solve_only_ms"])
        / out["3pass_wgmma_total_ms"])
    out["K1-3p_ms"] = cuda_ms(lambda: fp.fused_intervals3(*ops), reps=reps)
    out["digests"] = {"gram_sums": digest(ie.interval_ablation(
        *ops, "gram_sums"))}
    return out


def b2(ops, reps, long=None):
    """The gram alone, the rank-1 solve alone and K1; the solve with the
    three-pass product (B2-3p) and the full intervals with it (B1-3p at
    its automatic layout), both on K1-3p's wgmma body, and K1-3p; the
    three-pass columns also on each state of ``long`` (the tiled body),
    under its name."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {f"{m}_ms": cuda_ms(lambda: ie.interval_ablation(*ops, m),
                              reps=reps)
           for m in ("gram_sums", "solve_rank1")}
    out["total_ms"] = cuda_ms(lambda: fp.fused_intervals(*ops), reps=reps)
    out["sum_vs_total"] = ((out["gram_sums_ms"] + out["solve_rank1_ms"])
                           / out["total_ms"])
    out.update(b2_3pass(ops, reps, out["gram_sums_ms"]))
    out["digests"]["solve_rank1"] = digest(ie.interval_ablation(
        *ops, "solve_rank1"))
    for name, long_ops in (long or {}).items():
        out[name] = b2_3pass(long_ops, reps)
    return out


def b3_3pass(ops, reps):
    """B3-3p (mu from the gram) against B1-3p at its automatic layout,
    both on the same wgmma body, and K1-3p."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    base3 = functools.partial(ie.intervals_launch, *ops, three_pass=True)
    out = {"3pass_mxu_emit_ms": cuda_ms(lambda: ie.intervals_mu_from_gram(
               *ops, three_pass=True), reps=reps),
           "3pass_wgmma_base_ms": cuda_ms(base3, reps=reps),
           "3pass_max_dq": max_dq(ie.intervals_mu_from_gram(
               *ops, three_pass=True), base3()),
           "K1-3p_ms": cuda_ms(lambda: fp.fused_intervals3(*ops),
                               reps=reps)}
    out["3pass_mxu_emit_vs_wgmma_base"] = (out["3pass_mxu_emit_ms"]
                                           / out["3pass_wgmma_base_ms"])
    return out


def b3(ops, reps, long=None):
    """mu from the gram against K1, and with the three-pass product
    (B3-3p) against B1-3p at its automatic layout, both on K1-3p's wgmma
    body; K1-3p; the three-pass columns also on each state of ``long``
    (the tiled body), under its name."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {"mu_from_gram_ms": cuda_ms(
               lambda: ie.intervals_mu_from_gram(*ops), reps=reps),
           "K1_ms": cuda_ms(lambda: fp.fused_intervals(*ops), reps=reps),
           "max_dq": max_dq(ie.intervals_mu_from_gram(*ops),
                            fp.fused_intervals(*ops)),
           **b3_3pass(ops, reps)}
    for name, long_ops in (long or {}).items():
        out[name] = b3_3pass(long_ops, reps)
    return out


def b4(ops, reps, long=None):
    """GP 0 through the split-limb product, each limb format in-kernel
    and hoisted (Lm's limbs cut once, before the timed launches), beside
    K1 on GP 0; the same on each state of ``long`` ({name: K1's operands
    of one GP}), under its name."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    one = one_gp(ops)
    k1 = fp.fused_intervals(*first_gp(ops))[0]
    out = {"K1_ms": cuda_ms(lambda: fp.fused_intervals(*first_gp(ops)),
                            reps=reps)}
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
        out[f"{limb}_vs_K1"] = out[limb]["inkernel_ms"] / out["K1_ms"]
    for name, long_ops in (long or {}).items():
        out[name] = b4(long_ops, reps)
    return out


def b5(ops, reps, long=None):
    """GP 0: full intervals (float32 pipe and 3-pass bf16), no product,
    epilogue only, and the shares; the same on each state of ``long``,
    under its name."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    ops1, one = first_gp(ops), one_gp(ops)
    limbs = ie.split_factor(one[3], "bf16")
    out = {"full_ms": cuda_ms(lambda: fp.fused_intervals(*ops1), reps=reps),
           "full_3pass_ms": cuda_ms(lambda: ie.intervals_split(
               *one, limb="bf16", limbs=limbs), reps=reps)}
    out["digests"] = {}
    for m in ("no_product", "epilogue"):
        out[f"{m}_ms"] = cuda_ms(lambda: ie.interval_ablation(*ops1, m),
                                 reps=reps)
        out["digests"][m] = digest(ie.interval_ablation(*ops1, m))
    for tag in ("", "_3pass"):
        full = out[f"full{tag}_ms"]
        out[f"product_share{tag}"] = (full - out["no_product_ms"]) / full
        out[f"gram_share{tag}"] = (out["no_product_ms"]
                                   - out["epilogue_ms"]) / full
    for name, long_ops in (long or {}).items():
        out[name] = b5(long_ops, reps)
    return out


def run(ops, reps, long=None):
    """Every harness on K1's float32 operands ``ops`` (B2's and B3's
    three-pass columns and B4 also on each state of ``long``, {name: K1's
    float32 operands of one GP}): {name: result}."""
    return {"B1": b1(ops, reps), "B2": b2(ops, reps, long),
            "B3": b3(ops, reps, long), "B4": b4(ops, reps, long),
            "B5": b5(ops, reps, long)}


def main():
    """Run the five harnesses; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out",
                        default="chiprun_out/interval_experiments.json")
    parser.add_argument("--package-root", default=None,
                        help="a tree whose safeopt_torch is measured")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_interval_experiments: torch.cuda.is_available() is "
              "false", file=sys.stderr)
        return 1
    if args.package_root is not None:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    results = run(cap512_operands(torch.float32), args.reps,
                  {name: long_operands(name, torch.float32)
                   for name in ("cap1024", "cap2048")})
    for name, res in results.items():
        print(json.dumps({"harness": name, **res}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                               "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

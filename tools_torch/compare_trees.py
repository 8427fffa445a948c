#!/usr/bin/env python3
"""Measure a parent tree and this tree on one CUDA card, in one call.

Two steps. First, in the git checkout:

    python3 tools_torch/compare_trees.py unpack <rev>

unpacks ``git archive <rev>`` into ``build/compare/parent`` (``build/``
is git-ignored, so a copy of the working tree carries it). Then, from
the repository root on a machine with one CUDA card:

    python3 tools_torch/compare_trees.py run [--out-dir chiprun_out/compare]
        [--experiments]

runs this tree's ``tools_torch/measure.py`` four times, each in a
process of its own, in the order parent, change, change, parent, so
that a drift of the card or the host during the call shows in both
trees alike. The parent's runs measure its ``safeopt_torch`` through
``--package-root``; its kernels build into its own ``build/``. Each run
writes ``<tree>_<i>.json`` and ``<tree>_<i>.log`` to ``--out-dir``, and
one summary line per run is printed: per configuration the interval
and expander kernel ms, the interval stage's ms and its host part, and
the median ``optimize()`` ms. With ``--experiments`` each run also runs
this tree's ``tools_torch/bench_interval_experiments.py`` (on the
parent's package through ``--package-root``), written to
``<tree>_<i>_experiments.json``, and a second line gives the
experiment kernels' ms: B1-3p at its automatic layout, B2-3p and B3-3p
at cap 512 and per long-campaign state, B4 in-kernel per limb and
state, and B2's gram sums and B5's two modes per state. A last line a
run compares the digests of its experiment rows (B2's gram sums and
rank-1 solve, B5's two modes, per state) with the first parent run's:
the call exits 1 if any differs.

    python3 tools_torch/compare_trees.py ptxas

builds the parent's CUDA sources and this tree's, both with this tree's
nvcc flags, and compares ptxas's line of each kernel instance of the
parent (registers, barriers, shared memory; spills) with this tree's
line of the same instance; it exits 1 if any differs or is missing. The
parent's instances of redesigned kernels (``REDESIGNED``: the float32
K1-3p and K2-3p on the mma.sync body, which their ``wgmma`` kernels of
``fused_intervals3.cu`` replace; the float32 B1-3p, B2-3p, B3-3p and B4
on mma.sync, which the ``wgmma`` kernels of ``interval_experiments3.cu``
replace) are printed beside the new instances' lines instead. The lines
of the
kernels in ``NEW`` (those ``wgmma`` kernels, K1's tiled body,
``intervals_tiled_kernel``, and K2's on it, ``intervals_plan_tiled_kernel``
and ``intervals_plan_wide_tiled_kernel``, the float32 K1-3p/K2-3p tiled
body, ``intervals3_tiled_kernel`` and ``intervals_plan3_tiled_kernel``,
B1-3p's and B4's, ``wg3_kernel`` and ``tiled3_kernel``, and B2-3p's and
B3-3p's, ``rank1_wg3_kernel``, ``rank1_tiled3_kernel``, ``mu_wg3_kernel``
and ``mu_tiled3_kernel``) are printed, and one that spills exits 1 too.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = ROOT / "build" / "compare" / "parent"
# The float32 three-pass instances of intervals.cuh's body that the wgmma
# kernels replace, and the float32 B1-3p, B2-3p, B3-3p and B4 instances
# that the experiment wgmma kernels replace (parent names); the names of
# the kernels that are new since the port's first bodies: the wgmma
# kernels, K1's tiled body and K2's instances of it, the three-pass tiled
# body, and the experiments' wgmma kernels.
REDESIGNED = ("intervals3_kernelIfE", "intervals_plan3_kernelIfE",
              "intervals_plan_wide_kernelIfNS_16ThreePassProduct",
              "intervals3_launch_kernelIfE", "split_kernel",
              "rank1_solve3_kernelIfE", "mu_from_gram3_kernelIfE",
              "rowwise_kernel")
NEW = ("intervals3_wg_kernel", "intervals_plan3_wg_kernel",
       "intervals_tiled_kernel", "intervals_plan_tiled_kernel",
       "intervals_plan_wide_tiled_kernel", "intervals3_tiled_kernel",
       "intervals_plan3_tiled_kernel", "wg3_kernel", "tiled3_kernel",
       "rank1_wg3_kernel", "rank1_tiled3_kernel", "mu_wg3_kernel",
       "mu_tiled3_kernel", "gram_rows_kernel")
sys.path.insert(0, str(ROOT))


def unpack(rev):
    """``git archive rev`` into ``PARENT``, replacing what was there."""
    subprocess.run(["rm", "-rf", str(PARENT)], check=True)
    PARENT.mkdir(parents=True)
    archive = subprocess.run(["git", "-C", str(ROOT), "archive", rev],
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(PARENT)], input=archive,
                   check=True)
    print(f"unpacked {rev} into {PARENT}")
    return 0


def summary(path):
    """One line of the run's headline numbers."""
    parts = []
    for r in json.loads(path.read_text())["results"]:
        kern = " ".join(f"{k} {v['kernel_ms']:.4f}"
                        for k, v in r["kernels"].items())
        st = r["stages_ms"]
        parts.append(f"{r['config']}: {kern} | intervals {st['intervals']:.3f}"
                     f" (host {st['intervals_host']:.3f}) | optimize "
                     f"{r['optimize_ms']:.3f}")
    return "; ".join(parts)


def experiments_summary(path):
    """One line of the experiment kernels' ms."""
    res = json.loads(path.read_text())["results"]
    b1, b2, b3, b4 = (res[h] for h in ("B1", "B2", "B3", "B4"))
    parts = [f"B1-3p {b1['3pass_wgmma_g0_s0_r0_c-1_ms']:.4f}",
             f"B2-3p {b2['3pass_solve_only_ms']:.4f}",
             f"B3-3p {b3['3pass_mxu_emit_ms']:.4f}",
             f"K1-3p {b1['K1-3p_ms']:.4f}"]
    for name in ("cap1024", "cap2048"):
        if name in b2:      # a tree whose B2-3p and B3-3p take both bodies
            parts.append(f"{name}: B2-3p "
                         f"{b2[name]['3pass_solve_only_ms']:.4f} B3-3p "
                         f"{b3[name]['3pass_mxu_emit_ms']:.4f} B1-3p "
                         f"{b3[name]['3pass_wgmma_base_ms']:.4f}")
    for name in ("cap512", "cap1024", "cap2048"):
        r = b4 if name == "cap512" else b4[name]
        parts.append(f"B4 {name} " + " ".join(
            f"{limb} {r[limb]['inkernel_ms']:.4f}"
            for limb in ("bf16", "tf32")))
    b5 = res["B5"]
    for name in ("cap512", "cap1024", "cap2048"):
        r2, r5 = (b2, b5) if name == "cap512" else (b2.get(name, {}),
                                                    b5.get(name, {}))
        if "no_product_ms" in r5:
            parts.append(f"{name}: gram sums {r2['gram_sums_ms']:.4f} no "
                         f"product {r5['no_product_ms']:.4f} epilogue "
                         f"{r5['epilogue_ms']:.4f}")
    return "; ".join(parts)


def experiment_digests(path):
    """{state mode: digest} of the experiment rows a run recorded (B2's
    and B5's, at cap 512 and per long-campaign state)."""
    res = json.loads(path.read_text())["results"]
    out = {}
    for harness in ("B2", "B5"):
        r = res[harness]
        states = [("cap512", r)] + [(k, v) for k, v in r.items()
                                    if isinstance(v, dict) and "digests" in v]
        for name, value in states:
            for mode, dig in value.get("digests", {}).items():
                out[f"{name} {mode}"] = dig
    return out


def run(out_dir, reps, experiments=False):
    """The four measure.py runs (and bench_interval_experiments.py runs
    with ``experiments``); returns the exit code."""
    if not (PARENT / "safeopt_torch").is_dir():
        print(f"compare_trees: no parent tree in {PARENT}; run `unpack` "
              "first", file=sys.stderr)
        return 1
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    rc, runs, digests = 0, {"parent": 0, "change": 0}, {}
    for tree in ("parent", "change", "change", "parent"):
        runs[tree] += 1
        tag = f"{tree}_{runs[tree]}"
        cmd = [sys.executable, str(ROOT / "tools_torch" / "measure.py"),
               "--reps", str(reps), "--out", str(out_dir / f"{tag}.json")]
        if tree == "parent":
            cmd += ["--package-root", str(PARENT)]
        with open(out_dir / f"{tag}.log", "w") as log:
            proc = subprocess.run(cmd, cwd=ROOT, stdout=log,
                                  stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            print(f"{tag}: measure.py exited {proc.returncode}", flush=True)
            rc = 1
            continue
        print(f"{tag}: {summary(out_dir / f'{tag}.json')}", flush=True)
        if not experiments:
            continue
        out = out_dir / f"{tag}_experiments.json"
        cmd = [sys.executable,
               str(ROOT / "tools_torch" / "bench_interval_experiments.py"),
               "--reps", str(reps), "--out", str(out)]
        if tree == "parent":
            cmd += ["--package-root", str(PARENT)]
        with open(out_dir / f"{tag}_experiments.log", "w") as log:
            proc = subprocess.run(cmd, cwd=ROOT, stdout=log,
                                  stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            print(f"{tag}: bench_interval_experiments.py exited "
                  f"{proc.returncode}", flush=True)
            rc = 1
            continue
        print(f"{tag} experiments: {experiments_summary(out)}", flush=True)
        digests[tag] = experiment_digests(out)
    for tag, got in digests.items():
        want = digests.get("parent_1", {})
        differ = sorted(k for k in want if got.get(k) != want[k])
        print(f"{tag} experiment rows against parent_1's bits: "
              f"{len(want) - len(differ)} of {len(want)} equal"
              + (f"; differ: {', '.join(differ)}" if differ else ""),
              flush=True)
        rc |= 1 if differ or not want else 0
    return rc


def ptxas():
    """The parent's ptxas lines against this tree's; returns the exit
    code."""
    from safeopt_torch.ops import _build
    from tools_torch.variants import ptxas_usage

    csrc = PARENT / "safeopt_torch" / "ops" / "csrc"
    if not csrc.is_dir():
        print(f"compare_trees: no parent tree in {PARENT}; run `unpack` "
              "first", file=sys.stderr)
        return 1
    usage = {}
    for tree, src in (("parent", csrc), ("change", _build._CSRC)):
        _build.build(src)
        usage[tree] = ptxas_usage(_build.build_info()["log"])
    parent, change = usage["parent"], usage["change"]
    replaced = [k for k in parent if any(r in k for r in REDESIGNED)]
    kept = [k for k in parent if k not in replaced]
    differ = [k for k in kept if change.get(k) != parent[k]]
    for k in differ:
        print(f"differs: {k}: parent {parent[k]!r}, change "
              f"{change.get(k)!r}", flush=True)
    for k in replaced:
        print(f"replaced: {k}: parent {parent[k]!r}", flush=True)
    new = [k for k in change if any(r in k for r in NEW)]
    spills = [k for k in new if k.endswith(" spills")
              and "0 bytes spill stores, 0 bytes spill loads" not in change[k]]
    for k in new:
        print(f"new: {k}: {change[k]!r}", flush=True)
    print(f"ptxas: {len(kept) - len(differ)} of the parent's {len(kept)} "
          f"lines identical in this tree (which has {len(change)}); "
          f"{len(replaced)} lines of the redesigned float32 three-pass "
          f"instances replaced; {len(new)} lines of the new kernels, "
          f"{len(spills)} of them spilling", flush=True)
    return 1 if differ or spills or not new else 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="step", required=True)
    sub.add_parser("unpack").add_argument("rev")
    p_run = sub.add_parser("run")
    p_run.add_argument("--out-dir", default="chiprun_out/compare")
    p_run.add_argument("--reps", type=int, default=10)
    p_run.add_argument("--experiments", action="store_true")
    sub.add_parser("ptxas")
    args = parser.parse_args()
    if args.step == "unpack":
        return unpack(args.rev)
    if args.step == "ptxas":
        return ptxas()
    return run(ROOT / args.out_dir, args.reps, args.experiments)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Measure a parent tree and this tree on one CUDA card, in one call.

Two steps. First, in the git checkout:

    python3 tools_torch/compare_trees.py unpack <rev>

unpacks ``git archive <rev>`` into ``build/compare/parent`` (``build/``
is git-ignored, so a copy of the working tree carries it). Then, from
the repository root on a machine with one CUDA card:

    python3 tools_torch/compare_trees.py run [--out-dir chiprun_out/compare]

runs this tree's ``tools_torch/measure.py`` four times, each in a
process of its own, in the order parent, change, change, parent, so
that a drift of the card or the host during the call shows in both
trees alike. The parent's runs measure its ``safeopt_torch`` through
``--package-root``; its kernels build into its own ``build/``. Each run
writes ``<tree>_<i>.json`` and ``<tree>_<i>.log`` to ``--out-dir``, and
one summary line per run is printed: per configuration the interval
and expander kernel ms, the interval stage's ms and its host part, and
the median ``optimize()`` ms.

    python3 tools_torch/compare_trees.py ptxas

builds the parent's CUDA sources and this tree's, both with this tree's
nvcc flags, and compares ptxas's line of each kernel instance of the
parent (registers, barriers, shared memory; spills) with this tree's
line of the same instance; it exits 1 if any differs or is missing. The
parent's float32 K1-3p and K2-3p instances (``REDESIGNED``: the
mma.sync body, which their ``wgmma`` kernels of ``fused_intervals3.cu``
replace) are printed beside the new instances' lines instead, and a new
instance that spills exits 1 too.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = ROOT / "build" / "compare" / "parent"
# The float32 three-pass instances of intervals.cuh's body that the wgmma
# kernels replace (parent names), and those kernels' names in this tree.
REDESIGNED = ("intervals3_kernelIfE", "intervals_plan3_kernelIfE",
              "intervals_plan_wide_kernelIfNS_16ThreePassProduct")
WGMMA = ("intervals3_wg_kernel", "intervals_plan3_wg_kernel")
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


def run(out_dir, reps):
    """The four measure.py runs; returns the exit code."""
    if not (PARENT / "safeopt_torch").is_dir():
        print(f"compare_trees: no parent tree in {PARENT}; run `unpack` "
              "first", file=sys.stderr)
        return 1
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    rc, runs = 0, {"parent": 0, "change": 0}
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
    return rc


def ptxas():
    """The parent's ptxas lines against this tree's; returns the exit
    code."""
    from safeopt_torch.ops import _build
    from tools_torch.tune_intervals import ptxas_usage

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
    new = [k for k in change if any(r in k for r in WGMMA)]
    spills = [k for k in new if k.endswith(" spills")
              and "0 bytes spill stores, 0 bytes spill loads" not in change[k]]
    for k in new:
        print(f"wgmma: {k}: {change[k]!r}", flush=True)
    print(f"ptxas: {len(kept) - len(differ)} of the parent's {len(kept)} "
          f"lines identical in this tree (which has {len(change)}); "
          f"{len(replaced)} lines of the redesigned float32 three-pass "
          f"instances replaced by {len(new)} of the wgmma kernels, "
          f"{len(spills)} of them spilling", flush=True)
    return 1 if differ or spills or not new else 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="step", required=True)
    sub.add_parser("unpack").add_argument("rev")
    p_run = sub.add_parser("run")
    p_run.add_argument("--out-dir", default="chiprun_out/compare")
    p_run.add_argument("--reps", type=int, default=10)
    sub.add_parser("ptxas")
    args = parser.parse_args()
    if args.step == "unpack":
        return unpack(args.rev)
    if args.step == "ptxas":
        return ptxas()
    return run(ROOT / args.out_dir, args.reps)


if __name__ == "__main__":
    sys.exit(main())

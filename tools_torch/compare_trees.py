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
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = ROOT / "build" / "compare" / "parent"


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="step", required=True)
    sub.add_parser("unpack").add_argument("rev")
    p_run = sub.add_parser("run")
    p_run.add_argument("--out-dir", default="chiprun_out/compare")
    p_run.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if args.step == "unpack":
        return unpack(args.rev)
    return run(ROOT / args.out_dir, args.reps)


if __name__ == "__main__":
    sys.exit(main())

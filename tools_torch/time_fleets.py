#!/usr/bin/env python3
"""Time chip_smoke's phase 20 fleets (a) and (d) in one tree, on one card.

    python3 tools_torch/time_fleets.py [--root TREE] [--tag NAME]

imports ``chip_smoke.py`` and ``safeopt_torch`` of ``TREE`` (default:
this checkout; a second tree unpacked under the git-ignored ``build/``
compares two versions in one call), builds its kernels, runs phase 20
(a), the flagship fleet of 8 campaigns against 8 solo loops in float32
and float64, and (d), the swarm fleet of 4 campaigns against 4 solo
loops, with every check of the phase, and prints one line ``TIMES
{json}``: ms per fleet iteration and the solo loops' ms per iteration
summed, beside the card's name and power limit. Run the trees in the
order A B B A, each in a process of its own, so that a drift of the
card or the host shows in both alike.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--tag", default="tree")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops._build import library

    library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    grid64 = torch.tensor(linearly_spaced_combinations(
        [(-5.0, 5.0), (-5.0, 5.0)], 1000), dtype=torch.float64,
        device="cuda")
    kernels, per = cs.fleet_flagship_states()
    a = cs.run_fleet_case("(a) flagship", kernels, per, grid64, cs.FMIN,
                          cs.SCALING, cs.flag_objectives(), 32,
                          cs.FLEET_NOISE, smi)
    d = cs.drive_swarm_fleet(smi)
    print("TIMES " + json.dumps({
        "tag": args.tag, "root": root, "device": smi,
        "a_fleet_ms": a["float32"]["fleet_ms"],
        "a_solo_ms": a["float32"]["solo_ms"],
        "a64_fleet_ms": a["float64"]["fleet_ms"],
        "a64_solo_ms": a["float64"]["solo_ms"],
        "d_fleet_ms": d["fleet_ms"], "d_solo_ms": d["solo_ms"]}),
        flush=True)


if __name__ == "__main__":
    main()

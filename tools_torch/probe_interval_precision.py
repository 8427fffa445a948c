#!/usr/bin/env python3
"""Probe the interval kernels' float32 precision on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/probe_interval_precision.py
        [--out chiprun_out/interval_precision.json]

The port's counterpart of ``benchmarks/probe_interval_precision.py``, on
``measure.py``'s cap-512 state (two RBF GPs, 400 observations, capacity
512) over a 200k-row slice of its grid (``grid[::5]`` of the 1000 x 1000
grid on [-5, 5]^2). The oracle is the float64 plain path
(``fused_intervals_plain`` on the state built in float64). For each
float32 route, K1 (``fused_intervals``), B3 (``intervals_mu_from_gram``)
and B4 (``intervals_split``, one launch per GP) in bf16 and tf32 limbs,
it reports:

- the max scaled |dQ| over the columns (l_0, u_0, l_1, u_1), scaled by
  [sqrt 2, sqrt 2, 1, 1] (each GP's scaling, as the TPU probe);
- per GP, the ``l > fmin`` decisions (fmin 0.2 and 0.5, the flagship's)
  that differ from float64 where the float64 margin, scaled, is past
  1e-3, and the rows inside that band.

It gates nothing: it records what the card gives. Prints the card's
``nvidia-smi`` name and power limit and one JSON object, and writes it
to ``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import BAND, FMIN, SCALING, decisions_agree  # noqa: E402
from tools_torch.states import cap512_operands, one_gp  # noqa: E402


def routes(ops):
    """{route: (G, 2, N) float32 rows} of every float32 route."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {"K1_f32": fp.fused_intervals(*ops),
           "B3_f32": ie.intervals_mu_from_gram(*ops)}
    for limb in ie.LIMBS:
        out[f"B4_{limb}"] = torch.stack([
            ie.intervals_split(*one_gp(ops, g), limb=limb)
            for g in range(ops[2].shape[0])])
    return out


def probe(ops32, ops64):
    """The report of every route against the float64 plain rows."""
    from safeopt_torch.ops import fused_posterior as fp

    ref = fp.fused_intervals_plain(*ops64)
    scale = torch.tensor(SCALING, dtype=torch.float64, device=ref.device)
    fmin = torch.tensor(FMIN, dtype=torch.float64, device=ref.device)
    report = {}
    for name, q in routes(ops32).items():
        dq = (q.double() - ref).abs() / scale[:, None, None]
        decisions = []
        for g in range(ref.shape[0]):
            wrong, in_band = decisions_agree(q[g, 0].double(), ref[g, 0],
                                             fmin[g], scale[g])
            decisions.append({"fmin": FMIN[g], "differ_outside_band": wrong,
                              "rows_in_band": in_band})
        report[name] = {"max_scaled_dq": dq.max().item(),
                        "decisions": decisions}
    return report


def main():
    """Run the probe; returns the exit code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out",
                        default="chiprun_out/interval_precision.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_interval_precision: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from safeopt_torch import linearly_spaced_combinations

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    grid = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)],
                                        1000)[::5]
    report = {"nvidia_smi": smi, "rows": int(grid.shape[0]), "band": BAND,
              "routes": probe(cap512_operands(torch.float32, grid),
                              cap512_operands(torch.float64, grid))}
    print(json.dumps(report), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Probe the interval kernels' float32 precision on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools_torch/probe_interval_precision.py
        [--out chiprun_out/interval_precision.json]

The port's counterpart of ``benchmarks/probe_interval_precision.py``,
over five states, each on a 200k-row slice of its grid (every fifth
row):

- ``cap512``: ``measure.py``'s cap-512 state (the flagship's two RBF
  GPs, 400 observations from ``default_rng(512)`` in [-4, 4]^2,
  capacity 512) over the 1000 x 1000 grid on [-5, 5]^2;
- ``cap512_seed1``, ``cap512_seed2``: the same with the observations
  from ``default_rng(1)`` and ``default_rng(2)``;
- ``cap1024``: 600 observations from ``default_rng(1024)``, capacity
  1024 (the gram not resident in shared memory);
- ``contextual``: ``chip_smoke.py``'s contextual GPs (RBF x RBF, 240
  observations at context 0, capacity 256) over a 1e6-point parameter
  grid on [-3, 3] at context 0.

The oracle is the float64 plain path (``fused_intervals_plain`` or
``fused_intervals_plan_plain`` on the state built in float64). For each
float32 route, K1 or K2 (``fused_intervals``, ``fused_intervals_plan``)
and K1-3p or K2-3p (the three-pass bf16 product, the certified path's
interval pass), and on ``cap512`` also B3 (``intervals_mu_from_gram``),
B3-3p (the same with K1-3p's product: beside K1-3p's, how much of the
three-pass error comes through mu) and B4 (``intervals_split``, one
launch per GP) in bf16 and tf32 limbs, it reports:

- the max scaled |dQ| over the columns (l_g, u_g), each GP's scaled by
  its scaling ([sqrt 2, 1] on the flagship's GPs, the prior std sqrt 2
  on the contextual ones, as ``SafeOpt``'s 'auto');
- per GP, the ``l > fmin`` decisions that differ from float64 where the
  float64 margin, scaled, is past 1e-3, and the rows inside that band
  (fmin 0.2 and 0.5 on the flagship's GPs, 0.2 and 0.3 contextual).

``three_pass_ceiling`` is the largest max scaled |dQ| of the certified
path's three-pass routes (K1-3p, K2-3p) over the states: the noise
ceiling of
``interval_precision='high'``. It gates nothing: it records what the card
gives. Prints the card's ``nvidia-smi`` name and power limit and one JSON
object, and writes it to ``--out``.
"""

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BAND, CTX_FMIN, FMIN, SCALING,  # noqa: E402
                        context_gps, decisions_agree)
from tools_torch.states import BETA, build_gps, one_gp  # noqa: E402

STATES = {"cap512": (512, 400, 512), "cap512_seed1": (1, 400, 512),
          "cap512_seed2": (2, 400, 512), "cap1024": (1024, 600, 1024),
          "contextual": None}


def flagship_operands(seed, n_obs, cap, dtype, grid):
    """K1's operands of the flagship's GPs with ``n_obs`` observations
    from ``default_rng(seed)`` in [-4, 4]^2, over ``grid``."""
    from safeopt_torch.ops import fused_posterior as fp

    gps = build_gps(np.random.default_rng(seed), n_obs, cap, "cuda", dtype,
                    spread=4.0)
    return fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                                torch.tensor(grid, dtype=dtype,
                                             device="cuda"), BETA)


def k1_routes(ops, experiments):
    """{route: (G, 2, N) float32 rows} of K1's operands."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {"K1_f32": fp.fused_intervals(*ops),
           "K1-3p_bf16": fp.fused_intervals3(*ops)}
    if experiments:
        out["B3_f32"] = ie.intervals_mu_from_gram(*ops)
        out["B3-3p_f32"] = ie.intervals_mu_from_gram(*ops, three_pass=True)
        for limb in ie.LIMBS:
            out[f"B4_{limb}"] = torch.stack([
                ie.intervals_split(*one_gp(ops, g), limb=limb)
                for g in range(ops[2].shape[0])])
    return out


def report(routes, ref, fmin, scaling):
    """Each route's max scaled |dQ| and decisions against ``ref``."""
    scale = torch.tensor(scaling, dtype=torch.float64, device=ref.device)
    fmin_t = torch.tensor(fmin, dtype=torch.float64, device=ref.device)
    out = {}
    for name, q in routes.items():
        dq = (q.double() - ref).abs() / scale[:, None, None]
        decisions = []
        for g in range(ref.shape[0]):
            wrong, in_band = decisions_agree(q[g, 0].double(), ref[g, 0],
                                             fmin_t[g], scale[g])
            decisions.append({"fmin": fmin[g], "differ_outside_band": wrong,
                              "rows_in_band": in_band})
        out[name] = {"max_scaled_dq": dq.max().item(),
                     "decisions": decisions}
    return out


def probe_state(name, flagship_grid):
    """The report of every route of one state."""
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops import fused_posterior as fp

    if STATES[name] is not None:
        seed, n_obs, cap = STATES[name]
        ops32, ops64 = (flagship_operands(seed, n_obs, cap, dt,
                                          flagship_grid)
                        for dt in (torch.float32, torch.float64))
        return report(k1_routes(ops32, name == "cap512"),
                      fp.fused_intervals_plain(*ops64), FMIN, SCALING), int(
                          flagship_grid.shape[0])
    params = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)[::5]
    grid = np.hstack([params, np.zeros_like(params)])
    routes = {"K2_f32": [], "K2-3p_bf16": []}
    refs, scaling = [], []
    for g in range(2):
        ops = {}
        for dt in (torch.float32, torch.float64):
            gp = context_gps(2, 240, 256, "cuda", dt)[g]
            ops[dt] = fp.interval_plan_operands(
                gp.kern, gp.state, torch.tensor(grid, dtype=dt,
                                                device="cuda"), BETA)
        routes["K2_f32"].append(fp.fused_intervals_plan(*ops[torch.float32]))
        routes["K2-3p_bf16"].append(
            fp.fused_intervals_plan3(*ops[torch.float32]))
        refs.append(fp.fused_intervals_plan_plain(*ops[torch.float64]))
        scaling.append(math.sqrt(float(ops[torch.float64][7][1])))
    return report({k: torch.stack(v) for k, v in routes.items()},
                  torch.stack(refs), CTX_FMIN, scaling), int(grid.shape[0])


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
    states, ceiling = {}, 0.0
    for name in STATES:
        routes, rows = probe_state(name, grid)
        states[name] = {"rows": rows, "routes": routes}
        for route, r in routes.items():
            if route.startswith(("K1-3p", "K2-3p")):
                ceiling = max(ceiling, r["max_scaled_dq"])
        print(f"{name}: " + "; ".join(
            f"{route} {r['max_scaled_dq']:.3e} (outside the band "
            f"{[d['differ_outside_band'] for d in r['decisions']]})"
            for route, r in routes.items()), flush=True)
    report_ = {"nvidia_smi": smi, "band": BAND, "states": states,
               "three_pass_ceiling": ceiling}
    print(f"three_pass_ceiling {ceiling:.4e}", flush=True)
    print(json.dumps(report_), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report_, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

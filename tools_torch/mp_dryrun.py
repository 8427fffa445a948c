"""Two processes as two hosts: the port's hierarchical mesh across a real
process boundary.

The port's counterpart of ``tools/mp_dryrun.py``. Two localhost
processes join one ``gloo`` group (``tcp://localhost`` at a free port)
as the two "hosts" of a ``make_hier_mesh(2)`` mesh, (dcn, data, model) =
(2, 1, 1), and each asserts, inside its worker
(``tools_torch/sharding_checks.py``):

* the hierarchical sharded ``safeopt_step`` over the 333-row grid, split
  across both processes, equals the replicated step (S, M, G, the counts
  and ``next_idx``; Q within 1e-12);
* a campaign fleet split over the ``dcn`` axis (one campaign on each
  process) equals each campaign's solo ``run_safeopt_loop``.

Each worker prints one OK line per check; the run exits non-zero if a
check fails. On several cards the same code runs under ``torchrun`` with
``device_type='cuda'`` (NCCL).

    python3 tools_torch/mp_dryrun.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools_torch.sharding_checks import run_world  # noqa: E402

CHECKS = {"dryrun_hier": "hier mesh (2, 1, 1) step == replicated step",
          "dryrun_fleet_dcn": "fleet over dcn == solo runs"}


def run_two_process() -> dict:
    """Run both checks in a two-process world; ``{check: [error text or
    None per process]}``."""
    return run_world(2, list(CHECKS), verbose=True)


def main() -> int:
    """Run both checks and print one line per check and process."""
    out = run_two_process()
    failed = False
    for name, errors in out.items():
        for pid, err in enumerate(errors):
            if err:
                failed = True
                print(f"[p{pid}] {name} FAILED\n{err}")
            else:
                print(f"[p{pid}] {CHECKS[name]} OK across 2 processes")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

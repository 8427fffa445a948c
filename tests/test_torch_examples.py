"""Every script of ``examples_torch/`` end to end on the CPU.

The port's counterpart of ``tests/test_examples.py``, with its twelve
cases and their iteration counts: each script runs in-process (runpy,
patched argv) with ``--device cpu``, and the checks inside the scripts
(every query safe, the tuning improves on its seed, a resumed campaign
equal to an uninterrupted one, pipelined equal to blocking) are the
oracles. No script imports jax or safeopt_tpu.
"""

import os
import runpy
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples_torch")

CASES = [
    ("example_1d.py", ("--algo", "grid", "--iters", "4")),
    ("example_1d.py", ("--algo", "swarm", "--iters", "3")),
    ("example_2d.py", ("--iters", "3")),
    ("example_multiple_constraints.py", ("--iters", "4")),
    ("example_context.py", ("--iters", "2")),
    ("example_on_device_loop.py", ("--iters", "4")),
    ("example_pendulum_tuning.py", ("--iters", "8")),
    ("example_pendulum_tuning.py", ("--iters", "3", "--fleet", "8")),
    ("example_campaign_fleet.py", ("--iters", "3")),
    ("example_long_campaign.py", ("--n-pre", "60", "--iters", "6",
                                  "--inducing", "9")),
    ("example_quasi_periodic.py", ("--iters", "8", "--refit-every", "4")),
    ("example_pipelined_campaign.py", ("--iters", "5", "--dim", "3")),
]
IDS = ["1d-grid", "1d-swarm", "2d", "multi-constraint", "context",
       "on-device-loop", "pendulum", "pendulum-fleet", "campaign-fleet",
       "long-campaign", "quasi-periodic", "pipelined-campaign"]


def _run(script, *argv):
    old = sys.argv
    sys.argv = [script] + list(argv)
    try:
        runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    except SystemExit as e:  # some examples end with sys.exit(0)
        assert not e.code, f"{script} exited with {e.code}"
    finally:
        sys.argv = old


@pytest.mark.parametrize("script,argv", CASES, ids=IDS)
def test_example_runs(script, argv, capsys):
    _run(script, *argv, "--device", "cpu")
    out = capsys.readouterr().out
    assert ("best" in out) or ("fleet" in out)


def test_examples_import_neither_jax_nor_safeopt_tpu():
    for name in sorted(os.listdir(EXAMPLES)):
        if name.endswith(".py"):
            with open(os.path.join(EXAMPLES, name)) as f:
                src = f.read()
            assert "import jax" not in src and "safeopt_tpu" not in src, \
                name

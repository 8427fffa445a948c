"""The port's CPU route on torch's intra-op thread pool.

On CPU tensors the kernels' wrappers run their plain PyTorch versions,
and the tests hold those bit for bit. A torch built with MKL takes
float32 exp and sqrt there from MKL's vector math library, and where the
first such call of a process ran on several threads at once, one
thread's share of it could come out about 1.5e-4 off (relative) in some
processes. ``safeopt_torch.config`` makes a first call on one thread
when the package is imported. The check runs in fresh processes,
because only a process's first vector-math call is at risk.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROCESSES = 6
# a process that imports the package, then takes float32 exp and sqrt of
# 8M values on its intra-op threads and on one: exit 1 where they differ
PROBE = """
import torch
import safeopt_torch  # noqa: F401
x = torch.linspace(-20.0, 0.0, 1 << 23)
pool = (torch.exp(x), torch.sqrt(-x))
torch.set_num_threads(1)
one = (torch.exp(x), torch.sqrt(-x))
raise SystemExit(0 if all(map(torch.equal, pool, one)) else 1)
"""


def test_pool_threads_give_one_threads_float32_exp_and_sqrt():
    """In each of several fresh processes that import the package, every
    pool thread's share of the first float32 exp and sqrt equals one
    thread's result, bit for bit."""
    procs = [subprocess.Popen([sys.executable, "-c", PROBE], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(PROCESSES)]
    results = [(p.wait(timeout=300), p.stdout.read()) for p in procs]
    assert all(rc == 0 for rc, _ in results), results

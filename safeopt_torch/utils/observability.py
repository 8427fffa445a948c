"""Structured per-iteration stats and profiler hooks.

Counterpart of ``safeopt_tpu/utils/observability.py``: every
``SafeOpt.optimize()`` records one ``IterationStats`` from scalars the
host already pulled, the certified path's telemetry among them, and
every fused ``SafeOptSwarm.optimize()`` one ``SwarmIterationStats``
(with its CUDA graph's captures and replays).
``host_syncs`` counts the host's reads of device values (each waits for
the device), so that a step's or a loop iteration's syncs can be read
as the difference of two counts. ``profile_trace`` wraps
``torch.profiler`` (the card's kernels through CUPTI when one is
present) and writes a Chrome trace of the enclosed block; ``timed`` is
a wall-clock timer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import List, Optional

import torch

__all__ = ["IterationStats", "SwarmIterationStats", "StatsRecorder",
           "SyncCounter", "host_syncs", "profile_trace", "timed"]

logger = logging.getLogger("safeopt_torch")


@dataclasses.dataclass
class IterationStats:
    """One optimize() iteration's diagnostics."""

    t: int                      # time step (observation count)
    duration_s: float           # wall clock of the step, host pull included
    safe_count: int             # |S|
    maximizer_count: int        # |M|
    expander_found: bool        # G nonempty
    next_index: Optional[int]   # chosen grid index
    beta: float
    walk_chunks: int = 0        # candidate chunks the expander walk tested
    # certified-path telemetry (exact_boundaries runs only; zeros
    # otherwise): rows inside the float64 band, float32 verdicts the
    # oracle overturned, whether the band overflowed the triage budget
    # (the rows past it are decided by their float32 intervals), and
    # whether the refinement band overflowed its budget, so that the
    # step recomputed every row at full float32
    band_population: int = 0
    certified_corrections: int = 0
    band_overflow: bool = False
    refine_full_pass: bool = False
    # GPs whose kernel no grid kernel takes (the eager route), and the
    # host's reads of device values from dispatch to result()
    eager_gps: int = 0
    host_syncs: int = 0

    def as_dict(self):
        """Plain-dict view (for logging/JSON sinks)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SwarmIterationStats:
    """One fused ``SafeOptSwarm.optimize()`` iteration's diagnostics."""

    t: int                      # time step (observation count)
    duration_s: float           # dispatch to result(), the pull included
    safe_count: int             # |S| after the iteration
    num_added: int              # safe-set growth (maximizers + expanders)
    num_pruned: int             # safe points pruned (all three swarms)
    beta: float
    graph: bool                 # the iteration replayed a CUDA graph
    graph_captures: int         # the optimizer's graph captures so far
    graph_replays: int          # its graph replays so far
    host_syncs: int             # host reads of device values, dispatch
    #                             to result()

    def as_dict(self):
        """Plain-dict view (for logging/JSON sinks)."""
        return dataclasses.asdict(self)


class SyncCounter:
    """A running count of host reads of device values: the expander
    walk's candidate count and per-chunk flags, the exact top-k's
    data-dependent sizes, the refinement's band population and the
    steps' packed pulls."""

    def __init__(self):
        self.count = 0

    def add(self, n: int = 1) -> None:
        """Count ``n`` more reads."""
        self.count += n


host_syncs = SyncCounter()


class StatsRecorder:
    """Ring buffer of per-iteration stats with logging passthrough."""

    def __init__(self, maxlen: int = 1000):
        self.maxlen = maxlen
        self.history: List[IterationStats] = []

    def record(self, stats: IterationStats) -> None:
        """Append one iteration's stats (evicts past ``maxlen``)."""
        self.history.append(stats)
        if len(self.history) > self.maxlen:
            self.history.pop(0)
        logger.debug("iteration stats: %s", stats)

    @property
    def last(self) -> Optional[IterationStats]:
        """Most recent iteration's stats (None before any record)."""
        return self.history[-1] if self.history else None

    def summary(self) -> dict:
        """Aggregate view: iteration count, mean step time, last |S|."""
        if not self.history:
            return {}
        times = [s.duration_s for s in self.history]
        return {
            "iterations": len(self.history),
            "mean_step_s": sum(times) / len(times),
            "last_safe_count": self.history[-1].safe_count,
        }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write it as a Chrome trace,
    ``log_dir/trace.json`` (``chrome://tracing``, Perfetto, TensorBoard's
    profiler). Yields the profiler, whose ``key_averages()`` sum the
    events by name. The counterpart of the JAX package's
    ``jax.profiler`` trace.

    Usage::

        with profile_trace("/tmp/trace"):
            opt.optimize()
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        # the trace holds the block's device work: none of it in flight
        # at the start, all of it finished at the end
        if cuda:
            torch.cuda.synchronize()
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed():
    """Tiny wall-clock timer: ``with timed() as t: ...; t()`` -> seconds."""
    start = time.perf_counter()
    elapsed = [None]

    def read():
        return (elapsed[0] if elapsed[0] is not None
                else time.perf_counter() - start)

    try:
        yield read
    finally:
        elapsed[0] = time.perf_counter() - start

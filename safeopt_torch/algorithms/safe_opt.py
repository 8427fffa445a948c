"""SafeOpt: exact safe Bayesian optimization on a discretized grid.

Counterpart of ``safeopt_tpu/algorithms/safe_opt.py:248-995``. The
public surface — constructor, ``optimize(context, ucb)``,
``get_maximum(context)``, ``compute_sets``, ``compute_safe_set``,
``get_new_query_point``, ``update_confidence_intervals``, the
``S``/``M``/``G``/``Q`` attributes and the Lipschitz variant — matches
the reference; the O(N) grid work runs in ``safe_opt_core`` on the
models' device.

The device comes from the GPs: every GP must live on the same device
with the same dtype, and the grid is shipped there once. The certified
path (``exact_boundaries``) settles every safe bit near a threshold in
float64, on the host (``oracle='host'``) or on the device
(``'device'``); ``interval_precision='high'`` runs its grid pass with
the three-pass product (K1-3p, K2-3p) and restores full float32 on the
decision-critical rows. ``interval_precision='auto'`` resolves to the
plain path: the JAX package's promotion of the certified path at
capacity 512 rests on a TPU measurement, not one of this card.

``optimize_async`` dispatches a step and returns a
``PendingSafeOptStep`` whose ``result()`` reads the step's packed
diagnostics; ``optimize()`` is ``optimize_async().result()``. What the
dispatch leaves in flight is the selection's tail and the copy of the
diagnostics into a pinned host buffer (an event marks its end); the
expander walk still reads its candidate count and each chunk's flag on
the host, the refinement its band population, and the host-oracle
certified step its packed band, so the dispatch returns after them.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..utils.observability import IterationStats, StatsRecorder, host_syncs
from .base import GaussianProcessOptimization
from .safe_opt_core import (certified_finish, certified_scan, device_oracle,
                            eager_gps, full_expander_sets, interval_scan,
                            safe_maximum, safeopt_step, safeopt_step_from_Q)

__all__ = ["SafeOpt", "PendingSafeOptStep"]

# Max scaled interval error of each reduced-precision mode, measured on
# one H100 80GB HBM3 at 700 W by tools_torch/probe_interval_precision.py:
# the three-pass bf16 product (K1-3p, K2-3p) against the float64 plain
# path over five states, the largest on the contextual one (1.3348e-2;
# the cap-512 and cap-1024 states 6.2e-3 to 8.2e-3; PERF.md).
# Never the TPU's figure. refine_band must exceed boundary_band by at
# least this much, or a knife-edge row can escape both the refinement
# and the float64 oracle.
_REDUCED_PRECISION_NOISE_CEILING = {"high": 1.335e-2}
# The refinement band's default, re-derived from that measurement: about
# 1.4 x (boundary_band + ceiling).
REFINE_BAND = 2e-2
# The refinement budget's default as a share of the grid's N rows. The
# refinement recomputes its rows with the full-float32 K1/K2, so B rows
# cost about B / N of a full float32 pass, and the three-pass grid pass
# saves (K1 - K1-3p) / K1 of one: 0.548 at cap 512 (K1-3p 4.8175 ms
# against K1's 10.6518 ms in one run of tools_torch/measure.py on one
# H100 80GB HBM3 at 700 W, PERF.md; K2-3p's saving on the contextual GP
# is 0.349 of K2). Past that share of the grid, refining the band costs
# more than the full pass the step then takes instead.
REFINE_BAND_SHARE = 0.55

# Sentinel distinguishing "keep the current context" from an explicit
# ``context=None`` (an error with num_contexts > 0, gp_opt.py:445-447).
_KEEP_CONTEXT = object()


class PendingSafeOptStep:
    """Handle of a dispatched SafeOpt iteration (``optimize_async``).

    The step's packed diagnostics are copied into a pinned host buffer
    without blocking, and a CUDA event is recorded after the copy;
    ``result()`` waits on that event, records the iteration's stats and
    returns the next query point, raising ``EnvironmentError`` on an
    empty safe set. It is idempotent. Finish pending steps in dispatch
    order: the stats commit at ``result()``.
    """

    def __init__(self, opt, result, diag, start, syncs):
        self._opt, self._res, self._start = opt, result, start
        self._syncs = syncs
        self._x = None
        self._done = False
        # the host-oracle step's pass 1 hands over the copy it read
        self._read = diag is not None and diag is result.diag
        buf = result.diag if diag is None else diag
        self._event = None
        if buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(buf.device))
            buf = host
        self._diag = buf

    def result(self) -> np.ndarray:
        """Wait for the diagnostics, record the stats and return the next
        query point (idempotent)."""
        if not self._done:
            if self._event is not None:
                self._event.synchronize()
            if not self._read:
                host_syncs.add()
            self._x = self._opt._finish_step(
                self._res, self._diag, self._start,
                self._syncs + (not self._read))
            self._done = True
        return self._x


class SafeOpt(GaussianProcessOptimization):
    """Safe Bayesian optimization over a discrete candidate set.

    Implements SafeOpt (Sui et al. 2015; Berkenkamp et al. 2016): keep a
    set of certified-safe candidates, and at each step query the most
    uncertain point among the potential maximizers and the potential
    safe-set expanders.

    Parameters
    ----------
    gp : GPRegression or list
        Objective GP first, then one GP per safety constraint; all on
        one device, with one dtype.
    parameter_set : array or tensor (N, d)
        Discrete candidate inputs (``linearly_spaced_combinations``).
        A tensor must lie on the GPs' device.
    fmin : float or list of floats
        Safety threshold per GP (``-inf`` = unconstrained).
    lipschitz : float or list of floats, optional
        Lipschitz constants; when given, the expander test uses the
        Lipschitz bound instead of virtual GP observations.
    beta : float or callable
    num_contexts : int
        Trailing context dimensions appended to every candidate.
    threshold : float or list of floats
    scaling : 'auto' or list of floats
    expander_chunk : int
        Candidates the expander walk tests per grid pass.
    exact_boundaries : bool, optional
        Certify safe-set decisions in float64: candidates whose scaled
        safety margin falls inside ``boundary_band`` are recomputed
        against the host's float64 factor and their safe bits overridden
        before maximizers, expanders and the query are derived. Default
        ``None``: implied by ``interval_precision``, else off. Needs
        models with a float64 oracle (``predict_f64``).
    boundary_band : float
        Scaled-margin width of the certification band (default 1e-3).
    boundary_k : int, optional
        Triage budget: at most this many near-boundary rows are certified
        per iteration (an overflow logs a warning). Default 1024.
    interval_precision : str, optional
        ``'high'``: the grid pass takes the three-pass bf16 product
        (K1-3p, K2-3p), then every row within ``refine_band`` of a
        decision boundary is recomputed at full float32 before anything
        is classified; requires ``exact_boundaries``. ``None`` or
        ``'auto'`` (the default): the full-float32 grid pass.
    refine_k : int, optional
        Size of the refinement's head over safe rows (width, incumbent
        and maximizer boundaries); default 2048 under
        ``interval_precision``, else 0. ``refine_k=0`` keeps safe-set
        decisions certified but may change near-tie queries (a warning
        says so).
    refine_band : float
        Scaled radius around every decision boundary within which rows
        are promised full float32 (default 2e-2; the JAX package's 1e-2
        is sized to the TPU's error); it must be at least
        ``boundary_band``, and exceed it by the three-pass noise ceiling
        (``_REDUCED_PRECISION_NOISE_CEILING``) or a warning is logged.
    refine_band_k : int, optional
        Budget of near-boundary rows restored to full float32 (default
        ``None``: 0.55 of the grid, ``REFINE_BAND_SHARE``; the JAX
        package's default is 20480); past it (``refine_band_k +
        refine_k``) the step recomputes every row at full float32 instead
        (``safe_opt_core._refine_Q``; the JAX package refines the budget's
        rows and warns), reported in the stats as ``refine_full_pass``.
    oracle : str
        Where the float64 oracle runs: ``'host'`` (``predict_f64`` on the
        host factor; a flip costs a second classification pass),
        ``'device'`` (the same float64 factors on the models' device,
        ``safe_opt_core.device_oracle``, one classification and one host
        read per step), or ``'auto'`` (default: ``'device'`` on CUDA,
        ``'host'`` on the CPU).
    """

    def __init__(self, gp, parameter_set, fmin, lipschitz=None, beta=2,
                 num_contexts=0, threshold=0, scaling="auto",
                 expander_chunk: int = 32, exact_boundaries=None,
                 boundary_band: float = 1e-3, boundary_k=None,
                 interval_precision="auto", refine_k=None,
                 refine_band: float = REFINE_BAND, refine_band_k=None,
                 oracle: str = "auto"):
        super().__init__(gp, fmin=fmin, beta=beta,
                         num_contexts=num_contexts, threshold=threshold,
                         scaling=scaling)

        places = {(g.device, g.dtype) for g in self.gps}
        if len(places) != 1:
            raise ValueError("all GPs must share one device and dtype, got "
                             f"{sorted(map(str, places))}")
        self.device, self.dtype = places.pop()
        if torch.is_tensor(parameter_set):
            if parameter_set.device != self.device:
                raise ValueError(
                    f"parameter_set is on {parameter_set.device}, the GPs "
                    f"on {self.device}")
            parameter_set = parameter_set.detach().cpu().numpy()

        # Certified settings, resolved in the JAX package's order:
        # explicit values win; 'auto' is the plain path here; a reduced
        # precision implies the float64 certification it needs.
        if interval_precision == "auto":
            interval_precision = None
        if interval_precision not in (None, "high"):
            raise ValueError(
                "interval_precision must be 'auto', None or 'high', got "
                f"{interval_precision!r} (the JAX package's 1-pass bf16 "
                "'default' has no kernel in the port)")
        if interval_precision is not None and exact_boundaries is None:
            exact_boundaries = True
        exact_boundaries = bool(exact_boundaries)

        parameter_set = np.asarray(parameter_set, dtype=float)
        if self.num_contexts > 0:
            ctx = np.zeros((parameter_set.shape[0], self.num_contexts))
            self.inputs = np.hstack((parameter_set, ctx))
            self.parameter_set = self.inputs[:, : -self.num_contexts]
        else:
            self.inputs = parameter_set
            self.parameter_set = parameter_set

        self.lipschitz = lipschitz
        if self.lipschitz is not None:
            if not isinstance(self.lipschitz, list):
                self.lipschitz = [self.lipschitz] * len(self.gps)
            self.lipschitz = np.atleast_1d(
                np.asarray(self.lipschitz, dtype=float).squeeze())
        self._use_lipschitz = self.lipschitz is not None

        N = self.inputs.shape[0]
        num_gps = len(self.gps)
        # Host mirrors of the device results are copied lazily, on first
        # read: Q alone is 16 MB at a 1e6-point grid.
        self._dev = None
        self._host_cache = {
            "Q": np.zeros((N, 2 * num_gps)),
            "S": np.zeros(N, dtype=bool),
            "M": np.zeros(N, dtype=bool),
            "G": np.zeros(N, dtype=bool),
        }
        self._expander_chunk = min(int(expander_chunk), N)
        self._grid_device = None   # device copy of inputs, shipped lazily
        self._grid_dirty = True
        self._grid64_device = None  # float64 copy for the device oracle
        self._grid64_dirty = True
        self._consts_key = None

        self._exact_boundaries = exact_boundaries
        self._boundary_band = float(boundary_band)
        self._boundary_k = min(int(1024 if boundary_k is None
                                   else boundary_k), N)
        if oracle not in ("auto", "host", "device"):
            raise ValueError("oracle must be 'auto', 'host' or 'device', "
                             f"got {oracle!r}")
        has_dev_oracle = all(hasattr(g, "device_oracle_state")
                             for g in self.gps)
        if oracle == "auto":
            oracle = ("device" if self.device.type == "cuda"
                      and has_dev_oracle else "host")
        elif oracle == "device" and not has_dev_oracle:
            raise ValueError(
                "oracle='device' requires models exposing "
                "device_oracle_state (GPRegression, SparseGPRegression)")
        self._oracle = oracle
        self._interval_precision = interval_precision
        if refine_k is None:
            refine_k = 2048 if interval_precision is not None else 0
        elif refine_k == 0 and interval_precision is not None:
            logging.warning(
                "interval_precision with refine_k=0: safe-set decisions "
                "stay float64-certified, but near-tie query selections may "
                "differ from the full-precision trajectory")
        self._refine_k = min(int(refine_k), N)
        self._refine_band = float(refine_band)
        if refine_band_k is None:
            refine_band_k = int(N * REFINE_BAND_SHARE)
        self._refine_band_k = min(int(refine_band_k), N)
        if interval_precision is not None and not exact_boundaries:
            raise ValueError(
                "interval_precision requires exact_boundaries=True: "
                "reduced-precision intervals are only safe under float64 "
                "boundary certification")
        if (interval_precision is not None
                and self._refine_band < self._boundary_band):
            # the float64 triage runs over the refined rows, which the
            # refine band selects: a narrower one would hide band rows
            raise ValueError(
                f"refine_band ({self._refine_band}) must be >= "
                f"boundary_band ({self._boundary_band}) so the refined "
                "subset covers every possible float64-band row")
        if interval_precision is not None:
            ceiling = _REDUCED_PRECISION_NOISE_CEILING[interval_precision]
            if self._refine_band - self._boundary_band < ceiling:
                logging.warning(
                    "interval_precision=%r: refine_band (%g) minus "
                    "boundary_band (%g) is below the measured noise "
                    "ceiling (%g) of the three-pass intervals; a "
                    "knife-edge row can escape both the refinement and "
                    "the float64 oracle", interval_precision,
                    self._refine_band, self._boundary_band, ceiling)
        if exact_boundaries:
            for g in self.gps:
                if not hasattr(g, "predict_f64"):
                    raise ValueError(
                        "exact_boundaries requires models with a float64 "
                        "host oracle (predict_f64: GPRegression, "
                        "SparseGPRegression): "
                        f"{type(g).__name__} has none")

        # certified-path telemetry (filled by the certified steps)
        self._band_overflow = False
        self._band_population = 0
        self._certified_corrections = 0
        self._refine_band_population = 0
        self._refine_band_overflow = False
        self._eager_gps = 0
        self.stats = StatsRecorder()

    # -- properties mirrored from the reference ------------------------------

    @property
    def use_lipschitz(self) -> bool:
        """Whether the expander test uses the Lipschitz constant."""
        return self._use_lipschitz

    @use_lipschitz.setter
    def use_lipschitz(self, value: bool):
        if value and self.lipschitz is None:
            raise ValueError("Lipschitz constant not defined")
        self._use_lipschitz = bool(value)

    @property
    def parameter_set(self):
        """Discrete parameter candidates (context columns excluded)."""
        return self._parameter_set

    @parameter_set.setter
    def parameter_set(self, parameter_set):
        self._parameter_set = parameter_set
        self.bounds = list(zip(np.min(parameter_set, axis=0),
                               np.max(parameter_set, axis=0)))
        self.num_samples = [len(np.unique(parameter_set[:, i]))
                            for i in range(parameter_set.shape[1])]

    @property
    def context_fixed_inputs(self):
        """Fixed-input pairs pinning the current context (for plotting)."""
        n = self.gp.input_dim - 1
        nc = self.num_contexts
        if nc > 0:
            contexts = self.inputs[0, -nc:]
            return list(zip(range(n, n - nc, -1), contexts))

    @property
    def context(self):
        """Current context columns of the candidate grid."""
        if self.num_contexts:
            return self.inputs[0, -self.num_contexts:]

    @context.setter
    def context(self, context):
        if self.num_contexts:
            if context is None:
                raise ValueError("Need to provide value for context.")
            self.inputs[:, -self.num_contexts:] = context
            self._grid_dirty = self._grid64_dirty = True

    # -- lazy host mirrors of device results ---------------------------------

    def _mirror(self, name: str) -> np.ndarray:
        v = self._host_cache[name]
        if v is None:
            v = getattr(self._dev, name)
        if torch.is_tensor(v):
            v = v.cpu().numpy()        # device-to-host copy happens HERE
        self._host_cache[name] = v
        return v

    def _set_mirror(self, name: str, value) -> None:
        self._host_cache[name] = value

    Q = property(lambda self: self._mirror("Q"),
                 lambda self, v: self._set_mirror("Q", v),
                 doc="(N, 2G) confidence intervals [l0, u0, l1, u1, ...]"
                     " (lazy host mirror of the device result).")
    S = property(lambda self: self._mirror("S"),
                 lambda self, v: self._set_mirror("S", v),
                 doc="(N,) safe mask (lazy host mirror).")
    M = property(lambda self: self._mirror("M"),
                 lambda self, v: self._set_mirror("M", v),
                 doc="(N,) potential-maximizer mask (lazy host mirror).")
    G = property(lambda self: self._mirror("G"),
                 lambda self, v: self._set_mirror("G", v),
                 doc="(N,) potential-expander mask (lazy host mirror).")

    # -- device plumbing ------------------------------------------------------

    def _grid(self) -> torch.Tensor:
        if self._grid_dirty or self._grid_device is None:
            self._grid_device = torch.tensor(self.inputs, dtype=self.dtype,
                                             device=self.device)
            self._grid_dirty = False
        return self._grid_device

    def _model_args(self):
        return (tuple(g.kern for g in self.gps),
                tuple(g.state for g in self.gps))

    def _step_consts(self) -> dict:
        """Iteration-invariant step operands on the device, shipped once
        and re-shipped only when the host values change."""
        th = np.broadcast_to(np.asarray(self.threshold, dtype=float),
                             (len(self.gps),))
        values = dict(
            fmin=np.atleast_1d(np.asarray(self.fmin, dtype=float)),
            scaling=np.atleast_1d(np.asarray(self.scaling, dtype=float)),
            threshold=th,
            lipschitz=(None if self.lipschitz is None else
                       np.atleast_1d(np.asarray(self.lipschitz,
                                                dtype=float))))
        key = tuple(None if v is None else tuple(v.tolist())
                    for v in values.values())
        if self._consts_key != key:
            self._consts_key = key
            self._consts = {
                name: None if v is None else torch.tensor(
                    v, dtype=self.dtype, device=self.device)
                for name, v in values.items()}
        return self._consts

    def _certified_step(self, kernels, states, ucb: bool):
        """Optimistic certified iteration with the host oracle.

        Pass 1 (``certified_scan``): the complete step plus the triage of
        the <= k rows whose scaled safety margin lies inside the band,
        read as one packed buffer. If the band is empty, or the host's
        float64 oracle confirms every float32 verdict in it, pass 1 is
        the certified result. Only a flipped verdict costs pass 2
        (``safeopt_step_from_Q``) with the float64 bits written in.
        Records the telemetry. Returns ``(result, diag)``: when pass 1
        stands, ``diag`` is the host copy already read, else None (pass
        2's ``result.diag`` is read at ``result()``).
        """
        k = self._boundary_k
        consts = self._step_consts()
        beta = float(self.beta(self.t))
        result, packed = certified_scan(
            kernels, states, self._grid(), consts["fmin"], beta,
            consts["scaling"], consts["threshold"], self._boundary_band,
            consts["lipschitz"], refine_band=self._refine_band, k=k,
            refine_k=self._refine_k,
            refine_band_k=(self._refine_band_k
                           if self._interval_precision is not None else 0),
            ucb=ucb, use_lipschitz=self._use_lipschitz,
            chunk=self._expander_chunk,
            interval_precision=self._interval_precision)
        packed = packed.cpu()                      # the one host read
        host_syncs.add()
        result = result._replace(diag=packed[:5])
        packed = packed.numpy()
        idx = packed[7:7 + k]
        within = packed[7 + k:7 + 2 * k].astype(bool)
        s_f32 = packed[7 + 2 * k:7 + 3 * k].astype(bool)
        self._absorb_triage(int(packed[5]), int(packed[6]))

        sel = np.flatnonzero(within)
        self._band_population = int(sel.size)
        self._certified_corrections = 0
        if sel.size == 0:
            return result, result.diag
        pts = self.inputs[idx[sel]]
        safe64 = np.ones(sel.size, dtype=bool)
        for i, g in enumerate(self.gps):
            if self.fmin[i] == -np.inf:
                continue
            mu, var = g.predict_f64(pts)
            safe64 &= mu - beta * np.sqrt(var) > self.fmin[i]
        flips = int(np.count_nonzero(safe64 != s_f32[sel]))
        self._certified_corrections = flips
        if flips == 0:
            # every float32 verdict confirmed: pass 1 is the step
            return result, result.diag
        fix_idx = np.where(within, idx, -1).astype(np.int32)
        fix_bits = np.zeros(k, dtype=bool)
        fix_bits[sel] = safe64
        corrected = safeopt_step_from_Q(
            kernels, states, self._grid(), result.Q,
            torch.tensor(fix_idx, device=self.device),
            torch.tensor(fix_bits, device=self.device), consts["fmin"],
            beta, consts["scaling"], consts["threshold"],
            consts["lipschitz"], ucb=ucb, use_lipschitz=self._use_lipschitz,
            chunk=self._expander_chunk)
        return corrected, None

    def _certified_step_device(self, kernels, states, ucb: bool):
        """Certified iteration settled on the device: ``interval_scan``
        (intervals, refinement, triage; no classification),
        ``device_oracle`` (float64 verdicts of the band rows against each
        model's ``OracleState``) and ``certified_finish`` (one
        classification with the settled bits). Besides the expander
        walk's per-chunk flags and the refinement's band population
        (``_refine_Q`` reads it to choose between the refined rows and a
        full float32 pass), the host reads one 9-int buffer, the step's
        results and telemetry. Returns ``(result, diag9)`` with ``diag9``
        on the device: its read and the telemetry wait for ``result()``
        (``_absorb_diag9``)."""
        k = self._boundary_k
        consts = self._step_consts()
        beta = float(self.beta(self.t))
        grid = self._grid()
        Q, packed_t = interval_scan(
            kernels, states, grid, consts["fmin"], beta, consts["scaling"],
            self._boundary_band, refine_band=self._refine_band, k=k,
            refine_k=self._refine_k,
            refine_band_k=(self._refine_band_k
                           if self._interval_precision is not None else 0),
            interval_precision=self._interval_precision)
        ostates, kinds = zip(*(g.device_oracle_state() for g in self.gps))
        if self._grid64_device is None or self._grid64_dirty:
            # the oracle evaluates the user's float64 points: a float32
            # grid's rounding moves a lower bound by ~1e-8, more than a
            # knife edge
            self._grid64_device = torch.tensor(self.inputs,
                                               dtype=torch.float64,
                                               device=self.device)
            self._grid64_dirty = False
        fmin64 = torch.tensor(np.atleast_1d(np.asarray(self.fmin,
                                                       dtype=np.float64)),
                              device=self.device)
        fix_idx, fix_bits, flips, n_within = device_oracle(
            kernels, ostates, self._grid64_device, Q, packed_t, fmin64, beta,
            kinds=kinds, constrained=tuple(bool(np.isfinite(f))
                              for f in np.atleast_1d(self.fmin)), k=k)
        result, diag9 = certified_finish(
            kernels, states, grid, Q, packed_t, fix_idx, fix_bits, flips,
            n_within, consts["fmin"], beta, consts["scaling"],
            consts["threshold"], consts["lipschitz"], ucb=ucb,
            use_lipschitz=self._use_lipschitz, chunk=self._expander_chunk)
        return result, diag9

    def _absorb_diag9(self, diag9) -> None:
        """Record the device-oracle step's telemetry from the host copy of
        its 9-int buffer."""
        flips, total, refine_pop, n_within = diag9[5:9].tolist()
        self._absorb_triage(total, refine_pop)
        self._band_population = n_within
        self._certified_corrections = flips

    def _absorb_triage(self, total: int, refine_pop: int) -> None:
        """Record the triage's and the refinement's populations, warning
        where a budget overflowed."""
        k = self._boundary_k
        if total > k:
            logging.warning(
                "exact_boundaries: %d candidates inside the ambiguity band "
                "exceed the triage budget k=%d; only the k closest to a "
                "threshold were certified", total, k)
        self._band_overflow = total > k
        self._refine_band_population = refine_pop
        # one selection budget for every boundary's band (_refine_Q);
        # past it the step took a full-float32 pass instead
        budget = min(self._refine_band_k + self._refine_k,
                     self.inputs.shape[0])
        self._refine_band_overflow = (self._interval_precision is not None
                                      and refine_pop > budget)
        if self._refine_band_overflow:
            logging.info(
                "interval_precision: %d rows inside the refinement band "
                "exceed the refine budget %d (refine_band_k + refine_k); "
                "the intervals were recomputed at full float32",
                refine_pop, budget)

    def _run_step(self, context=_KEEP_CONTEXT, ucb: bool = False):
        """Execute the device step and point the host mirrors at it.
        Returns ``(StepResult, diag)``: ``diag`` None where the result's
        own ``diag`` is to be read, the host copy the host-oracle step
        read already, or the device-oracle step's 9-int buffer."""
        if context is not _KEEP_CONTEXT:
            self.context = context
        kernels, states = self._model_args()
        self._eager_gps = eager_gps(kernels, states, self.inputs.shape[1])
        diag = None
        if self._exact_boundaries:
            step = (self._certified_step_device if self._oracle == "device"
                    else self._certified_step)
            result, diag = step(kernels, states, ucb)
        else:
            consts = self._step_consts()
            result = safeopt_step(
                kernels, states, self._grid(), consts["fmin"],
                float(self.beta(self.t)), consts["scaling"],
                consts["threshold"], consts["lipschitz"], ucb=ucb,
                use_lipschitz=self._use_lipschitz,
                chunk=self._expander_chunk)
        if ucb and self._dev is not None:
            # ucb never recomputes M/G (the reference leaves them stale,
            # gp_opt.py:670-675): pin them to the previous result
            self._host_cache["M"] = self._mirror("M")
            self._host_cache["G"] = self._mirror("G")
        self._dev = result
        self._host_cache["Q"] = None
        self._host_cache["S"] = None
        if not ucb:
            self._host_cache["M"] = None
            self._host_cache["G"] = None
        return result, diag

    # -- reference API -------------------------------------------------------

    def update_confidence_intervals(self, context=None) -> None:
        """Recompute Q from the current GP posteriors; S/M/G keep their
        values until ``compute_safe_set`` / ``compute_sets`` run
        (gp_opt.py:453-476)."""
        S_old = self.S
        M_old, G_old = self.M, self.G
        self._run_step(context=context, ucb=True)
        self._host_cache["S"] = S_old
        self._host_cache["M"] = M_old
        self._host_cache["G"] = G_old

    def compute_safe_set(self) -> None:
        """Recompute only the safe set from current Q."""
        self.S = np.all(self.Q[:, ::2] > self.fmin, axis=1)

    def compute_sets(self, full_sets: bool = False) -> None:
        """Recompute S, M and G from the current GP posteriors.

        ``full_sets=True`` evaluates the expander predicate for every
        safe point (plotting only), reference gp_opt.py:527-555.
        """
        if full_sets:
            kernels, states = self._model_args()
            consts = self._step_consts()
            result = full_expander_sets(
                kernels, states, self._grid(), consts["fmin"],
                float(self.beta(self.t)), consts["scaling"],
                consts["lipschitz"], use_lipschitz=self._use_lipschitz,
                chunk=self._expander_chunk)
        else:
            result, _ = self._run_step(ucb=False)
        self._dev = result
        for name in ("Q", "S", "M", "G"):
            self._host_cache[name] = None

    def get_new_query_point(self, ucb: bool = False) -> np.ndarray:
        """Next evaluation point from the current S/M/G/Q state."""
        if not np.any(self.S):
            raise EnvironmentError("There are no safe points to evaluate.")
        if ucb:
            value = np.where(self.S, self.Q[:, 1], -np.inf)
        else:
            l = self.Q[:, ::2]
            u = self.Q[:, 1::2]
            MG = self.M | self.G
            value = np.where(MG, np.max((u - l) / self.scaling, axis=1),
                             -np.inf)
        x = self.inputs[int(np.argmax(value)), :]
        if self.num_contexts:
            return x[: -self.num_contexts]
        return x

    def optimize(self, context=None, ucb: bool = False) -> np.ndarray:
        """Run one SafeOpt iteration and return the next query point."""
        return self.optimize_async(context=context, ucb=ucb).result()

    def optimize_async(self, context=None, ucb: bool = False, after=None):
        """Dispatch one SafeOpt iteration and return a
        :class:`PendingSafeOptStep` without waiting for its diagnostics.

        The grid step's only dependence on the previous iteration is the
        GP data, which enters through ``add_new_data_point`` (its rows
        are written into the device mirrors in stream order, after the
        dispatched step's reads), so consecutive dispatches need no chain
        and ``after`` is accepted and ignored, as in the JAX package.
        What stays asynchronous is the step's tail after the expander
        walk and the diagnostics' copy to the host; the walk's per-chunk
        reads, the refinement's band population and the host oracle's
        packed band are read before this returns (module docstring). The
        device oracle's 9-int buffer is read at ``result()``.
        """
        del after
        start = time.perf_counter()
        before = host_syncs.count
        result, diag = self._run_step(context=context, ucb=ucb)
        return PendingSafeOptStep(self, result, diag, start,
                                  host_syncs.count - before)

    def _finish_step(self, result, diag, start, syncs: int) -> np.ndarray:
        """Record stats from the host copy of the packed diagnostics and
        return the query point (the tail of ``PendingSafeOptStep.result``);
        a 9-int buffer carries the device-oracle step's telemetry."""
        if diag.shape[0] >= 9:
            self._absorb_diag9(diag)
        (has_safe, idx, safe_count, maximizer_count,
         expander_found) = diag[:5].tolist()
        if not has_safe:
            raise EnvironmentError("There are no safe points to evaluate.")
        self.stats.record(IterationStats(
            t=self.t, duration_s=time.perf_counter() - start,
            safe_count=safe_count, maximizer_count=maximizer_count,
            expander_found=bool(expander_found), next_index=idx,
            beta=float(self.beta(self.t)), walk_chunks=result.walk_chunks,
            band_population=int(self._band_population),
            certified_corrections=int(self._certified_corrections),
            band_overflow=bool(self._band_overflow),
            refine_full_pass=bool(self._refine_band_overflow),
            eager_gps=self._eager_gps, host_syncs=syncs))
        x = self.inputs[idx, :]
        if self.num_contexts:
            return x[: -self.num_contexts]
        return x

    def get_maximum(self, context=None):
        """Current safe best estimate: argmax of the objective lower bound.

        Returns ``(x, lower_bound)`` or ``None`` when no candidate is
        safe (reference gp_opt.py:677-712).
        """
        self.context = context
        kernels, states = self._model_args()
        _, _, _, Q, S, diag = safe_maximum(
            kernels, states, self._grid(), self._step_consts()["fmin"],
            float(self.beta(self.t)))
        self._set_mirror("Q", Q)
        self._set_mirror("S", S)
        idx, lb, has_safe = diag.tolist()
        if not has_safe:
            return None
        x = self.inputs[int(idx), : -self.num_contexts or None]
        return x, lb

"""SafeOpt: exact safe Bayesian optimization on a discretized grid.

Counterpart of ``safeopt_tpu/algorithms/safe_opt.py:248-995`` on the
plain (uncertified) path. The public surface — constructor,
``optimize(context, ucb)``, ``get_maximum(context)``, ``compute_sets``,
``compute_safe_set``, ``get_new_query_point``,
``update_confidence_intervals``, the ``S``/``M``/``G``/``Q`` attributes
and the Lipschitz variant — matches the reference; the O(N) grid work
runs in ``safe_opt_core.safeopt_step`` on the models' device.

The device comes from the GPs: every GP must live on the same device
with the same dtype, and the grid is shipped there once. The certified
path (``exact_boundaries``, reduced ``interval_precision``, the device
oracle) is not ported yet: ``'auto'`` and ``None`` resolve to the plain
path and an explicit request raises ``NotImplementedError``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.observability import IterationStats, StatsRecorder
from .base import GaussianProcessOptimization
from .safe_opt_core import full_expander_sets, safe_maximum, safeopt_step

__all__ = ["SafeOpt"]

_CERTIFIED_TODO = ("the certified path (exact_boundaries, interval_precision"
                   ", oracle='device') is not ported yet: ROADMAP Queue 1 "
                   "item 9")

# Sentinel distinguishing "keep the current context" from an explicit
# ``context=None`` (an error with num_contexts > 0, gp_opt.py:445-447).
_KEEP_CONTEXT = object()


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
    exact_boundaries, interval_precision, oracle
        Certified-path requests. ``None``, ``False`` and ``'auto'`` (and
        ``oracle='host'``) select the plain path; anything else raises
        ``NotImplementedError`` until the certified path is ported.
    boundary_band, boundary_k, refine_k, refine_band, refine_band_k
        Settings of the certified path, with the JAX package's defaults.
        Any other value asks for the certified path and raises
        ``NotImplementedError``.
    """

    def __init__(self, gp, parameter_set, fmin, lipschitz=None, beta=2,
                 num_contexts=0, threshold=0, scaling="auto",
                 expander_chunk: int = 32, exact_boundaries=None,
                 boundary_band: float = 1e-3, boundary_k=None,
                 interval_precision="auto", refine_k=None,
                 refine_band: float = 1e-2, refine_band_k: int = 20480,
                 oracle: str = "auto"):
        if oracle not in ("auto", "host", "device"):
            raise ValueError("oracle must be 'auto', 'host' or 'device', "
                             f"got {oracle!r}")
        certified_settings = (boundary_band, boundary_k, refine_k,
                              refine_band, refine_band_k)
        if (exact_boundaries or interval_precision not in ("auto", None)
                or oracle == "device"
                or certified_settings != (1e-3, None, None, 1e-2, 20480)):
            raise NotImplementedError(_CERTIFIED_TODO)
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
        self._consts_key = None
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
            self._grid_dirty = True

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

    def _run_step(self, context=_KEEP_CONTEXT, ucb: bool = False):
        """Execute the device step and point the host mirrors at it."""
        if context is not _KEEP_CONTEXT:
            self.context = context
        kernels, states = self._model_args()
        consts = self._step_consts()
        result = safeopt_step(
            kernels, states, self._grid(), consts["fmin"],
            float(self.beta(self.t)), consts["scaling"],
            consts["threshold"], consts["lipschitz"], ucb=ucb,
            use_lipschitz=self._use_lipschitz, chunk=self._expander_chunk)
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
        return result

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
            result = self._run_step(ucb=False)
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
        start = time.perf_counter()
        result = self._run_step(context=context, ucb=ucb)
        return self._finish_step(result, start)

    def _finish_step(self, result, start) -> np.ndarray:
        """Read the packed diagnostics (the step's one device-to-host
        copy), record stats, return the query point."""
        has_safe, idx, safe_count, maximizer_count, expander_found = \
            result.diag.tolist()
        if not has_safe:
            raise EnvironmentError("There are no safe points to evaluate.")
        self.stats.record(IterationStats(
            t=self.t, duration_s=time.perf_counter() - start,
            safe_count=safe_count, maximizer_count=maximizer_count,
            expander_found=bool(expander_found), next_index=idx,
            beta=float(self.beta(self.t)), walk_chunks=result.walk_chunks))
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

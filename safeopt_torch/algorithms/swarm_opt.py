"""SafeOptSwarm: safe Bayesian optimization by particle swarms.

Counterpart of ``safeopt_tpu/algorithms/swarm_opt.py:107-877``, the
reference's swarm variant (gp_opt.py:715-1192, Duivenvoorden et al.
2017). There is no grid: the safe set is an explicit, growing set of
points, and three constrained particle swarms (greedy, maximizers,
expanders) search the continuous domain.

By default the whole ``optimize()`` is one fused iteration over a
device-resident safe-set buffer (``swarm_opt_fused.py``): on the card
one replay of a CUDA graph, on the CPU the same code run eagerly, with
one pull of a packed diagnostics tensor either way. ``graph=False``
runs the fused iteration eagerly on the card too (no fallback: a
failed capture raises). ``optimize(fused=False)`` keeps the stepwise
orchestration of the reference, call for call.

Semantics preserved from the reference:
- particle fitness per swarm type (gp_opt.py:901-1013): greedy = lower
  bound; maximizers/expanders = max scaled posterior std across GPs,
  plus piecewise slack penalties (gp_opt.py:874-899); expander interest
  = num_gps * prod_i N(slack_i; 0, 0.2); maximizer interest =
  sigmoid(10 (u - best_lower_bound) / scaling[0]);
- safe-set pruning never below swarm_size, with a warning
  (gp_opt.py:1051-1062); an empty safe set raises RuntimeError
  (gp_opt.py:1045-1049);
- safe-set growth by sequential covariance dedup at 0.95
  (gp_opt.py:1089-1114);
- optimal particle velocities by bisecting the kernel correlation into
  (0.94, 0.95), min across GPs, / sqrt(input_dim) (gp_opt.py:818-872,
  stationary kernels only), in float64 on the host;
- the final maximizer-vs-expander choice by the larger max scaled std
  with the threshold / -inf zeroing (gp_opt.py:1161-1177).

Randomness comes from an explicit ``torch.Generator`` (``generator=`` or
``seed=``) on the models' device. Torch cannot reproduce the JAX
package's threefry draws; the two hooks ``_draw_uniform(shape)``
(stepwise) and ``_fused_streams(ucb)`` (fused, a dict keyed
``{greedy,maximizers,expanders}_{idx,vel,r}``) let parity tests inject
the same uniforms into every implementation.
"""

from __future__ import annotations

import logging
import math
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..gp.kernels import kernel_leaves, with_leaves
from ..gp.regression import gp_predict
from ..utils.observability import (StatsRecorder, SwarmIterationStats,
                                   host_syncs)
from .base import GaussianProcessOptimization
from .swarm import SwarmOptimization
from .swarm_core import swarm_scan

__all__ = ["SafeOptSwarm", "PendingSwarmIteration"]

_SWARM_TYPES = ("greedy", "maximizers", "expanders")


def _ship(a, dtype, device) -> torch.Tensor:
    """Host values (or a tensor) as a new ``dtype`` tensor on ``device``.

    A copy to the card goes through pinned memory without blocking (the
    caching host allocator keeps the pinned block until the copy has
    run), so that dispatching an iteration never waits on the card."""
    device = torch.device(device)
    if isinstance(a, torch.Tensor) and a.device.type == device.type:
        return a.to(dtype=dtype, device=device, copy=True)
    if isinstance(a, torch.Tensor):
        a = a.cpu()
    t = torch.tensor(np.asarray(a), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def device_kernel(kernel, dtype, device):
    """A copy of ``kernel`` whose hyperparameters are ``dtype`` tensors on
    ``device``: a kernel whose leaves stay on the host copies them to the
    device on every call, a blocking copy that a CUDA graph cannot hold."""
    return with_leaves(kernel, [_ship(t, dtype, device)
                                for t in kernel_leaves(kernel)])


def _chain_pack(head: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """The fused pack ``[beta, blb, last_x, best_x, greedy]`` from a host-
    built head ``[beta, _, last_x, best_x]`` and the still-in-flight
    previous iteration's diag (5d = best lower bound, 4d:5d = greedy
    point), on the device."""
    d = (head.shape[0] - 2) // 2
    return torch.cat([head[:1], diag[5 * d:5 * d + 1], head[2:],
                      diag[4 * d:5 * d]])


class PendingSwarmIteration:
    """Handle of a dispatched fused iteration (``optimize_async``).

    The iteration's packed diagnostics are copied into a pinned host
    buffer without blocking, and a CUDA event is recorded after the
    copy. ``result()`` waits on that event, commits the host-side state
    exactly like the blocking ``optimize()`` and returns the next query
    point; it is idempotent. Finish pendings in dispatch order; the
    reference's empty-safe-set RuntimeError (gp_opt.py:1049) surfaces
    here.
    """

    def __init__(self, opt, out, ucb: bool, start: float, syncs: int):
        self._opt, self._out, self._ucb = opt, out, ucb
        self._start, self._syncs = start, syncs
        self._x = None
        self._done = False
        buf = out.diag
        self._event = None
        if buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(buf.device))
            buf = host
        self._diag = buf

    def result(self) -> np.ndarray:
        """Wait for the diagnostics, commit the host state and return the
        next query point (idempotent)."""
        if not self._done:
            if self._event is not None:
                self._event.synchronize()
            host_syncs.add()
            self._x = self._opt._commit_fused(self._out, self._diag,
                                              self._ucb, self._start,
                                              self._syncs + 1)
            self._done = True
        return self._x


# ---------------------------------------------------------------------------
# fitness and swarm runs
# ---------------------------------------------------------------------------

def _penalty(slack: torch.Tensor) -> torch.Tensor:
    """Piecewise slack penalty (reference gp_opt.py:874-899).

    Nonzero only for violated constraints; steeper the deeper the
    violation (x2 / x5 / x10 bands, then -300*slack^2).
    """
    pen = torch.clamp(slack, max=0.0)
    pen = torch.where((slack < 0) & (slack > -0.001), pen * 2, pen)
    pen = torch.where((slack <= -0.001) & (slack > -0.1), pen * 5, pen)
    pen = torch.where((slack <= -0.1) & (slack > -1), pen * 10, pen)
    pen = torch.where(slack < -1, -300.0 * pen * pen, pen)
    return pen


def _norm_pdf(x: torch.Tensor, scale: float) -> torch.Tensor:
    # a Python float: a traced program would hold a NumPy scalar as a
    # tensor constant
    inv = 1.0 / (scale * math.sqrt(2.0 * math.pi))
    return inv * torch.exp(-0.5 * (x / scale) ** 2)


def _particle_fitness(swarm_type: str, kernels, states, beta, fmin, scaling,
                      best_lower_bound, particles):
    """Multi-GP swarm fitness (reference gp_opt.py:901-1013) as device
    code. Returns (values, safe_mask); ``swarm_type`` is fixed per call
    site, ``beta`` a scalar and ``fmin``/``scaling`` (G,) tensors."""
    num_gps = len(kernels)
    mu, var = gp_predict(kernels[0], states[0], particles)
    std = torch.sqrt(var)
    lower = mu - beta * std
    upper = mu + beta * std

    if swarm_type == "greedy":
        return lower, torch.ones(particles.shape[0], dtype=torch.bool,
                                 device=particles.device)

    values = std / scaling[0]
    if swarm_type == "expanders":
        interest = float(num_gps) * torch.ones_like(values)
    elif swarm_type == "maximizers":
        improvement = upper - best_lower_bound
        interest = torch.sigmoid(10.0 * improvement / scaling[0])
    elif swarm_type == "safe_set":
        interest = None
    else:
        raise AssertionError("Invalid swarm type")

    safe = torch.ones(particles.shape[0], dtype=torch.bool,
                      device=particles.device)
    total_penalty = torch.zeros_like(values)

    for i in range(num_gps):
        if i > 0:
            mu, var = gp_predict(kernels[i], states[i], particles)
            std = torch.sqrt(var)
            lower = mu - beta * std
            values = torch.maximum(values, std / scaling[i])

        constrained = fmin[i] > float("-inf")
        slack = lower - fmin[i]                      # +inf when -inf fmin
        safe = safe & torch.where(constrained, slack >= 0, True)

        if swarm_type == "safe_set":
            continue

        slack_n = slack / scaling[i]
        total_penalty = total_penalty + torch.where(
            constrained, _penalty(slack_n), 0.0)
        if swarm_type == "expanders":
            interest = interest * torch.where(constrained,
                                              _norm_pdf(slack_n, 0.2), 1.0)

    if swarm_type == "safe_set":
        return lower, safe

    return (values + total_penalty) * interest, safe


def _run_swarm_fused(kernels, states, particles, velocities, r_stream,
                     velocity_scale, bounds, beta, fmin, scaling,
                     best_lower_bound, *, swarm_type: str):
    """One complete PSO run with the GP fitness of ``swarm_type``."""
    fitness = partial(_particle_fitness, swarm_type, kernels, states, beta,
                      fmin, scaling, best_lower_bound)
    return swarm_scan(fitness, particles, velocities, r_stream,
                      velocity_scale, bounds)


def _safe_set_check(kernels, states, points, n_valid, beta, fmin, scaling):
    """Safety mask of the stored safe-set points (gp_opt.py:1045); rows at
    index >= n_valid report unsafe."""
    _, safe = _particle_fitness("safe_set", kernels, states, beta, fmin,
                                scaling, 0.0, points)
    return safe & (torch.arange(points.shape[0], device=points.device)
                   < n_valid)


def _dedup_covariance(kernel, candidates, existing, scaling0):
    """Normalized covariance of candidates vs [existing; candidates]
    (the safe-set growth's dedup, gp_opt.py:1092-1096)."""
    stacked = torch.cat([existing, candidates], dim=0)
    return kernel.K(candidates, stacked) / (scaling0 ** 2)


def _bisect_velocity(kernel, scaling_i: float, d: int,
                     num_iters: int = 40) -> np.ndarray:
    """Per-dimension optimal velocity by kernel-correlation bisection, in
    float64 on the host.

    Vectorized over dimensions (one ``K(0, diag(mid))`` evaluates every
    axis step at once); replicates the reference's termination rule —
    stop when the correlation lands in (0.94, 0.95) or the bracket width
    drops below 1e-5, keeping the midpoint of the final iteration
    (gp_opt.py:843-861).
    """
    f64 = torch.float64
    zero = torch.zeros((1, d), dtype=f64)
    lower, upper = torch.zeros(d, dtype=f64), torch.full((d,), 1000.0,
                                                         dtype=f64)
    mid, done = torch.zeros(d, dtype=f64), torch.zeros(d, dtype=torch.bool)
    for _ in range(num_iters):
        mid = torch.where(done, mid, (upper + lower) / 2.0)
        cov = kernel.K(zero, torch.diag(mid))[0] / (scaling_i ** 2)
        not_too_fast = cov < 0.95
        enough = cov > 0.94
        upper = torch.where(~done & not_too_fast, mid, upper)
        lower = torch.where(~done & ~not_too_fast & enough, mid, lower)
        done = done | (not_too_fast & enough) | (upper - lower < 1e-5)
    return mid.numpy()


def _predict_stack(kernels, states, x):
    """Per-GP posterior (mu, var) at a single point, stacked."""
    mus, vars_ = [], []
    for kern, st in zip(kernels, states):
        mu, var = gp_predict(kern, st, x)
        mus.append(mu[0])
        vars_.append(var[0])
    return torch.stack(mus), torch.stack(vars_)


def _bucket(need: int) -> int:
    """Rows of a safe-set buffer for ``need`` rows: a power of two of at
    least 128, so that a growing set recaptures its graph rarely."""
    cap = 128
    while cap < need:
        cap *= 2
    return cap


# ---------------------------------------------------------------------------
# public class
# ---------------------------------------------------------------------------

class SafeOptSwarm(GaussianProcessOptimization):
    """Safe Bayesian optimization for high-dimensional problems.

    Swarm-based variant: instead of classifying a discrete grid, three
    particle swarms search for the greedy estimate, potential
    maximizers, and potential expanders; the safe set is an explicit
    growing set of points. Supports neither Lipschitz constants nor
    contexts (like the reference, gp_opt.py:717-719).

    Parameters
    ----------
    gp : GPRegression, SparseGPRegression or list
        Objective first, then safety-constraint GPs; all on one device,
        with one dtype.
    fmin : float or list of floats
        Safety thresholds (``-inf`` = unconstrained).
    bounds : pair or list of pairs
        Domain box (per dimension, or one pair broadcast to all).
    beta : float or callable
    scaling : 'auto' or list of floats
    threshold : float or list of floats
    swarm_size : int
        Particles per swarm (default 20).
    generator : torch.Generator, optional
        Randomness source on the models' device; ``seed`` seeds a new one
        when it is None. The reference uses the unseeded global NumPy RNG
        (SURVEY.md section 3.5).
    max_iters : int
        PSO iterations per swarm run (default 100).
    graph : bool, optional
        Replay the fused iteration as a CUDA graph (the default on the
        card; the CPU runs it eagerly). ``False`` runs it eagerly on the
        card too.

    Examples
    --------
    >>> import numpy as np
    >>> from safeopt_torch import GPRegression, SafeOptSwarm
    >>> gp = GPRegression(np.array([[0.]]), np.array([[1.]]),
    ...                   noise_var=0.01 ** 2, device='cpu')
    >>> opt = SafeOptSwarm(gp, fmin=[0.], bounds=[[-1., 1.]])
    >>> next_parameters = opt.optimize()
    >>> performance = np.array([[1.]])
    >>> opt.add_new_data_point(next_parameters, performance)
    """

    def __init__(self, gp, fmin, bounds, beta=2, scaling="auto", threshold=0,
                 swarm_size: int = 20,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 max_iters: int = 100, graph: Optional[bool] = None):
        super().__init__(gp, fmin=fmin, beta=beta, num_contexts=0,
                         threshold=threshold, scaling=scaling)
        devices = {torch.device(g.device).type for g in self.gps}
        dtypes = {g.dtype for g in self.gps}
        if len(devices) != 1 or len(dtypes) != 1:
            raise ValueError("every GP must live on one device with one "
                             f"dtype, got {devices} and {dtypes}")
        self.device = torch.device(self.gp.device)
        self.dtype = self.gp.dtype
        if graph is None:
            graph = self.device.type == "cuda"
        elif graph and self.device.type != "cuda":
            raise ValueError("graph=True needs the models on a CUDA device")
        self.graph = bool(graph)

        # Safe set: explicit points, seeded with the objective's data.
        # Backed by a device-resident buffer on the fused path (the host
        # mirror is pulled lazily; see the ``S`` property).
        self._S_host = None
        self._S_dev = None          # SwarmIterState or None
        self._count = 0
        self._count_ub = 0          # worst-case count while pipelining
        self._dev_consts = None
        self.S = np.asarray(self.gp.X_host, dtype=float).copy()

        self.swarm_size = int(swarm_size)
        self.max_iters = int(max_iters)   # swarm iterations per run

        if not isinstance(bounds, list):
            self.bounds = [bounds] * self.S.shape[1]
        else:
            self.bounds = bounds
        self._bounds_arr = np.asarray(self.bounds, dtype=float)

        self.best_lower_bound = -np.inf
        self.greedy_point = self.S[0, :].copy()

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self._generator = generator
        self.optimal_velocities = self.optimize_particle_velocity()

        self._kern_cache = {}       # GP index -> (kern, leaves, device kern)
        self._graphs = {}           # graph_key -> FusedSwarmGraph
        self.graph_captures = 0
        self.graph_replays = 0
        self.stats = StatsRecorder()

        # Public swarm objects for API parity / custom use; the hot path
        # runs through the fused iteration, not these.
        self.swarms = {
            swarm_type: SwarmOptimization(
                self.swarm_size, self.optimal_velocities,
                partial(self._compute_particle_fitness, swarm_type),
                bounds=self.bounds, generator=self._generator,
                device=self.device, dtype=self.dtype)
            for swarm_type in _SWARM_TYPES}

    # -- safe-set storage (device-resident on the fused path) -----------------

    @property
    def S(self) -> np.ndarray:
        """Current safe-set points (host view).

        On the fused path the canonical buffer lives on the device
        between iterations; the host mirror is pulled on first access (a
        host sync, counted in ``host_syncs``; ``optimize()`` never reads
        this property).
        """
        if self._S_host is None:
            host_syncs.add()
            rows = self._S_dev.S[: self._count].cpu().numpy()
            self._S_host = np.asarray(rows, dtype=float)
        return self._S_host

    @S.setter
    def S(self, value) -> None:
        self._S_host = np.asarray(value, dtype=float)
        self._count = self._S_host.shape[0]
        self._S_dev = None          # host now canonical

    # -- plumbing -------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return _ship(a, self.dtype, self.device)

    def _draw_uniform(self, shape) -> np.ndarray:
        """U[0,1) host draw — the single gate for stepwise randomness.

        Every stochastic choice of the stepwise path (particle-init
        indices, initial velocities, the PSO r1/r2 stream) flows through
        here, in a fixed per-swarm order (idx, vel, r), so that lockstep
        parity tests can override it with recorded streams shared with
        ``RefSafeOptSwarm`` and the fused iteration.
        """
        g = self._generator
        return torch.rand(tuple(shape), generator=g, dtype=self.dtype,
                          device=g.device).cpu().numpy()

    def _device_kernel(self, i: int, kern):
        """GP i's kernel with its hyperparameters in the models' dtype on
        their device, shipped once and again only when they change (a
        kernel's host leaves would be copied on every call)."""
        leaves = kernel_leaves(kern)
        hit = self._kern_cache.get(i)
        if (hit is not None and hit[0] is kern
                and all(torch.equal(a, b) for a, b in zip(hit[1], leaves))):
            return hit[2]
        dev = device_kernel(kern, self.dtype, self.device)
        self._kern_cache[i] = (kern, [t.clone() for t in leaves], dev)
        return dev

    def _model_args(self):
        return (tuple(self._device_kernel(i, g.kern)
                      for i, g in enumerate(self.gps)),
                tuple(g.state for g in self.gps))

    def _common_scalars(self):
        return (self._tensor(self.beta(self.t)), self._tensor(self.fmin),
                self._tensor(self.scaling))

    # -- reference API -------------------------------------------------------

    def optimize_particle_velocity(self) -> np.ndarray:
        """Optimal per-dimension particle velocities.

        Bisects each kernel's correlation length so one velocity step
        keeps ~0.94-0.95 correlation; min across GPs, scaled by
        1/sqrt(input_dim) (reference gp_opt.py:818-872), in float64 on the
        host. Only sensible for stationary kernels.
        """
        d = self.gp.input_dim
        per_gp = [_bisect_velocity(g.kern, float(scale), d)
                  for g, scale in zip(self.gps, self.scaling)]
        velocities = np.min(np.stack(per_gp), axis=0)
        return velocities / np.sqrt(d)

    def _compute_particle_fitness(self, swarm_type: str, particles):
        """Swarm fitness of a particle batch (public for the ``swarms``
        objects)."""
        kernels, states = self._model_args()
        beta, fmin, scaling = self._common_scalars()
        return _particle_fitness(swarm_type, kernels, states, beta, fmin,
                                 scaling, float(self.best_lower_bound),
                                 torch.atleast_2d(self._tensor(particles)))

    def _validate_safe_set(self) -> None:
        """Re-check stored safe points; prune model violations.

        Never prunes below swarm_size (reference gp_opt.py:1051-1062);
        raises RuntimeError when nothing is safe.
        """
        kernels, states = self._model_args()
        beta, fmin, scaling = self._common_scalars()
        S = self.S
        safe = _safe_set_check(kernels, states, self._tensor(S), S.shape[0],
                               beta, fmin, scaling).cpu().numpy()
        num_safe = int(safe.sum())
        if num_safe == 0:
            raise RuntimeError("The safe set is empty.")
        if num_safe >= self.swarm_size and num_safe != len(safe):
            logging.warning(
                "Warning: %d unsafe points removed. Model might be violated",
                int(np.count_nonzero(~safe)))
            self.S = S[safe]

    def _init_particles(self, swarm_type: str) -> np.ndarray:
        """Seed particles uniformly from the safe set.

        The greedy swarm swaps its last three particles for the previous
        greedy estimate, the most recent observation, and the best
        observation (reference gp_opt.py:1064-1081).
        """
        safe_size = self.S.shape[0]
        if swarm_type == "greedy":
            n_random = self.swarm_size - 3
        else:
            n_random = self.swarm_size
        # floor(u * size): the index convention shared with the fused
        # iteration and RefSafeOptSwarm
        u = self._draw_uniform((n_random,))
        random_id = np.minimum((u * safe_size).astype(int), safe_size - 1)
        particles = self.S[random_id, :]
        if swarm_type == "greedy":
            X = np.asarray(self.gp.X_host, dtype=float)
            Y = np.asarray(self.gp.Y_host, dtype=float)
            best_sampled = int(np.argmax(Y[:, 0]))
            particles = np.vstack((particles, self.greedy_point,
                                   X[-1, :], X[best_sampled, :]))
        return particles

    def _grow_safe_set(self, best_positions: np.ndarray) -> None:
        """Greedy covariance dedup growth (reference gp_opt.py:1089-1114).

        A swarm best is added if its normalized covariance to every
        previously accepted safe point (including those just added) is
        at most 0.95.
        """
        kernels, _ = self._model_args()
        cov = _dedup_covariance(
            kernels[0], self._tensor(best_positions), self._tensor(self.S),
            float(self.scaling[0])).cpu().numpy()

        initial_safe = len(self.S)
        mask = np.zeros(cov.shape[1], dtype=bool)
        mask[:initial_safe] = True

        accepted = []
        for j in range(best_positions.shape[0]):
            if np.all(cov[j, mask] <= 0.95):
                accepted.append(best_positions[j])
                mask[initial_safe + j] = True
        if accepted:
            self.S = np.vstack([self.S] + [a[None, :] for a in accepted])
        logging.debug("%d points were appended to the safeset",
                      len(accepted))

    def get_new_query_point(self, swarm_type: str):
        """Run one swarm and return its best point.

        Returns ``(x, max_best_value)`` for the greedy swarm, else
        ``(x, per-GP posterior std at x)`` (reference
        gp_opt.py:1015-1134).
        """
        if swarm_type not in _SWARM_TYPES:
            raise ValueError(f"unknown swarm type: {swarm_type!r}")
        kernels, states = self._model_args()
        beta, fmin, scaling = self._common_scalars()

        self._validate_safe_set()
        particles = self._tensor(self._init_particles(swarm_type))

        d = self.gp.input_dim
        vel = self._tensor(self.optimal_velocities)
        velocities = self._tensor(
            self._draw_uniform((self.swarm_size, d))) * vel
        r_stream = self._tensor(
            self._draw_uniform((self.max_iters, 2, self.swarm_size, d)))

        result = _run_swarm_fused(
            kernels, states, particles, velocities, r_stream, vel,
            self._tensor(self._bounds_arr), beta, fmin, scaling,
            float(self.best_lower_bound), swarm_type=swarm_type)

        global_best = result.global_best.cpu().numpy().astype(float)

        if swarm_type != "greedy":
            self._grow_safe_set(
                result.best_positions.cpu().numpy().astype(float))
            _, vars_ = _predict_stack(kernels, states,
                                      self._tensor(global_best[None, :]))
            return global_best, np.sqrt(vars_.cpu().numpy().astype(float))

        # Greedy: move the running estimate if the swarm beat it.
        mu, var = gp_predict(kernels[0], states[0],
                             self._tensor(self.greedy_point[None, :]))
        lower_bound = float(mu[0] - beta * torch.sqrt(var[0]))
        best_val = float(torch.max(result.best_values))
        if lower_bound < best_val:
            self.greedy_point = global_best.copy()
        return global_best.copy(), best_val

    def optimize(self, ucb: bool = False, fused: Optional[bool] = None
                 ) -> np.ndarray:
        """One SafeOptSwarm iteration: run the three swarms and pick the
        maximizer or expander with the larger scaled uncertainty
        (reference gp_opt.py:1136-1177).

        ``fused=True`` (the default) runs the entire iteration as the
        fused device iteration (one replay of its CUDA graph on the card,
        one pull); ``fused=False`` uses the stepwise
        ``get_new_query_point`` path, which mirrors the reference's host
        orchestration call for call.
        """
        if fused is None or fused:
            return self.optimize_async(ucb=ucb).result()
        self.greedy, self.best_lower_bound = self.get_new_query_point(
            "greedy")

        x_maxi, std_maxi = self.get_new_query_point("maximizers")
        if ucb:
            logging.info("Using ucb criterion.")
            return x_maxi

        x_exp, std_exp = self.get_new_query_point("expanders")

        std_exp = std_exp.copy()
        std_exp[(std_exp < self.threshold) | (self.fmin == -np.inf)] = 0
        std_exp = np.max(std_exp / self.scaling)
        std_maxi = float(std_maxi[0]) / self.scaling[0]

        logging.info("The best maximizer has std. dev. %f", std_maxi)
        logging.info("The best expander has std. dev. %f", std_exp)
        logging.info("The greedy estimate of lower bound has value %f",
                     self.best_lower_bound)

        if std_maxi > std_exp:
            return x_maxi
        return x_exp

    def _fused_streams(self, ucb: bool = False):
        """Uniform streams for the fused iteration, or None.

        Default None: the streams are drawn from the generator with one
        ``torch.rand`` before the iteration. Parity tests override this
        to inject the streams shared with the stepwise path and
        ``RefSafeOptSwarm`` (dict keys ``{greedy,maximizers,
        expanders}_{idx,vel,r}``, arrays or tensors).
        """
        return None

    def _streams(self, ucb: bool):
        from .swarm_opt_fused import split_streams, stream_layout

        layout = stream_layout(self.swarm_size, self.max_iters,
                               self.gp.input_dim, ucb)
        injected = self._fused_streams(ucb=ucb)
        if injected is not None:
            return {name: self._tensor(injected[name]).reshape(shape)
                    for name, shape in layout}
        n = sum(int(np.prod(shape)) for _, shape in layout)
        g = self._generator
        flat = torch.rand(n, generator=g, dtype=self.dtype, device=g.device)
        return split_streams(self._tensor(flat), layout)

    def _device_consts(self) -> dict:
        """Iteration-invariant operands, shipped to the device once."""
        if self._dev_consts is None:
            self._dev_consts = dict(
                vel=self._tensor(self.optimal_velocities),
                bounds=self._tensor(self._bounds_arr),
                fmin=self._tensor(self.fmin),
                scaling=self._tensor(self.scaling),
                threshold=self._tensor(
                    np.broadcast_to(np.asarray(self.threshold, dtype=float),
                                    (len(self.gps),))))
        return self._dev_consts

    def _buffer(self, need: int):
        """The device safe-set state with at least ``need`` rows: the
        current one, or a larger buffer holding its rows (copied on the
        device when the device is canonical, so no pull)."""
        from .swarm_opt_fused import SwarmIterState

        cur = self._S_dev
        if cur is not None and cur.S.shape[0] >= need:
            return cur
        cap = _bucket(need)
        d = self.gp.input_dim
        if cur is not None:
            S = torch.zeros((cap, d), dtype=self.dtype, device=cur.S.device)
            S[: cur.S.shape[0]] = cur.S
            return SwarmIterState(S=S, count=cur.count, greedy=cur.greedy)
        S_buf = np.zeros((cap, d))
        S_buf[: self._count] = self._S_host
        return SwarmIterState(
            S=self._tensor(S_buf),
            count=_ship(self._count, torch.int64, self.device),
            greedy=self._tensor(self.greedy_point))

    def _observations_head(self) -> np.ndarray:
        """``[beta, 0, last_x, best_x]``: the pack's host part. The greedy
        specials come from the host data store: the most recent and the
        best observation (a sparse model's device rows are inducing
        points, not observations)."""
        Xh = np.asarray(self.gp.X_host, dtype=float)
        Yh = np.asarray(self.gp.Y_host, dtype=float)
        d = Xh.shape[1]
        head = np.zeros(2 + 2 * d)
        head[0] = float(self.beta(self.t))
        head[2:2 + d] = Xh[-1]
        head[2 + d:] = Xh[int(np.argmax(Yh[:, 0]))]
        return head

    def _fused_args(self, ucb: bool = False):
        """The operands of one fused iteration, from the committed host
        state: the device safe-set buffer (grown when it may overflow),
        the uniform streams, the cached constants and one packed scalar
        tensor [beta, best_lower_bound, last_x, best_x, greedy]."""
        kernels, states = self._model_args()
        consts = self._device_consts()
        dev_state = self._buffer(self._count + 2 * self.swarm_size + 8)
        pack = np.concatenate([self._observations_head(),
                               self.greedy_point])
        pack[1] = self.best_lower_bound
        args = (kernels, states, dev_state, self._streams(ucb),
                consts["vel"], consts["bounds"], consts["fmin"],
                consts["scaling"], consts["threshold"], self._tensor(pack))
        kwargs = dict(swarm_size=self.swarm_size, max_iters=self.max_iters,
                      ucb=ucb)
        return args, kwargs

    def _fused_args_after(self, out_prev, ucb: bool = False):
        """The operands of one fused iteration CHAINED on a still-in-
        flight previous iteration: nothing here reads the device.

        The three values the unchained path takes from the previous
        iteration's committed host mirrors (the safe-set buffer, the best
        lower bound, the greedy point) are taken from the previous
        ``SwarmIterOut``'s device tensors instead: the state rides
        ``out_prev.state`` and the two pack scalars are sliced out of
        ``out_prev.diag`` on the device (``_chain_pack``), exactly what
        ``_commit_fused`` would have written back. Everything else comes
        from the host as in ``_fused_args``, so a lag-aware caller
        (pipeline.py) that adds observations in the same order gets a
        bitwise-identical trajectory to the blocking loop.

        The capacity is governed by a host-side upper bound (growth is at
        most ``2 * swarm_size`` rows per iteration), because the true
        count is still in flight; ``reserve()`` sizes the buffer for a
        whole pipelined campaign up front.
        """
        kernels, states = self._model_args()
        consts = self._device_consts()
        self._count_ub += 2 * self.swarm_size
        need = self._count_ub + 2 * self.swarm_size + 8
        if out_prev.state.S.shape[0] < need:
            raise RuntimeError(
                "pipelined dispatch may exceed the device safe-set "
                f"buffer (capacity {out_prev.state.S.shape[0]}, worst-"
                f"case need {need}); call reserve(n_iterations) before "
                "pipelining")
        pack = _chain_pack(self._tensor(self._observations_head()),
                           out_prev.diag)
        args = (kernels, states, out_prev.state, self._streams(ucb),
                consts["vel"], consts["bounds"], consts["fmin"],
                consts["scaling"], consts["threshold"], pack)
        kwargs = dict(swarm_size=self.swarm_size, max_iters=self.max_iters,
                      ucb=ucb)
        return args, kwargs

    def reserve(self, iterations: int) -> None:
        """Pre-grow the device safe-set buffer for ``iterations``
        worst-case growth steps, so that a pipelined campaign never needs
        a rebuild, nor its graph a recapture, mid-flight."""
        need = (self._count + (int(iterations) + 2) * 2 * self.swarm_size
                + 8)
        self._S_dev = self._buffer(need)

    def _launch(self, args, kwargs):
        """Run the fused iteration: one replay of its CUDA graph
        (captured on first use of its key), or the eager code."""
        from .swarm_opt_fused import (FusedSwarmGraph, fused_swarm_optimize,
                                      graph_key)

        if not self.graph:
            return fused_swarm_optimize(*args, **kwargs)
        key = graph_key(*args[:3], **kwargs)
        graph = self._graphs.get(key)
        if graph is None:
            graph = FusedSwarmGraph(*args, **kwargs)
            self._graphs[key] = graph
            self.graph_captures += 1
        self.graph_replays += 1
        return graph.replay(*args)

    def optimize_async(self, ucb: bool = False, after=None):
        """Dispatch one fused iteration WITHOUT waiting for its result.

        Returns a :class:`PendingSwarmIteration`; ``.result()`` pulls the
        diagnostics and commits the host state (the tail of the blocking
        ``optimize()``). With ``after=<previous pending>`` the dispatch
        chains on the in-flight iteration's device state
        (``_fused_args_after``), so that the device computes iteration
        t+1 while the host waits on iteration t's pull. Finish pendings
        in dispatch order; an empty-safe-set RuntimeError surfaces at
        ``result()`` of the failing iteration.
        """
        start = time.perf_counter()
        before = host_syncs.count
        if after is None:
            self._count_ub = self._count
            args, kwargs = self._fused_args(ucb=ucb)
        else:
            args, kwargs = self._fused_args_after(after._out, ucb=ucb)
        out = self._launch(args, kwargs)
        return PendingSwarmIteration(self, out, ucb, start,
                                     host_syncs.count - before)

    def _commit_fused(self, out, diag, ucb: bool, start: float,
                      syncs: int) -> np.ndarray:
        """Commit a fused iteration from the host copy of its diagnostics."""
        d = self.gp.input_dim
        diag = diag.numpy().astype(float)
        x_next = diag[0:d]
        x_maxi = diag[d:2 * d]
        x_greedy = diag[3 * d:4 * d]
        greedy_point = diag[4 * d:5 * d]
        blb, std_maxi, std_exp = diag[5 * d:5 * d + 3]
        num_safe = diag[5 * d + 3:5 * d + 6]
        num_pruned = diag[5 * d + 6:5 * d + 9]
        num_added = diag[5 * d + 9:5 * d + 11]
        count = int(diag[5 * d + 11])

        if (num_safe == 0).any():
            # do not commit the device state: the stored safe set must
            # survive an aborted iteration (reference gp_opt.py:1049)
            raise RuntimeError("The safe set is empty.")
        for pruned in num_pruned:
            if pruned > 0:
                logging.warning(
                    "Warning: %d unsafe points removed. "
                    "Model might be violated", int(pruned))

        self._S_dev = out.state            # the device stays canonical
        self._S_host = None
        self._count = count
        self._count_ub = count
        self.greedy_point = greedy_point
        self.greedy = np.asarray(x_greedy, dtype=float)
        self.best_lower_bound = float(blb)
        self.stats.record(SwarmIterationStats(
            t=self.t, duration_s=time.perf_counter() - start,
            safe_count=count, num_added=int(num_added.sum()),
            num_pruned=int(num_pruned.sum()),
            beta=float(self.beta(self.t)), graph=self.graph,
            graph_captures=self.graph_captures,
            graph_replays=self.graph_replays, host_syncs=syncs))

        if ucb:
            logging.info("Using ucb criterion.")
            return np.asarray(x_maxi, dtype=float)

        logging.info("The best maximizer has std. dev. %f", float(std_maxi))
        logging.info("The best expander has std. dev. %f", float(std_exp))
        logging.info("The greedy estimate of lower bound has value %f",
                     self.best_lower_bound)
        return np.asarray(x_next, dtype=float)

    def get_maximum(self):
        """Best *observed* point (argmax over the objective's data,
        reference gp_opt.py:1179-1192)."""
        Y = np.asarray(self.gp.Y_host, dtype=float)
        X = np.asarray(self.gp.X_host, dtype=float)
        maxi = int(np.argmax(Y[:, 0]))
        return X[maxi, :], Y[maxi]

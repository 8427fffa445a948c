"""The whole SafeOptSwarm iteration as fixed-shape device code, and its
CUDA graph.

Counterpart of ``safeopt_tpu/algorithms/swarm_opt_fused.py:91-345``. One
``optimize()`` — the three swarms (greedy, maximizers, expanders), the
safe-set validation, pruning and growth, and the final maximizer-vs-
expander choice — runs over a device-resident padded safe-set buffer
with no host read: ``fused_swarm_optimize`` is plain tensor code whose
every shape is fixed by its inputs' shapes, and whose data-dependent
choices are ``torch.where`` selections on the device.

In eager PyTorch such an iteration is some 10^4 small launches, each a
few microseconds of host time. ``FusedSwarmGraph`` captures it once as a
``torch.cuda.CUDAGraph`` per key of (ucb, the GPs' capacities and kernel
structures, the safe-set buffer's rows, swarm size, swarm iterations,
d, dtype) and replays it once per ``optimize()``. The graph reads its
operands from static buffers that ``replay`` refills before each launch
(the models' factors, the kernels' hyperparameters, the safe set, the
uniform streams, the scalar pack), so an append or a sparse model's
rebuild is always seen, and clones its outputs, so that a chained
iteration may replay before the host reads the previous one.

Semantics replicated from the reference (gp_opt.py:1015-1177):

- re-validate the stored safe points per swarm; prune the unsafe ones
  only when at least ``swarm_size`` safe points remain (order-preserving
  compaction), never below the swarm size;
- particles from the safe set by ``floor(u * count)``; the greedy swarm
  swaps in the previous greedy estimate, the most recent and the best
  observation;
- growth by greedy covariance dedup after the maximizers and the
  expanders: a swarm best joins when its normalized covariance to every
  safe point and every best already accepted is <= 0.95 (one difference
  from the JAX fused program: that program also tests a candidate
  against buffer rows past the count once anything was accepted, see
  ``_grow_safe_set``);
- the greedy estimate moves when the swarm beat its old lower bound;
- expander stds below the threshold or of unconstrained GPs are zeroed,
  both sides scaled, the larger max wins (gp_opt.py:1161-1177).

An empty safe set never raises on the device: each phase reports its
safe count and gates its state updates on ``has_safe``, and the host
raises the reference's RuntimeError after the single pull.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..gp.kernels import Kernel, kernel_leaves, with_leaves
from ..gp.regression import GPState, gp_predict
from .swarm_core import swarm_scan
from .swarm_opt import _SWARM_TYPES, _particle_fitness

__all__ = ["SwarmIterState", "SwarmIterOut", "fused_swarm_optimize",
           "fleet_swarm_optimize", "FusedSwarmGraph", "graph_key",
           "stream_layout", "split_streams"]


class SwarmIterState(NamedTuple):
    """Device-resident SafeOptSwarm state."""

    S: torch.Tensor            # (cap, d) padded safe-set points
    count: torch.Tensor        # () int64 active rows
    greedy: torch.Tensor       # (d,) running best-lower-bound location


class SwarmIterOut(NamedTuple):
    """Outputs of a fused iteration.

    ``diag`` packs every output the host needs into one flat tensor, so
    that an iteration costs one device-to-host copy. Layout, with
    d = input_dim:

        [0:d]         x_next          [5d]      best_lower_bound
        [d:2d]        x_maxi          [5d+1]    std_maxi
        [2d:3d]       x_exp           [5d+2]    std_exp
        [3d:4d]       x_greedy        [5d+3:+3] num_safe (3)
        [4d:5d]       greedy_point    [5d+6:+3] num_pruned (3)
                                      [5d+9:+2] num_added (2)
                                      [5d+11]   safe-set count
    """

    x_next: torch.Tensor       # (d,) chosen query point
    state: SwarmIterState      # updated device state
    best_lower_bound: torch.Tensor
    num_safe: torch.Tensor     # (3,) per-phase safe counts (0 => raise)
    num_pruned: torch.Tensor   # (3,) per-phase pruned counts (warn)
    num_added: torch.Tensor    # (2,) growth per non-greedy swarm
    std_maxi: torch.Tensor     # scaled max std of the maximizer
    std_exp: torch.Tensor      # scaled max std of the expander
    x_maxi: torch.Tensor       # (d,)
    x_exp: torch.Tensor
    x_greedy: torch.Tensor     # (d,) the greedy swarm's best
    diag: torch.Tensor         # (5d+12,) single-pull packed outputs


def stream_layout(swarm_size: int, max_iters: int, d: int,
                  ucb: bool = False) -> Tuple[Tuple[str, tuple], ...]:
    """The uniform streams of one iteration, in draw order: per swarm
    (greedy, maximizers, then expanders unless ``ucb``) the particle-
    index draws, the initial velocities and the PSO's r1/r2 stream (the
    order the stepwise path and ``RefSafeOptSwarm`` draw them in)."""
    out = []
    for s in _SWARM_TYPES[:2] + (() if ucb else _SWARM_TYPES[2:]):
        n = swarm_size - 3 if s == "greedy" else swarm_size
        out += [(s + "_idx", (n,)), (s + "_vel", (swarm_size, d)),
                (s + "_r", (max_iters, 2, swarm_size, d))]
    return tuple(out)


def split_streams(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Views of a flat uniform tensor, one per entry of ``layout``; a
    leading campaign axis (K, U) gives (K, *shape) views."""
    out, at = {}, 0
    for name, shape in layout:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[..., at:at + n].view(flat.shape[:-1] + shape)
        at += n
    return out


def _pack_diag(x_next, x_maxi, x_exp, x_greedy, greedy_point, blb,
               std_maxi, std_exp, num_safe, num_pruned, num_added, count):
    dtype = x_next.dtype
    return torch.cat([
        x_next, x_maxi, x_exp, x_greedy, greedy_point,
        torch.stack([blb, std_maxi, std_exp]).to(dtype),
        num_safe.to(dtype), num_pruned.to(dtype), num_added.to(dtype),
        count.to(dtype).reshape(1)])


def _validate_and_prune(kernels, states, S, count, swarm_size, beta, fmin,
                        scaling):
    """Reference gp_opt.py:1044-1062 as device code: the safe rows'
    order-preserving compaction (the JAX package's stable argsort of
    ``~safe``) is a scatter of each row to its rank, the safe rows first."""
    cap = S.shape[0]
    rows = torch.arange(cap, device=S.device)
    _, safe = _particle_fitness("safe_set", kernels, states, beta, fmin,
                                scaling, 0.0, S)
    safe = safe & (rows < count)
    num_safe = safe.sum()
    do_prune = (num_safe >= swarm_size) & (num_safe != count)

    rank = torch.cumsum(safe, 0)
    dest = torch.where(safe, rank - 1, num_safe + rows - rank)
    S_pruned = torch.empty_like(S).index_copy_(0, dest, S)
    S_new = torch.where(do_prune, S_pruned, S)
    count_new = torch.where(do_prune, num_safe, count)
    pruned = torch.where(do_prune, count - num_safe, 0)
    return S_new, count_new, num_safe, pruned


def _init_particles(u_idx, S, count, swarm_type, greedy_point, specials):
    """Reference gp_opt.py:1064-1081 as device code.

    ``u_idx`` is a U[0,1) vector mapped to indices via ``floor(u *
    count)``, the convention shared with the stepwise path and
    ``RefSafeOptSwarm``. ``specials`` is (2, d): the most recent and the
    best observation, from the host's data store (a sparse model's
    device rows are its inducing points, not its observations).
    """
    cnt = torch.clamp(count, min=1)
    idx = torch.minimum((u_idx * cnt).to(torch.int64), cnt - 1)
    particles = S.index_select(0, idx)
    if swarm_type != "greedy":
        return particles
    return torch.cat([particles, greedy_point[None, :], specials], dim=0)


def _grow_safe_set(kernel0, scaling0, S, count, best_positions):
    """Greedy covariance dedup growth (gp_opt.py:1089-1114) as device code.

    Candidate j joins when its normalized covariance to every active
    safe point and to every candidate accepted before it is <= 0.95; the
    loop over the swarm is sequential because each acceptance joins the
    comparison set of the later candidates. The buffer guard (no row
    past the capacity) rejects the candidates past the free rows; they
    could not have blocked a later candidate that fits.

    The JAX fused program masks the covariance's safe-set columns with
    the running count, so that once a candidate is accepted it is also
    compared with the buffer rows past the starting count (padding, or
    points pruned earlier); the stepwise path and the reference compare
    with the safe set alone, as this function does.
    """
    cap = S.shape[0]
    swarm = best_positions.shape[0]
    stacked = torch.cat([S, best_positions], dim=0)
    cov = kernel0.K(best_positions, stacked) / (scaling0 ** 2)
    near = ~(cov <= 0.95)                 # a NaN covariance blocks too
    active = torch.arange(cap, device=S.device) < count
    free = ~(near[:, :cap] & active).any(dim=1)
    near_c = near[:, cap:]
    accepted = torch.zeros_like(free)     # batched with ``free`` under vmap
    for j in range(swarm):
        accepted[j] = free[j] & ~(near_c[j] & accepted).any()
    rank = torch.cumsum(accepted, 0)
    accepted = accepted & (rank <= cap - count)
    added = accepted.sum()
    dest = torch.where(accepted, count + rank - 1, cap)  # cap: a spare row
    grown = torch.cat([S, S.new_zeros((1, S.shape[1]))]).index_copy_(
        0, dest, best_positions)
    return grown[:cap], count + added, added


def fused_swarm_optimize(kernels, states, state: SwarmIterState, streams,
                         velocity_scale, bounds, fmin, scaling, threshold,
                         scalar_pack, *, swarm_size: int, max_iters: int,
                         ucb: bool = False) -> SwarmIterOut:
    """One complete SafeOptSwarm ``optimize()`` as device code.

    ``streams`` is a dict of uniform tensors keyed
    ``{greedy,maximizers,expanders}_{idx,vel,r}`` (``stream_layout``).
    ``scalar_pack`` carries every per-iteration host scalar in one
    tensor, ``[beta, best_lower_bound, last_x..., best_x...,
    greedy...]``. Every tensor lies on one device in one dtype, the
    kernels' hyperparameters too (a kernel with its leaves on the host
    would copy them to the device on every call).
    """
    dtype, dev = state.S.dtype, state.S.device
    d = state.S.shape[1]

    beta = scalar_pack[0]
    best_lower_bound_init = scalar_pack[1]
    specials = scalar_pack[2:2 + 2 * d].reshape(2, d)
    greedy_point = scalar_pack[2 + 2 * d:2 + 3 * d]
    S, count = state.S, state.count
    num_safe, num_pruned, num_added = [], [], []

    def run_one(S, count, greedy_point, blb, swarm_type):
        S, count, n_safe, pruned = _validate_and_prune(
            kernels, states, S, count, swarm_size, beta, fmin, scaling)
        particles = _init_particles(streams[swarm_type + "_idx"], S, count,
                                    swarm_type, greedy_point, specials)
        velocities = streams[swarm_type + "_vel"] * velocity_scale
        fitness = partial(_particle_fitness, swarm_type, kernels, states,
                          beta, fmin, scaling, blb)
        result = swarm_scan(fitness, particles, velocities,
                            streams[swarm_type + "_r"], velocity_scale,
                            bounds)
        num_safe.append(n_safe)
        num_pruned.append(pruned)
        return S, count, n_safe > 0, result

    def grow(S, count, has_safe, result):
        S_grown, count_grown, added = _grow_safe_set(
            kernels[0], scaling[0], S, count, result.best_positions)
        num_added.append(torch.where(has_safe, added, 0))
        return (torch.where(has_safe, S_grown, S),
                torch.where(has_safe, count_grown, count))

    def stds_at(x, gps):
        return torch.stack([torch.sqrt(gp_predict(k, st, x[None, :])[1][0])
                            for k, st in gps])

    # -- greedy: refresh the best-lower-bound estimate -----------------------
    S, count, has_safe_g, res_g = run_one(
        S, count, greedy_point, torch.full((), float("-inf"), dtype=dtype,
                                           device=dev), "greedy")
    mu_gp, var_gp = gp_predict(kernels[0], states[0], greedy_point[None, :])
    old_lb = mu_gp[0] - beta * torch.sqrt(var_gp[0])
    best_val = torch.max(res_g.best_values)
    move = has_safe_g & (old_lb < best_val)
    greedy_point = torch.where(move, res_g.global_best, greedy_point)
    best_lower_bound = torch.where(has_safe_g, best_val,
                                   best_lower_bound_init)

    # -- maximizers ----------------------------------------------------------
    S, count, has_safe_m, res_m = run_one(S, count, greedy_point,
                                          best_lower_bound, "maximizers")
    S, count = grow(S, count, has_safe_m, res_m)
    x_maxi = res_m.global_best
    std_maxi = stds_at(x_maxi, [(kernels[0], states[0])])[0] / scaling[0]

    if ucb:
        # ucb returns the maximizer; the expanders never run
        # (gp_opt.py:1154-1156)
        one = torch.ones((), dtype=torch.int64, device=dev)
        ns = torch.stack(num_safe + [one])
        npr = torch.stack(num_pruned + [one * 0])
        na = torch.stack(num_added + [one * 0])
        zero = torch.zeros((), dtype=dtype, device=dev)
        x_exp, std_exp, x_next = x_maxi, zero, x_maxi
    else:
        # -- expanders -------------------------------------------------------
        S, count, has_safe_e, res_e = run_one(S, count, greedy_point,
                                              best_lower_bound, "expanders")
        S, count = grow(S, count, has_safe_e, res_e)
        x_exp = res_e.global_best

        # final choice (gp_opt.py:1161-1177)
        std_exp_vec = stds_at(x_exp, zip(kernels, states))
        std_exp_vec = torch.where(
            (std_exp_vec < threshold) | (fmin == float("-inf")), 0.0,
            std_exp_vec)
        std_exp = torch.max(std_exp_vec / scaling)
        x_next = torch.where(std_maxi > std_exp, x_maxi, x_exp)
        ns, npr, na = (torch.stack(num_safe), torch.stack(num_pruned),
                       torch.stack(num_added))

    return SwarmIterOut(
        x_next=x_next,
        state=SwarmIterState(S=S, count=count, greedy=greedy_point),
        best_lower_bound=best_lower_bound,
        num_safe=ns, num_pruned=npr, num_added=na,
        std_maxi=std_maxi, std_exp=std_exp,
        x_maxi=x_maxi, x_exp=x_exp, x_greedy=res_g.global_best,
        diag=_pack_diag(x_next, x_maxi, x_exp, res_g.global_best,
                        greedy_point, best_lower_bound, std_maxi, std_exp,
                        ns, npr, na, count))


def fleet_swarm_optimize(kernels, states, state: SwarmIterState, streams,
                         velocity_scale, bounds, fmin, scaling, threshold,
                         scalar_pack, *, swarm_size: int, max_iters: int,
                         ucb: bool = False) -> SwarmIterOut:
    """``fused_swarm_optimize`` of K independent campaigns, as one batched
    program: ``torch.func.vmap`` over the leading campaign axis of
    ``states`` (each GP's fields), ``state``, ``streams`` (each (K,
    *shape)) and ``scalar_pack`` (K, P), the counterpart of the JAX
    package's ``jax.vmap`` (``parallel/campaigns.py:157-162``); the kernels
    and the constants are shared. Every kernel of the iteration runs once
    for all K campaigns, K times wider; the outputs have the leading axis.
    (The order-preserving scatters, ``index_copy_``, run per campaign under
    vmap's fallback.)"""
    def one(sts, st, sm, pack):
        return fused_swarm_optimize(kernels, sts, st, sm, velocity_scale,
                                    bounds, fmin, scaling, threshold, pack,
                                    swarm_size=swarm_size,
                                    max_iters=max_iters, ucb=ucb)

    states = tuple(states)
    # the fields a caller leaves None (the graph's static copies hold only
    # those gp_predict reads) are not batched
    dims = tuple(type(st)(*(None if f is None else 0 for f in st))
                 for st in states)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*performance drop.*")
        return torch.func.vmap(one, in_dims=(dims, 0, 0, 0))(
            states, state, streams, scalar_pack)


# ---------------------------------------------------------------------------
# the CUDA graph
# ---------------------------------------------------------------------------

# the fields of a GPState that ``gp_predict`` reads
_PREDICT_FIELDS = ("X", "count", "Linv", "w")


def _kernel_key(kernel: Kernel):
    """What a captured graph bakes in of a kernel: its type tree, its
    static fields and its leaves' shapes (the leaves' values are
    refilled before each replay)."""
    parts = getattr(kernel, "parts", None)
    if parts is not None:
        return (type(kernel).__name__,) + tuple(_kernel_key(k) for k in parts)
    static = tuple(sorted((name, value) for name, value in vars(kernel).items()
                          if name not in kernel._leaves
                          and not isinstance(value, torch.Tensor)))
    return (type(kernel).__name__, static,
            tuple(tuple(getattr(kernel, n).shape) for n in kernel._leaves))


def graph_key(kernels, states, state: SwarmIterState, *, swarm_size: int,
              max_iters: int, ucb: bool = False):
    """The key of ``FusedSwarmGraph``: everything a capture bakes in (a
    fleet's K stands in the safe set's shape, (K, cap, d))."""
    return (bool(ucb), len(kernels),
            tuple((st.X.shape[-2], _kernel_key(k))
                  for k, st in zip(kernels, states)),
            tuple(state.S.shape), int(swarm_size), int(max_iters),
            state.S.dtype, state.S.device)


def _copy_into(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]):
    for a, b in zip(dst, src):
        a.copy_(b)


class FusedSwarmGraph:
    """``fused_swarm_optimize`` captured as one CUDA graph (for a safe set
    with a leading campaign axis, ``fleet_swarm_optimize``: the K
    campaigns' batched iteration as one graph, replayed once per fleet
    step).

    The constructor allocates static copies of every operand, runs the
    iteration once eagerly on a side stream (the lazy initialisations,
    such as cuBLAS's workspace for that stream, must not happen inside a
    capture) and captures it on that stream. No step of it reads the
    device from the host, so it may run where a host sync is an error;
    a capture that fails (an operation that syncs, or one a graph cannot
    hold) raises, and nothing falls back to the eager path.

    ``replay`` takes ``fused_swarm_optimize``'s arguments, copies them
    into the static buffers on the current stream, launches the graph
    and returns clones of its outputs, which the next replay does not
    overwrite.
    """

    def __init__(self, kernels, states, state: SwarmIterState, streams,
                 velocity_scale, bounds, fmin, scaling, threshold,
                 scalar_pack, *, swarm_size: int, max_iters: int,
                 ucb: bool = False):
        self.key = graph_key(kernels, states, state, swarm_size=swarm_size,
                             max_iters=max_iters, ucb=ucb)
        dev = state.S.device
        self._leaves = [[t.clone() for t in kernel_leaves(k)]
                        for k in kernels]
        kernels_s = tuple(with_leaves(k, ls)
                          for k, ls in zip(kernels, self._leaves))
        self._states = [
            GPState(**{f: (getattr(st, f).clone() if f in _PREDICT_FIELDS
                           else None) for f in GPState._fields})
            for st in states]
        self._state = SwarmIterState(*(t.clone() for t in state))
        self._streams = {k: v.clone() for k, v in streams.items()}
        self._consts = [t.clone() for t in (velocity_scale, bounds, fmin,
                                             scaling, threshold,
                                             scalar_pack)]
        run = partial(fleet_swarm_optimize if state.S.dim() == 3
                      else fused_swarm_optimize, kernels_s,
                      tuple(self._states),
                      self._state, self._streams, *self._consts,
                      swarm_size=swarm_size, max_iters=max_iters, ucb=ucb)

        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            run()                                   # warm-up, eager
            self.graph.capture_begin()
            try:
                self._out = run()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass                            # the capture is void
                raise
            self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def replay(self, kernels, states, state: SwarmIterState, streams,
               velocity_scale, bounds, fmin, scaling, threshold,
               scalar_pack) -> SwarmIterOut:
        """Refill the static operands, launch the graph and return its
        outputs' clones (all on the current stream)."""
        for dst, k in zip(self._leaves, kernels):
            _copy_into(dst, kernel_leaves(k))
        for dst, st in zip(self._states, states):
            _copy_into([getattr(dst, f) for f in _PREDICT_FIELDS],
                       [getattr(st, f) for f in _PREDICT_FIELDS])
        _copy_into(self._state, state)
        for name, buf in self._streams.items():
            buf.copy_(streams[name])
        _copy_into(self._consts, (velocity_scale, bounds, fmin, scaling,
                                  threshold, scalar_pack))
        self.graph.replay()
        out = self._out
        return out._replace(
            state=SwarmIterState(*(t.clone() for t in out.state)),
            **{f: getattr(out, f).clone() for f in out._fields
               if f != "state"})

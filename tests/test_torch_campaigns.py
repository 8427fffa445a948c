"""The port's campaign fleets against safeopt_tpu's and against solo runs,
float64 on the CPU.

Mirrors ``tests/test_campaigns.py`` with safeopt_tpu's fleets at
``mesh=None`` (one ``jax.vmap``): the fleet equal to solo runs, a
heterogeneous ``objective_args_batch``, the swarm fleet and an RBF +
Poly fleet (a GP on the eager route). ``run_safeopt_campaigns`` gives
safeopt_tpu's queries to 1e-8 and its ``next_idx`` when safeopt_tpu gets
explicit per-campaign ``it_keys`` and the port the normals
``jax.random.normal(it_keys[k, t], (G,))``; ``run_swarmopt_campaigns``
gives safeopt_tpu's with the uniforms those keys draw (in the fused
program's order, as ``tests/test_torch_swarm_loop.py`` draws them). Each
fleet equals K solo runs of the port's loops: decisions equal, queries
to 1e-12 (``gp_append`` under vmap differs from the solo append in the
last bits). K3's plain version with a mask per campaign equals one call
per mask, bitwise; a contextual fleet; the mirrors leave the caller's
states untouched; the argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms.runner import (run_safeopt_loop,
                                             run_swarmopt_loop)
from safeopt_torch.algorithms.swarm_opt_fused import (SwarmIterState,
                                                      stream_layout)
from safeopt_torch.ops import fused_expander as fe
from safeopt_torch.parallel import (run_safeopt_campaigns,
                                    run_swarmopt_campaigns, shard_campaigns,
                                    stack_campaign_states)
from safeopt_tpu.algorithms.swarm_opt_fused import \
    SwarmIterState as JaxIterState
from safeopt_tpu.parallel import run_safeopt_campaigns as jax_fleet
from safeopt_tpu.parallel import run_swarmopt_campaigns as jax_swarm_fleet
from safeopt_tpu.parallel import stack_campaign_states as jax_stack

K, N_ITER = 4, 4
GRID = np.asarray(jt.linearly_spaced_combinations([(-2.0, 2.0),
                                                   (-2.0, 2.0)], 17))
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _f_jax(x):
    return 2.0 * jnp.exp(-0.5 * jnp.sum(x * x))


def _g_jax(x):
    return 1.0 - 0.1 * jnp.sum(x * x)


def _f_torch(x):
    return 2.0 * torch.exp(-0.5 * torch.sum(x * x))


def _g_torch(x):
    return 1.0 - 0.1 * torch.sum(x * x)


def _shifted_jax(x, c):
    return 2.0 * jnp.exp(-0.5 * jnp.sum((x - c) ** 2))


def _shifted_torch(x, c):
    return 2.0 * torch.exp(-0.5 * torch.sum((x - c) ** 2))


def _kernels(pkg, variant):
    """(objective kernel, constraint kernel or None) of a variant."""
    if variant == "poly":
        return (pkg.RBF(2, variance=2.0, lengthscale=1.2)
                + pkg.Poly(2, variance=0.05, scale=0.1, bias=0.5,
                           order=2.0), None)
    return (pkg.RBF(2, variance=2.0, lengthscale=1.2),
            None if variant == "one" else
            pkg.Matern32(2, variance=1.0, lengthscale=1.5))


def _campaign_gps(pkg, variant, seed, capacity=16, n_obs=1):
    """One campaign's GPs: the objective and, past ``'one'``/``'poly'``,
    a constraint, seeded at points drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(n_obs, 2))
    where = {"device": "cpu"} if pkg is pt else {}
    k0, k1 = _kernels(pkg, variant)
    t0 = torch.tensor(x0)
    y0 = np.array([[float(_f_torch(x))] for x in t0])
    gps = [pkg.GPRegression(x0, y0, k0, noise_var=1e-4, capacity=capacity,
                            **where)]
    if k1 is not None:
        y1 = np.array([[float(_g_torch(x))] for x in t0])
        gps.append(pkg.GPRegression(x0, y1, k1, noise_var=1e-4,
                                    capacity=capacity, **where))
    return gps


def _settings(n_gps, variant):
    if n_gps == 1:
        scale = np.sqrt(2.0 + (0.05 * 0.25 if variant == "poly" else 0.0))
        return [0.5], [scale], [0.0]
    return [-np.inf, 0.0], [np.sqrt(2.0), 1.0], [0.05, 0.05]


def _objectives(n_gps):
    return (_f_torch, _g_torch)[:n_gps], (_f_jax, _g_jax)[:n_gps]


def _port_fleet(variant, noise=None, noise_std=0.0, chunk=16, seeds=None,
                **kw):
    """The port's fleet of K campaigns and its per-campaign inputs."""
    seeds = range(K) if seeds is None else seeds
    per = [_campaign_gps(pt, variant, s) for s in seeds]
    kernels = tuple(g.kern for g in per[0])
    states = [tuple(g.factor_state() for g in gps) for gps in per]
    fmin, scaling, threshold = _settings(len(kernels), variant)
    objectives = kw.pop("objectives", _objectives(len(kernels))[0])
    fleet = run_safeopt_campaigns(
        kernels, stack_campaign_states(states), _t(GRID), _t(fmin), 2.0,
        _t(scaling), _t(threshold), noise, objectives=objectives,
        n_iter=N_ITER, noise_std=noise_std, chunk=chunk, **kw)
    return fleet, kernels, states, (fmin, scaling, threshold), objectives


def _assert_fleet_is_solo(fleet, kernels, states, settings, objectives,
                          noise=None, noise_std=0.0, chunk=16, args=None,
                          **kw):
    fmin, scaling, threshold = settings
    for k, st in enumerate(states):
        solo = run_safeopt_loop(
            kernels, st, _t(GRID), _t(fmin), 2.0, _t(scaling),
            _t(threshold), None if noise is None else noise[k],
            objectives=objectives, n_iter=N_ITER, noise_std=noise_std,
            chunk=chunk, objective_args=None if args is None else args[k],
            **kw)
        assert_array_equal(fleet.next_idx[k].numpy(), solo.next_idx.numpy())
        assert_array_equal(fleet.walk_chunks[k].numpy(),
                           solo.walk_chunks.numpy())
        assert_array_equal(fleet.safe_counts[k].numpy(),
                           solo.safe_counts.numpy())
        assert_allclose(fleet.xs[k].numpy(), solo.xs.numpy(), rtol=0,
                        atol=1e-12)
        assert_allclose(fleet.ys[k].numpy(), solo.ys.numpy(), rtol=0,
                        atol=1e-12)
        for a, b in zip(fleet.states, solo.states):
            assert int(a.count[k]) == int(b.count)
            assert_allclose(a.Linv[k].numpy(), b.Linv.numpy(), rtol=0,
                            atol=1e-10)


@pytest.mark.parametrize("variant,noise_std",
                         [("one", 0.0), ("two", 0.05), ("poly", 0.0)],
                         ids=["one-gp", "two-gps-noise", "rbf+poly"])
def test_fleet_matches_safeopt_tpu_fleet(variant, noise_std):
    """safeopt_tpu's fleet (mesh=None) and the port's, the same normals:
    equal next_idx, queries and observations to 1e-8."""
    n_gps = 1 if variant in ("one", "poly") else 2
    keys = jax.random.split(jax.random.key(7), K)
    it_keys = jnp.stack([jax.random.split(k, N_ITER) for k in keys])
    jgps = [_campaign_gps(jt, variant, s) for s in range(K)]
    fmin, scaling, threshold = _settings(n_gps, variant)
    theirs = jax_fleet(
        tuple(g.kern for g in jgps[0]),
        jax_stack([tuple(g.state for g in gps) for gps in jgps]),
        jnp.asarray(GRID), jnp.asarray(fmin), jnp.asarray(2.0),
        jnp.asarray(scaling), jnp.asarray(threshold), keys,
        objectives=_objectives(n_gps)[1], n_iter=N_ITER, chunk=16,
        noise_std=noise_std, it_keys=it_keys)
    normals = np.stack([[np.asarray(jax.random.normal(it_keys[k, t],
                                                      (n_gps,)))
                         for t in range(N_ITER)] for k in range(K)])
    ours = _port_fleet(variant, _t(normals), noise_std)[0]
    assert ours.xs.shape == (K, N_ITER, 2)
    assert bool(ours.has_safe.all())
    assert_array_equal(ours.next_idx.numpy(), np.asarray(theirs.next_idx))
    assert_allclose(ours.xs.numpy(), np.asarray(theirs.xs), rtol=0,
                    atol=1e-8)
    assert_allclose(ours.ys.numpy(), np.asarray(theirs.ys), rtol=0,
                    atol=1e-8)
    assert_array_equal(ours.safe_counts.numpy(),
                       np.asarray(theirs.safe_counts))


@pytest.mark.parametrize("variant,kw", [
    ("two", {}), ("two", {"chunk": 1}), ("poly", {}),
    ("two", {"use_lipschitz": True, "lipschitz": _t([1.0, 20.0]),
             "chunk": 1}),
    ("two", {"ucb": True}), ("two", {"dtype": torch.float32})],
    ids=["two-gps", "chunk-1", "rbf+poly", "lipschitz", "ucb", "float32"])
def test_fleet_equals_solo_runs(variant, kw):
    """Each campaign of the fleet makes its solo loop's decisions, walks
    as many chunks, and appends the same rows."""
    kw = dict(kw)
    noise = torch.randn((K, N_ITER, 2 if variant == "two" else 1),
                        generator=torch.Generator().manual_seed(3),
                        dtype=F64)
    fleet, kernels, states, settings, objectives = _port_fleet(
        variant, noise, 0.02, **kw)
    assert fleet.host_syncs.shape == (N_ITER,)
    chunk = kw.pop("chunk", 16)
    _assert_fleet_is_solo(fleet, kernels, states, settings, objectives,
                          noise, 0.02, chunk=chunk, **kw)


def test_fleet_walks_in_lock_step():
    """A fleet whose campaigns walk different numbers of chunks reads the
    host once for the counts and once per walk round: its syncs per step
    are 1 + the longest walk, not the campaigns' sum."""
    fleet, kernels, states, settings, objectives = _port_fleet(
        "two", chunk=1, use_lipschitz=True, lipschitz=_t([1.0, 20.0]))
    chunks = fleet.walk_chunks.numpy()
    assert (chunks.max(axis=0) != chunks.min(axis=0)).any()
    assert_array_equal(fleet.host_syncs.numpy(), 1 + chunks.max(axis=0))


def test_heterogeneous_fleet_matches_safeopt_tpu_and_solo():
    """objective_args_batch: campaign k optimizes a shifted objective;
    the port's fleet gives safeopt_tpu's and its solo runs'."""
    centers = np.linspace(-0.8, 0.8, K)[:, None] * np.ones((1, 2))
    keys = jax.random.split(jax.random.key(9), K)
    it_keys = jnp.stack([jax.random.split(k, 3) for k in keys])

    def gps(pkg, k):
        x0 = np.random.default_rng(k).uniform(-0.3, 0.3, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum((x0 - centers[k]) ** 2))
        where = {"device": "cpu"} if pkg is pt else {}
        return (pkg.GPRegression(x0, np.array([[y0]]),
                                 pkg.RBF(2, variance=2.0, lengthscale=1.2),
                                 noise_var=1e-4, capacity=16, **where),)

    common = dict(n_iter=3, chunk=16)
    theirs = jax_fleet(
        (jt.RBF(2, variance=2.0, lengthscale=1.2),),
        jax_stack([(gps(jt, k)[0].state,) for k in range(K)]),
        jnp.asarray(GRID), jnp.asarray([0.4]), jnp.asarray(2.0),
        jnp.asarray([np.sqrt(2.0)]), jnp.asarray([0.0]), keys,
        objectives=(_shifted_jax,), objective_args_batch=jnp.asarray(centers),
        it_keys=it_keys, **common)
    states = [(gps(pt, k)[0].factor_state(),) for k in range(K)]
    kern = (pt.RBF(2, variance=2.0, lengthscale=1.2),)
    ours = run_safeopt_campaigns(
        kern, stack_campaign_states(states), _t(GRID), _t([0.4]), 2.0,
        _t([np.sqrt(2.0)]), _t([0.0]), objectives=(_shifted_torch,),
        objective_args_batch=_t(centers), **common)
    assert_array_equal(ours.next_idx.numpy(), np.asarray(theirs.next_idx))
    assert_allclose(ours.ys.numpy(), np.asarray(theirs.ys), rtol=0,
                    atol=1e-8)
    assert not np.allclose(ours.xs[0].numpy(), ours.xs[-1].numpy())
    for k in (0, K - 1):
        solo = run_safeopt_loop(
            kern, states[k], _t(GRID), _t([0.4]), 2.0, _t([np.sqrt(2.0)]),
            _t([0.0]), objectives=(_shifted_torch,),
            objective_args=_t(centers[k]), **common)
        assert_array_equal(ours.next_idx[k].numpy(), solo.next_idx.numpy())
        assert_allclose(ours.ys[k].numpy(), solo.ys.numpy(), rtol=0,
                        atol=1e-12)


def test_contextual_fleet_equals_solo_runs():
    """A shared context schedule (the JAX package's vmapped loop shares
    ``contexts``): each campaign equals its solo contextual loop."""
    params = np.linspace(-2.0, 2.0, 41)[:, None]
    grid = np.hstack([params, np.zeros_like(params)])
    kern = (pt.RBF(2, variance=2.0, lengthscale=[1.0, 0.5], ARD=True),)
    contexts = np.array([[0.0], [0.0], [0.3], [0.3]])

    def f(x):
        return 2.0 * torch.exp(-0.5 * (x[0] - x[1]) ** 2)

    states = []
    for k in range(K):
        x0 = np.array([[0.2 * k - 0.3, 0.0]])
        states.append((pt.GPRegression(
            x0, np.array([[float(f(torch.tensor(x0[0])))]]), kern[0].copy(),
            noise_var=1e-4, capacity=16, device="cpu").factor_state(),))
    common = dict(objectives=(f,), n_iter=N_ITER, chunk=4,
                  contexts=_t(contexts))
    fleet = run_safeopt_campaigns(
        kern, stack_campaign_states(states), _t(grid), _t([0.5]), 2.0,
        _t([np.sqrt(2.0)]), _t([0.0]), **common)
    assert_array_equal(fleet.xs[:, :, 1].numpy(),
                       np.broadcast_to(contexts[:, 0], (K, N_ITER)))
    for k in range(K):
        solo = run_safeopt_loop(kern, states[k], _t(grid), _t([0.5]), 2.0,
                                _t([np.sqrt(2.0)]), _t([0.0]), **common)
        assert_array_equal(fleet.next_idx[k].numpy(), solo.next_idx.numpy())
        assert_allclose(fleet.xs[k].numpy(), solo.xs.numpy(), rtol=0,
                        atol=1e-12)


def test_fleet_leaves_the_callers_states_untouched():
    """The loop's mirrors and its grown states never alias the batched
    states it was given."""
    per = [tuple(g.factor_state() for g in _campaign_gps(pt, "two", s))
           for s in range(K)]
    batched = stack_campaign_states(per)
    before = [[t.clone() for t in st] for st in batched]
    fleet = run_safeopt_campaigns(
        tuple(g.kern for g in _campaign_gps(pt, "two", 0)), batched,
        _t(GRID), _t([-np.inf, 0.0]), 2.0, _t([np.sqrt(2.0), 1.0]),
        _t([0.05, 0.05]), objectives=(_f_torch, _g_torch), n_iter=N_ITER,
        dtype=torch.float32)
    for st, old in zip(batched, before):
        for t, o in zip(st, old):
            assert torch.equal(t, o)
    assert [int(c) for c in fleet.states[0].count] == [1 + N_ITER] * K


def test_k3_plain_with_a_mask_per_campaign_is_one_call_per_mask():
    """K3's plain version with an (R, N) mask equals R calls, each with its
    campaign's GPs and its (N,) mask, bitwise; a campaign whose mask is
    all False gets an all-False row."""
    R = 3
    gps = [_campaign_gps(pt, "one", s, n_obs=4)[0] for s in (0, 1)]
    kernels = [g.kern for g in gps]
    states = [g.factor_state() for g in gps]
    grid = _t(GRID)
    N = grid.shape[0]
    rng = np.random.default_rng(4)
    masks = torch.tensor(rng.uniform(size=(R, N)) < 0.6)
    masks[1] = False
    mus = _t(rng.normal(size=(2, N)))
    sigmas = _t(rng.uniform(0.1, 1.0, size=(2, N)))
    gidx = torch.tensor(rng.choice(N, 8, replace=False))
    Xc = grid[gidx]
    ucs = _t(rng.uniform(0.5, 2.0, size=(2, 8)))
    valid = torch.ones(8, dtype=torch.bool)
    fmin = _t([0.3, -0.2])
    solo = [fe.fused_expander(*fe.expander_operands(
        kernels, states, grid, masks[r], mus, sigmas, Xc, ucs, valid, 2.0,
        fmin)) for r in range(R)]
    ops = list(fe.expander_operands(kernels, states, grid, masks[0], mus,
                                    sigmas, Xc, ucs, valid, 2.0, fmin))
    rep = range(2, 10)                  # every operand with a GP axis
    for i in rep:
        ops[i] = ops[i].repeat((R,) + (1,) * (ops[i].dim() - 1))
    ops[1] = masks
    fleet = fe.fused_expander(*ops)
    assert torch.equal(fleet, torch.cat(solo))
    assert not fleet[2:4].any() and fleet[[0, 1, 4, 5]].any()


def test_fleet_expander_operands_are_the_solo_operands():
    """The fleet's batched candidate terms equal expander_operands's per
    campaign (float64, to round-off)."""
    per = [[_campaign_gps(pt, "one", 2 * s + j, n_obs=3)[0].factor_state()
            for j in (0, 1)] for s in range(2)]
    kernels = [pt.RBF(2, variance=2.0, lengthscale=1.2)] * 2
    batched = stack_campaign_states([tuple(p) for p in per])
    grid = _t(GRID)
    N = grid.shape[0]
    rng = np.random.default_rng(5)
    masks = torch.tensor(rng.uniform(size=(2, N)) < 0.5)
    mus = _t(rng.normal(size=(2, 2, N)))
    sigmas = _t(rng.uniform(0.1, 1.0, size=(2, 2, N)))
    Xc = grid[torch.tensor(rng.choice(N, (2, 5)))]
    ucs = _t(rng.uniform(size=(2, 2, 5)))
    valid = torch.tensor([[True] * 5, [True] * 3 + [False] * 2])
    fmin = _t([0.1, 0.2])
    fleet = fe.fleet_expander_operands(kernels, batched, grid, masks, mus,
                                       sigmas, Xc, ucs, valid, 2.0, fmin)
    for r in range(2):
        solo = fe.expander_operands(kernels, per[r], grid, masks[r], mus[r],
                                    sigmas[r], Xc[r], ucs[r], valid[r], 2.0,
                                    fmin)
        for i, (a, b) in enumerate(zip(fleet[2:10], solo[2:10])):
            assert_allclose(a[2 * r:2 * r + 2].numpy(), b.numpy(), rtol=0,
                            atol=1e-12, err_msg=f"operand {i + 2}")
        assert torch.equal(fleet[1][r], solo[1])


# --- the swarm fleet -------------------------------------------------------

D, SWARM, ITERS, CAP = 2, 8, 8, 64


def _swarm_inputs(pkg, k):
    """Campaign k: its GP (seeded at x0 near the origin) and safe set."""
    x0 = np.random.default_rng(k).uniform(-0.3, 0.3, size=(1, D))
    where = {"device": "cpu"} if pkg is pt else {}
    gp = pkg.GPRegression(x0, np.array([[float(_f_torch(torch.tensor(
        x0[0])))]]), pkg.RBF(D, variance=2.0, lengthscale=1.2),
        noise_var=1e-4, capacity=16, **where)
    S = np.zeros((CAP, D))
    S[0] = x0[0]
    return gp, S, x0[0]


def _jax_swarm_draws(it_keys):
    """safeopt_tpu's uniforms (flat, ``stream_layout``'s order) and noise
    normals for one campaign's ``it_keys``."""
    layout = stream_layout(SWARM, ITERS, D)
    flat, normals = [], []
    for key in it_keys:
        k_swarm, k_noise = jax.random.split(key)
        parts = {}
        for sk, s in zip(jax.random.split(k_swarm, 3),
                         ("greedy", "maximizers", "expanders")):
            k1, k2, k3 = jax.random.split(sk, 3)
            n = SWARM - 3 if s == "greedy" else SWARM
            parts[s + "_idx"] = jax.random.uniform(k1, (n,), jnp.float64)
            parts[s + "_vel"] = jax.random.uniform(k2, (SWARM, D),
                                                   jnp.float64)
            parts[s + "_r"] = jax.random.uniform(k3, (ITERS, 2, SWARM, D),
                                                 jnp.float64)
        flat.append(np.concatenate([np.asarray(parts[name]).ravel()
                                    for name, _ in layout]))
        normals.append(np.asarray(jax.random.normal(k_noise, (1,),
                                                    jnp.float64)))
    return np.stack(flat), np.stack(normals)


SWARM_CONSTS = dict(velocity_scale=[0.3, 0.3],
                    bounds=[[-3.0, 3.0], [-3.0, 3.0]], fmin=[0.0],
                    scaling=[np.sqrt(2.0)], threshold=[0.0])


def _port_swarm_fleet(streams, noise=None, noise_std=0.0, args=None,
                      objectives=(_f_torch,)):
    inputs = [_swarm_inputs(pt, k) for k in range(K)]
    states = [(gp.factor_state(),) for gp, _, _ in inputs]
    iters = [SwarmIterState(S=_t(S), count=torch.tensor(1), greedy=_t(g))
             for _, S, g in inputs]
    c = SWARM_CONSTS
    greedy0s = _t(np.stack([g for _, _, g in inputs]))
    fleet = run_swarmopt_campaigns(
        (inputs[0][0].kern,), stack_campaign_states(states),
        stack_campaign_states(iters), c["velocity_scale"], c["bounds"],
        c["fmin"], c["scaling"], c["threshold"], np.full(N_ITER, 2.0),
        greedy0s, _t([-np.inf] * K), streams, noise, objectives=objectives,
        n_iter=N_ITER, swarm_size=SWARM, max_iters=ITERS,
        noise_std=noise_std, objective_args_batch=args)
    return fleet, inputs, states, iters, greedy0s


def test_swarm_fleet_matches_safeopt_tpu_fleet():
    """safeopt_tpu's swarm fleet (mesh=None, explicit it_keys) and the
    port's fed the uniforms and normals those keys draw."""
    keys = jax.random.split(jax.random.key(3), K)
    it_keys = jnp.stack([jax.random.split(k, N_ITER) for k in keys])
    inputs = [_swarm_inputs(jt, k) for k in range(K)]
    c = SWARM_CONSTS
    theirs = jax_swarm_fleet(
        (inputs[0][0].kern,), jax_stack([(gp.state,) for gp, _, _ in inputs]),
        jax_stack([JaxIterState(S=jnp.asarray(S),
                                count=jnp.asarray(1, jnp.int32),
                                greedy=jnp.asarray(g))
                   for _, S, g in inputs]),
        keys, *(jnp.asarray(c[n]) for n in ("velocity_scale", "bounds",
                                             "fmin", "scaling",
                                             "threshold")),
        np.full(N_ITER, 2.0), jnp.asarray(np.stack([g for _, _, g in
                                                    inputs])),
        jnp.full((K,), -jnp.inf), objectives=(_f_jax,), n_iter=N_ITER,
        swarm_size=SWARM, max_iters=ITERS, noise_std=0.01, it_keys=it_keys)
    draws = [_jax_swarm_draws(it_keys[k]) for k in range(K)]
    ours = _port_swarm_fleet(_t(np.stack([f for f, _ in draws])),
                             _t(np.stack([n for _, n in draws])), 0.01)[0]
    assert ours.xs.shape == (K, N_ITER, D)
    assert bool((ours.num_safe_min > 0).all())
    assert_allclose(ours.xs.numpy(), np.asarray(theirs.xs), rtol=0,
                    atol=1e-8)
    assert_allclose(ours.best_lower_bounds.numpy(),
                    np.asarray(theirs.best_lower_bounds), rtol=0, atol=1e-8)
    assert_array_equal(ours.safe_counts.numpy(),
                       np.asarray(theirs.safe_counts))
    assert ours.host_syncs.tolist() == [0] * N_ITER


@pytest.mark.parametrize("heterogeneous", [False, True],
                         ids=["homogeneous", "objective-args"])
def test_swarm_fleet_equals_solo_runs(heterogeneous):
    """Each campaign of the swarm fleet gives its solo run_swarmopt_loop's
    queries (1e-12) and safe-set counts."""
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(SWARM, ITERS, D))
    streams = torch.rand((K, N_ITER, n_u),
                         generator=torch.Generator().manual_seed(8),
                         dtype=F64)
    args = _t(np.linspace(-0.5, 0.5, K)[:, None] * np.ones((1, D))) \
        if heterogeneous else None
    objectives = (_shifted_torch,) if heterogeneous else (_f_torch,)
    fleet, inputs, states, iters, greedy0s = _port_swarm_fleet(
        streams, args=args, objectives=objectives)
    if heterogeneous:
        assert not np.allclose(fleet.xs[0].numpy(), fleet.xs[-1].numpy())
    c = SWARM_CONSTS
    for k in range(K):
        solo = run_swarmopt_loop(
            (inputs[k][0].kern,), states[k], iters[k], c["velocity_scale"],
            c["bounds"], c["fmin"], c["scaling"], c["threshold"],
            np.full(N_ITER, 2.0), greedy0s[k], -np.inf, streams[k],
            objectives=objectives, n_iter=N_ITER, swarm_size=SWARM,
            max_iters=ITERS,
            objective_args=None if args is None else args[k])
        assert_allclose(fleet.xs[k].numpy(), solo.xs.numpy(), rtol=0,
                        atol=1e-12)
        assert_allclose(fleet.best_lower_bounds[k].numpy(),
                        solo.best_lower_bounds.numpy(), rtol=0, atol=1e-12)
        assert_array_equal(fleet.safe_counts[k].numpy(),
                           solo.safe_counts.numpy())
        assert torch.equal(fleet.iter_state.S[k], solo.iter_state.S)


# --- argument checks -------------------------------------------------------

def test_stack_refuses_unequal_capacities():
    """Campaigns of different capacities do not stack; nor does none."""
    a = (_campaign_gps(pt, "one", 0, capacity=16)[0].factor_state(),)
    b = (_campaign_gps(pt, "one", 1, capacity=32)[0].factor_state(),)
    with pytest.raises(ValueError, match="share capacities"):
        stack_campaign_states([a, b])
    with pytest.raises(ValueError, match="at least one"):
        stack_campaign_states([])


def test_fleet_refuses_wrong_noise_and_a_mesh():
    """Noise and stream shapes are checked, a mesh must be a device mesh
    with the named axis (``tests/test_torch_sharding.py`` runs the fleets
    over real meshes), and a fleet without room for its iterations is
    refused."""
    noise = torch.zeros((K, N_ITER + 1, 1), dtype=F64)
    with pytest.raises(ValueError, match="noise: shape"):
        _port_fleet("one", noise, 0.1)
    with pytest.raises(ValueError, match="named axis of a device mesh"):
        _port_fleet("one", mesh=object())
    with pytest.raises(ValueError, match="named axis of a device mesh"):
        shard_campaigns((), object())
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(SWARM, ITERS, D))
    with pytest.raises(ValueError, match="streams: shape"):
        _port_swarm_fleet(torch.zeros((K, N_ITER, n_u + 1), dtype=F64))
    with pytest.raises(ValueError, match="noise: shape"):
        _port_swarm_fleet(torch.zeros((K, N_ITER, n_u), dtype=F64),
                          torch.zeros((K, N_ITER, 2), dtype=F64), 0.1)
    full = (_campaign_gps(pt, "one", 0, capacity=4)[0].factor_state(),)
    with pytest.raises(ValueError, match="do not admit"):
        run_safeopt_campaigns(
            (pt.RBF(2),), stack_campaign_states([full] * 2), _t(GRID),
            _t([0.5]), 2.0, _t([1.0]), _t([0.0]), objectives=(_f_torch,),
            n_iter=4)


def test_campaigns_refuse_unbatched_states():
    """The fleets take states with a leading campaign axis; the swarm loop
    refuses GP states and safe-set buffers of different campaign axes."""
    solo = (_campaign_gps(pt, "one", 0)[0].factor_state(),)
    with pytest.raises(ValueError, match="batched states"):
        run_safeopt_campaigns(
            (pt.RBF(2),), solo, _t(GRID), _t([0.5]), 2.0, _t([1.0]),
            _t([0.0]), objectives=(_f_torch,), n_iter=2)
    gp, S, g = _swarm_inputs(pt, 0)
    it = SwarmIterState(S=_t(S), count=torch.tensor(1), greedy=_t(g))
    c = SWARM_CONSTS
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(SWARM, ITERS, D))
    args = ((gp.kern,), stack_campaign_states([(gp.factor_state(),)] * 2),
            it, c["velocity_scale"], c["bounds"], c["fmin"], c["scaling"],
            c["threshold"], np.full(2, 2.0), _t(g), -np.inf,
            torch.zeros((2, n_u), dtype=F64))
    with pytest.raises(ValueError, match="campaign axes"):
        run_swarmopt_loop(*args, objectives=(_f_torch,), n_iter=2,
                          swarm_size=SWARM, max_iters=ITERS)
    with pytest.raises(ValueError, match="batched states"):
        run_swarmopt_campaigns(args[0], (gp.factor_state(),),
                               *args[2:], objectives=(_f_torch,), n_iter=2,
                               swarm_size=SWARM, max_iters=ITERS)

"""The port's deployment through ``torch.export`` on the CPU in float64,
and the traced step's walk on the device.

Mirrors ``tests/test_deployment.py`` case by case: a CPU artifact (the
grid kernels' plain versions through K1-K4's operators) saved, loaded
and called equals the live step; it serves new observations and new
hyperparameters without a new export; whole campaigns export; every
public kernel exports or raises a one-line ``TypeError`` naming itself;
``load_step`` takes a ``pathlib.Path``. The exported step is held
against ``safeopt_tpu``'s ``safeopt_step`` on the same data (decisions
equal, ``Q`` to 1e-12: the same float64 formulas in another summation
order). The traced walk (``_find_first_expander_traced``) is held
against the live one on engineered candidate sets: none, no unsafe
point, a hit in the first chunk, in a later chunk and in the last
partial one, no hit, exact ties in width, and the Lipschitz variant: G
and the chunk count equal.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import safe_opt_core as core
from safeopt_torch.algorithms.runner import (run_safeopt_loop,
                                             run_swarmopt_loop)
from safeopt_torch.algorithms.swarm_opt_fused import (SwarmIterState,
                                                      stream_layout)
from safeopt_torch.gp import kernels as K
from safeopt_torch.utils.deployment import (export_campaign, export_step,
                                            export_swarm_campaign,
                                            load_step)
from safeopt_tpu.algorithms.safe_opt_core import \
    safeopt_step as jax_safeopt_step

CPU = dict(device="cpu")
F64 = torch.float64
CHUNK = 16


def _t(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=F64)


def _data(seed=8, n=6):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2))
    return X, (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]


def _problem(kern=None, n_grid=17, fmin=0.2):
    X, Y = _data()
    gp = pt.GPRegression(X, Y, kern or pt.RBF(2, variance=2.0),
                         noise_var=0.01, capacity=16, **CPU)
    grid = _t(pt.linearly_spaced_combinations([(-3.0, 3.0)] * 2, n_grid))
    args = ((gp.kern,), (gp.state,), grid, _t([fmin]), _t(2.0),
            _t([np.sqrt(2.0)]), _t([0.0]))
    return gp, args


def _live(args, **kw):
    """The live step on ``args`` (beta as the float it takes)."""
    return core.safeopt_step(*args[:4], float(args[4]), *args[5:],
                             chunk=CHUNK, **kw)


def _assert_same_step(out, ref):
    for name in ("Q", "S", "M", "G"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert int(out.next_idx) == int(ref.next_idx)


def test_export_roundtrip_matches_direct_step(tmp_path):
    gp, args = _problem()
    path = str(tmp_path / "step.pt2")
    blob = export_step(*args, chunk=CHUNK, path=path)
    assert len(blob) > 1000
    assert open(path, "rb").read() == blob
    out = load_step(path)(*args)
    _assert_same_step(out, _live(args))
    assert int(out.walk_chunks) == _live(args).walk_chunks


def test_exported_step_accepts_runtime_updates():
    """Hyperparameters, observations and scalars are runtime arguments:
    one artifact serves an updated model without a new export."""
    gp, args = _problem()
    served = load_step(export_step(*args, chunk=CHUNK))
    gp.append_data(np.array([0.3, -0.2]), 1.4)
    kern2 = pt.RBF(2, variance=1.5, lengthscale=1.3)
    new_args = ((kern2,), (gp.state,), args[2], args[3], _t(3.0), args[5],
                args[6])
    _assert_same_step(served(*new_args), _live(new_args))


def test_exported_step_matches_safeopt_tpu():
    X, Y = _data()
    gp = pt.GPRegression(X, Y, pt.RBF(2, variance=2.0), noise_var=0.01,
                         capacity=16, **CPU)
    jgp = jt.GPRegression(X, Y, jt.RBF(2, variance=2.0), noise_var=0.01,
                          capacity=16)
    grid_np = np.asarray(pt.linearly_spaced_combinations([(-3.0, 3.0)] * 2,
                                                         17))
    consts = ([0.2], 2.0, [np.sqrt(2.0)], [0.0])
    args = ((gp.kern,), (gp.state,), _t(grid_np),
            *map(_t, consts))
    out = load_step(export_step(*args, chunk=CHUNK))(*args)
    ref = jax_safeopt_step((jgp.kern,), (jgp.state,), jnp.asarray(grid_np),
                           *map(jnp.asarray, consts), chunk=CHUNK)
    for name in ("S", "M", "G"):
        assert np.array_equal(getattr(out, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert int(out.next_idx) == int(ref.next_idx)
    assert_allclose(out.Q.numpy(), np.asarray(ref.Q), rtol=0, atol=1e-12)


def test_export_whole_campaign():
    """A complete device tuning job as one artifact: the served campaign
    reproduces the direct loop for any runtime noise."""
    x0 = np.array([[0.1, -0.1]])
    gp = pt.GPRegression(x0, np.array([[2.0 * np.exp(-0.01)]]),
                         pt.RBF(2, variance=2.0, lengthscale=1.2),
                         noise_var=1e-4, capacity=32, **CPU)
    grid = _t(pt.linearly_spaced_combinations([(-2.0, 2.0)] * 2, 15))
    args = ((gp.kern,), (gp.factor_state(),), grid, _t([0.5]), _t(2.0),
            _t([np.sqrt(2.0)]), _t([0.0]))

    def objective(x):
        return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    common = dict(objectives=(objective,), n_iter=4, chunk=CHUNK,
                  noise_std=0.05)
    served = load_step(export_campaign(*args, _t(np.zeros((4, 1))),
                                       **common))
    for seed in (0, 5):
        noise = _t(np.random.default_rng(seed).normal(size=(4, 1)))
        out = served(*args, noise)
        ref = run_safeopt_loop(*args[:4], 2.0, *args[5:], noise, **common)
        assert torch.equal(out.next_idx, ref.next_idx)
        assert torch.equal(out.xs, ref.xs)
        assert bool(out.has_safe.all())
        # the walk's while_loop reads its condition before the loop,
        # before each round and after the last
        assert torch.equal(out.host_syncs, out.walk_chunks + 2)


def test_export_roundtrip_ratquad_kernel():
    """RatQuad (the eager route) exports, its power a runtime leaf."""
    kern = K.RatQuad(2, variance=2.0, lengthscale=1.2, power=1.7)
    gp, args = _problem(kern, n_grid=9)
    served = load_step(export_step(*args, chunk=CHUNK))
    _assert_same_step(served(*args), _live(args))
    args2 = ((K.RatQuad(2, variance=2.0, lengthscale=1.2, power=0.6),),) \
        + args[1:]
    _assert_same_step(served(*args2), _live(args2))


def test_export_unregistered_kernel_raises_by_name():
    class Homemade(K.RBF):
        pass

    _, args = _problem()
    with pytest.raises(TypeError, match="Homemade"):
        export_step((Homemade(2, variance=1.0),), *args[1:], chunk=CHUNK)
    with pytest.raises(TypeError, match="Homemade"):
        export_step((K.RBF(2) * Homemade(2),), *args[1:], chunk=CHUNK)


EVERY_KERNEL = [
    K.RBF(2, variance=2.0), K.Matern32(2), K.Matern52(2), K.Exponential(2),
    K.RatQuad(2, power=1.3), K.StdPeriodic(2, period=[2.0, 3.0], ARD1=True),
    K.RBF(2) + K.Bias(2, variance=0.1), K.RBF(2) + K.White(2, variance=1e-3),
    K.RBF(1, active_dims=[0]) * K.Matern32(1, active_dims=[1]),
    K.StdPeriodic(2, period=1.5) * K.RBF(2, lengthscale=4.0),
    K.RatQuad(2, power=2.0) + K.RBF(2), K.RBF(2) + K.Linear(2, variances=0.2),
    K.Cosine(1, lengthscale=1.5, active_dims=[0]) * K.RBF(2, lengthscale=6.),
    K.RBF(2) + K.Poly(2, variance=0.1, scale=0.05, bias=0.5, order=3.0),
    K.MLP(2, variance=1.5, weight_variance=[0.8, 1.2], bias_variance=0.5,
          ARD=True)]


@pytest.mark.parametrize("kern", EVERY_KERNEL,
                         ids=lambda k: type(k).__name__)
def test_every_public_kernel_exports(kern):
    X, Y = _data(n=5)
    gp = pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=8, **CPU)
    grid = _t(pt.linearly_spaced_combinations([(-2.0, 2.0)] * 2, 7))
    args = ((gp.kern,), (gp.state,), grid, _t([0.2]), _t(2.0), _t([1.0]),
            _t([0.0]))
    out = load_step(export_step(*args, chunk=CHUNK))(*args)
    assert torch.equal(out.S, _live(args).S)


def test_load_step_accepts_pathlib_path(tmp_path):
    _, args = _problem()
    p = tmp_path / "step.bin"
    export_step(*args, chunk=CHUNK, path=str(p))
    assert isinstance(p, pathlib.Path)
    assert int(load_step(p)(*args).next_idx) == int(_live(args).next_idx)


def test_export_swarm_campaign():
    d, n_iter = 2, 2
    gp = pt.GPRegression(np.zeros((1, d)), np.array([[2.0]]),
                         pt.RBF(d, variance=2.0, lengthscale=1.5),
                         noise_var=1e-4, capacity=16, **CPU)

    def f(x):
        return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

    layout = stream_layout(8, 8, d)
    U = sum(int(np.prod(s)) for _, s in layout)
    streams = torch.rand((n_iter, U), dtype=F64,
                         generator=torch.Generator().manual_seed(0))
    iter_state = SwarmIterState(S=torch.zeros((64, d), dtype=F64),
                                count=torch.tensor(1),
                                greedy=torch.zeros(d, dtype=F64))
    args = ((gp.kern,), (gp.factor_state(),), iter_state, _t([0.3, 0.3]),
            _t([[-3.0, 3.0]] * d), _t([0.0]), _t([np.sqrt(2.0)]), _t([0.0]),
            _t(np.full(n_iter, 2.0)), torch.zeros(d, dtype=F64),
            _t(-np.inf), streams)
    common = dict(objectives=(f,), n_iter=n_iter, swarm_size=8, max_iters=8)
    out = load_step(export_swarm_campaign(*args, **common))(*args)
    ref = run_swarmopt_loop(*args, **common)
    assert torch.equal(out.xs, ref.xs)
    assert bool((out.num_safe_min > 0).all())


# ---------------------------------------------------------------------------
# the traced walk against the live one
# ---------------------------------------------------------------------------

def _walk_setup(lipschitz=None):
    """A two-GP state whose safe set has expanders and non-expanders, the
    step's operands, and the predicate of every safe candidate."""
    X = np.random.default_rng(3).uniform(-1.5, 1.5, size=(30, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    gps = [pt.GPRegression(X, Y, pt.RBF(2, variance=2.0), noise_var=0.01,
                           capacity=32, **CPU),
           pt.GPRegression(X, 1.0 - 0.3 * np.sum(X ** 2, axis=1)[:, None],
                           pt.Matern32(2, lengthscale=1.5), noise_var=0.01,
                           capacity=32, **CPU)]
    kernels = tuple(g.kern for g in gps)
    states = tuple(g.state for g in gps)
    grid = _t(pt.linearly_spaced_combinations([(-3.0, 3.0)] * 2, 25))
    fmin, beta = _t([0.5, 0.3]), 2.0
    Q, mu, sigma, Vs = core._grid_posterior(kernels, states, grid, beta)
    S = torch.all(Q[:, 0::2] > fmin, dim=1)
    safe = torch.nonzero(S).squeeze(1)
    pred = core._chunk_expander_predicate(kernels, states, grid, Q, ~S, mu,
                                          sigma, fmin, beta, lipschitz,
                                          safe, Vs)
    return (kernels, states, grid, Q, ~S, mu, sigma, fmin, beta), safe, pred


def _walks(common, lipschitz, cand, width):
    host = core._find_first_expander(*common, lipschitz, cand, width, CHUNK)
    traced = core._find_first_expander_traced(*common, lipschitz, cand,
                                              width, CHUNK)
    return host, traced


def _ordered(grid_n, first, *rest):
    """cand and width whose visit order is ``first`` then ``rest``
    (widths descending)."""
    order = list(first) + [i for r in rest for i in r]
    cand = torch.zeros(grid_n, dtype=torch.bool)
    width = torch.zeros(grid_n, dtype=F64)
    cand[order] = True
    width[order] = torch.linspace(2.0, 1.0, len(order), dtype=F64)
    return cand, width


@pytest.mark.parametrize("case", ["none", "no_unsafe", "first_chunk",
                                  "later_chunk", "last_partial", "no_hit",
                                  "ties", "lipschitz"])
def test_traced_walk_matches_the_host_walk(case):
    lip = _t([2.0, 2.0]) if case == "lipschitz" else None
    common, safe, pred = _walk_setup(lip)
    N = common[2].shape[0]
    hits = safe[pred].tolist()
    misses = safe[~pred].tolist()
    assert len(hits) >= 2 and len(misses) > 2 * CHUNK, "needs a mixed set"
    if case == "none":
        cand, width = _ordered(N, [])
    elif case == "no_unsafe":
        cand, width = _ordered(N, hits[:3], misses[:5])
        common = common[:4] + (torch.zeros(N, dtype=torch.bool),) \
            + common[5:]
    elif case in ("first_chunk", "lipschitz"):
        cand, width = _ordered(N, misses[:3], hits, misses[3:])
    elif case == "later_chunk":
        cand, width = _ordered(N, misses[:CHUNK + 5], hits[:1],
                               misses[CHUNK + 5:])
    elif case == "last_partial":
        k = 2 * CHUNK + 3
        cand, width = _ordered(N, misses[:k], hits[-1:])
    elif case == "no_hit":
        cand, width = _ordered(N, misses)
    else:                                        # exact ties in width
        cand = torch.zeros(N, dtype=torch.bool)
        cand[safe] = True
        width = torch.where(cand, 1.0, 0.0).to(F64)
    (G, chunks), (Gt, rounds) = _walks(common, lip, cand, width)
    assert torch.equal(G, Gt)
    assert int(rounds) == chunks
    expected = {"none": 0, "no_unsafe": 0, "no_hit": 0}.get(case, 1)
    assert int(G.sum()) == expected
    if case == "later_chunk":
        assert chunks == 2 and bool(G[hits[0]])
    if case == "last_partial":
        assert chunks == 3 and bool(G[hits[-1]])
    if case == "ties":
        # the larger index first: the hit with the largest grid index
        assert bool(G[max(hits)])

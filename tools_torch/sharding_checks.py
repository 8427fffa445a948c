"""Sharded against unsharded: the port's mesh checks, one spawned world.

``run_world(world_size, cases)`` starts ``world_size`` local processes
(``torch.multiprocessing``, a ``gloo`` group on ``tcp://localhost`` at a
free port, the CPU), runs the named ``CASES`` in order in every rank and
returns ``{case: [None or the error text, per rank]}``. Each case builds
its problem from a seed, runs the port's step (or fleet) unsharded in
the rank and sharded over a mesh, and compares the two after every
collective has run, so that a failed comparison leaves the ranks in
step. The cases mirror ``tests/test_sharding.py`` (a 333-row grid, so
that ties and padding cross shard edges) and the campaign fleets of
``tests/test_campaigns.py``; the certified cases hold each certified
function's sharded results bit for bit against its unsharded call on the
same padded grid, and ``certified_anchor`` leaves its gathered results
in the world's ``out_dir`` for ``tests/test_torch_sharding.py`` to hold
against safeopt_tpu. ``tests/test_torch_sharding.py`` and
``tools_torch/mp_dryrun.py`` run them.

    python3 tools_torch/sharding_checks.py [--world 4] [case ...]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def problem(n_grid: int = 333, safe_last: bool = False):
    """``tests/test_sharding.py``'s problem in the port: an RBF objective
    and a Matern32 constraint over 6 points, capacity 16, on the first
    ``n_grid`` rows of a 2-D grid (333 does not divide by 2, 4 or 8).
    ``safe_last`` moves the row nearest the origin (a safe one) to the
    end, so that the padding rows repeat a safe row."""
    import safeopt_torch as pt

    rng = np.random.default_rng(3)
    X = rng.uniform(-1.0, 1.0, size=(6, 2))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    Yg = (1.0 - 0.2 * np.sum(X ** 2, axis=1))[:, None]
    gp_f = pt.GPRegression(X, Yf, pt.RBF(2, variance=2.0), noise_var=0.01,
                           capacity=16, device="cpu", dtype=F64)
    gp_g = pt.GPRegression(X, Yg, pt.Matern32(2, variance=1.0,
                                               lengthscale=1.5),
                           noise_var=0.01, capacity=16, device="cpu",
                           dtype=F64)
    side = int(np.ceil(np.sqrt(n_grid)))
    grid = np.asarray(pt.linearly_spaced_combinations(
        [(-3.0, 3.0), (-3.0, 3.0)], side))[:n_grid]
    if safe_last:
        last = int(np.argmin(np.sum(grid ** 2, axis=1)))
        grid = np.concatenate([np.delete(grid, last, axis=0),
                               grid[last:last + 1]])
    return dict(gps=(gp_f, gp_g), kernels=(gp_f.kern, gp_g.kern),
                states=(gp_f.state, gp_g.state), grid=_t(grid),
                fmin=_t([0.2, 0.4]), beta=2.0,
                scaling=_t([np.sqrt(2.0), 1.0]), threshold=_t([0.0, 0.0]))


def context_problem():
    """``tests/test_sharding.py``'s contextual product kernel (K2/K4 on
    the plan route) over 333 rows."""
    import safeopt_torch as pt

    rng = np.random.default_rng(3)
    kern = (pt.RBF(1, variance=2.0, lengthscale=0.8, active_dims=[0])
            * pt.Matern32(1, variance=1.0, lengthscale=1.3,
                          active_dims=[1]))
    X = np.hstack([rng.uniform(-1.0, 1.0, size=(5, 1)), np.zeros((5, 1))])
    Y = 1.5 - 0.3 * X[:, :1] ** 2
    gp = pt.GPRegression(X, Y, kern, noise_var=0.01, capacity=16,
                         device="cpu", dtype=F64)
    xs = np.linspace(-3.0, 3.0, 333)[:, None]
    return dict(kernels=(kern,), states=(gp.state,),
                grid=_t(np.hstack([xs, np.zeros_like(xs)])),
                fmin=_t([0.5]), beta=2.0, scaling=_t([np.sqrt(2.0)]),
                threshold=_t([0.0]))


def _mesh(shape):
    from safeopt_torch.parallel import make_hier_mesh, make_mesh

    if len(shape) == 2:
        return make_mesh(model_parallel=shape[1], device_type="cpu")
    return make_hier_mesh(shape[0], model_parallel=shape[2],
                          device_type="cpu")


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _compare_step(ref, res, n, what: str):
    """The sharded result's rows against the unsharded result's: S, M, G,
    next_idx and the counts equal, padding rows neither safe nor
    expanders, Q within 1e-12 (relative to its largest entry): with a
    ``model`` axis the factor's contraction is split over the ranks
    (``sharded_step._split_posterior``), which rounds otherwise."""
    from safeopt_torch.parallel.sharded_step import _Shards

    sh = _Shards(res.Q)
    lo, hi = sh.offset, min(sh.offset + sh.n, n)
    keep = max(hi - lo, 0)
    for name in ("Q", "S", "M", "G"):
        mine = _local(getattr(res, name))[:keep]
        theirs = getattr(ref, name)[lo:hi]
        if name == "Q":
            err = float((mine - theirs).abs().max()) if keep else 0.0
            assert err <= 1e-12 * max(1.0, float(theirs.abs().max())), \
                f"{what}: Q off by {err:.3e}"
        else:
            assert torch.equal(mine, theirs), f"{what}: {name} differs"
    pad = _local(res.S)[keep:]
    assert not bool(pad.any()), f"{what}: a padding row is safe"
    assert not bool(_local(res.G)[keep:].any()), \
        f"{what}: a padding row is an expander"
    assert int(res.next_idx) == int(ref.next_idx), \
        f"{what}: next_idx {int(res.next_idx)} != {int(ref.next_idx)}"
    for name in ("safe_count", "maximizer_count", "expander_found",
                 "has_safe"):
        assert int(getattr(res, name)) == int(getattr(ref, name)), \
            f"{what}: {name} differs"


def _step_case(shape, prob=problem, chunk=16, **kw):
    """The sharded step over a mesh of ``shape`` against the unsharded
    step: S, M, G, next_idx and the counts equal, Q bitwise at model 1
    (else within 1e-12)."""
    def case(out_dir):
        from safeopt_torch.algorithms.safe_opt_core import safeopt_step
        from safeopt_torch.parallel import (replicate, shard_grid,
                                            shard_state)

        a = prob()
        args = (a["fmin"], a["beta"], a["scaling"], a["threshold"])
        ref = safeopt_step(a["kernels"], a["states"], a["grid"], *args,
                           chunk=chunk, **kw)
        mesh = _mesh(shape)
        grid, pad = shard_grid(a["grid"], mesh)
        assert pad > 0, "the case must pad"
        states = tuple(shard_state(s, mesh) for s in a["states"])
        n = a["grid"].shape[0]
        res = safeopt_step(replicate(a["kernels"], mesh), states, grid,
                           *replicate(args, mesh), num_valid=n, chunk=chunk,
                           **kw)
        _compare_step(ref, res, n, f"{shape} {kw}")
        return ref.walk_chunks
    return case


def _full_sets_case(shape):
    def case(out_dir):
        from safeopt_torch.algorithms.safe_opt_core import full_expander_sets
        from safeopt_torch.parallel import shard_grid, shard_state

        a = problem()
        ref = full_expander_sets(a["kernels"], a["states"], a["grid"],
                                 a["fmin"], a["beta"], a["scaling"],
                                 chunk=16)
        assert int(ref.G.sum()) >= 1
        mesh = _mesh(shape)
        grid, _ = shard_grid(a["grid"], mesh)
        n = a["grid"].shape[0]
        res = full_expander_sets(
            a["kernels"], tuple(shard_state(s, mesh) for s in a["states"]),
            grid, a["fmin"], a["beta"], a["scaling"], num_valid=n,
            chunk=16)
        _compare_step(ref, res, n, f"full sets {shape}")
    return case


def _safe_maximum_case(shape):
    def case(out_dir):
        from safeopt_torch.algorithms.safe_opt_core import safe_maximum
        from safeopt_torch.parallel import shard_grid, shard_state

        a = problem()
        ref = safe_maximum(a["kernels"], a["states"], a["grid"], a["fmin"],
                           a["beta"])
        mesh = _mesh(shape)
        grid, _ = shard_grid(a["grid"], mesh)
        res = safe_maximum(
            a["kernels"], tuple(shard_state(s, mesh) for s in a["states"]),
            grid, a["fmin"], a["beta"], a["grid"].shape[0])
        assert int(res[0]) == int(ref[0]), "safe_maximum index differs"
        assert bool(res[2]) == bool(ref[2])
        assert abs(float(res[1]) - float(ref[1])) <= 1e-12
    return case


def _tie_case():
    """Ties across shard edges: every 7th row of a 333-row key holds 1,
    the rest 0, so most keys tie; each shard offers its rows in its own
    visit order (``_visit_order``), and ``merge_order`` over the gathered
    offers must give the one-device visit order, the larger global index
    first on each tie."""
    def case(out_dir):
        from safeopt_torch.algorithms.safe_opt_core import _visit_order
        from safeopt_torch.parallel import shard_grid
        from safeopt_torch.parallel.sharded_step import _Shards, merge_order

        N = 333
        key = torch.zeros(N, dtype=F64)
        key[::7] = 1.0
        g, pad = shard_grid(torch.arange(N, dtype=F64)[:, None],
                            _mesh((4, 1)))
        sh = _Shards(g)
        at = sh.offset + torch.arange(sh.n)
        local = torch.where(at < N, torch.cat([key, key.new_full(
            (pad,), float("-inf"))])[at], float("-inf"))
        order = _visit_order(local, sh.n)
        offers = sh.gather(torch.stack([local[order],
                                        (sh.offset + order).to(F64)], 1))
        merged = offers[merge_order(offers[:, 0], offers[:, 1]), 1]
        assert torch.equal(merged[:N].to(torch.int64),
                           _visit_order(key, N)), \
            "merged order differs from the global visit order"
    return case


def _fleet_case(shape, axis, K, shifted=False):
    """A fleet split over ``mesh[axis]`` against each campaign's solo
    ``run_safeopt_loop``: next_idx, queries and observations bitwise, the
    grown factors within 1e-10 (``gp_append`` under vmap). ``shifted``:
    campaign k's objective is centred at its own point, passed as a NumPy
    ``objective_args_batch`` that the fleet slices per rank."""
    def case(out_dir):
        import safeopt_torch as pt
        from safeopt_torch.algorithms.runner import run_safeopt_loop
        from safeopt_torch.parallel import (run_safeopt_campaigns,
                                            shard_campaigns,
                                            stack_campaign_states)

        def objective(x, c=None):
            x = x if c is None else x - c
            return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

        centers = np.linspace(-0.5, 0.5, K)[:, None] * np.ones((1, 2))
        args = centers if shifted else None

        per = []
        for seed in range(K):
            rng = np.random.default_rng(seed)
            x0 = rng.uniform(-0.3, 0.3, size=(1, 2))
            y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
            gp = pt.GPRegression(x0, np.array([[y0]]),
                                 pt.RBF(2, variance=2.0, lengthscale=1.2),
                                 noise_var=1e-4, capacity=16, device="cpu",
                                 dtype=F64)
            per.append((gp.factor_state(),))
        kern = pt.RBF(2, variance=2.0, lengthscale=1.2)
        grid = _t(pt.linearly_spaced_combinations([(-2.0, 2.0),
                                                   (-2.0, 2.0)], 17))
        consts = (_t([0.5]), 2.0, _t([np.sqrt(2.0)]), _t([0.0]))
        noise = torch.randn((K, 3, 1), generator=torch.Generator()
                            .manual_seed(5), dtype=F64)
        mesh = _mesh(shape)
        fleet = run_safeopt_campaigns(
            (kern,), shard_campaigns(stack_campaign_states(per), mesh, axis),
            grid, *consts, torch.Generator().manual_seed(5),
            objectives=(objective,), n_iter=3, mesh=mesh, axis=axis,
            noise_std=0.01, chunk=16, objective_args_batch=args)
        full = fleet.next_idx.full_tensor()
        assert full.shape == (K, 3)
        assert bool(fleet.has_safe.full_tensor().all())
        for k in range(K):
            solo = run_safeopt_loop(
                (kern,), per[k], grid, *consts, noise[k],
                objectives=(objective,), n_iter=3, noise_std=0.01, chunk=16,
                objective_args=None if args is None else _t(args[k]))
            assert torch.equal(full[k], solo.next_idx), f"campaign {k}"
            assert torch.equal(fleet.xs.full_tensor()[k], solo.xs)
            assert torch.equal(fleet.ys.full_tensor()[k], solo.ys)
            assert torch.equal(fleet.safe_counts.full_tensor()[k],
                               solo.safe_counts)
            assert torch.equal(fleet.walk_chunks.full_tensor()[k],
                               solo.walk_chunks)
            Linv = fleet.states[0].Linv.full_tensor()[k]
            assert float((Linv - solo.states[0].Linv).abs().max()) <= 1e-10
    return case


# the certified cases' band and triage budget: the band holds rows on
# both sides of each threshold (tests/test_torch_sharding.py's)
BAND, K = 0.05, 32
# 'high' with the refinement: REFINED's budget (refine_band_k +
# refine_k = 64) holds the band of rows within REFINE_BAND of a decision
# boundary; FULL's band holds every row, past the budget, so the step
# takes the full float32 pass
REFINED = dict(interval_precision="high", refine_k=16, refine_band_k=48,
               refine_band=0.05)
FULL = dict(REFINED, refine_band=10.0)
# REFINED with a budget of 200 rows, more than any shard of the three
# meshes holds (84 or 167): each rank recomputes at most its own rows
WIDE = dict(REFINED, refine_band_k=184)


class _Certified:
    """One certified case's problem on one mesh: the rank's unsharded
    arguments on the grid padded as ``shard_grid`` pads it (``plain``)
    and the sharded ones (``sharded``), both with ``num_valid``, and the
    rank's view of its rows (``sh``)."""

    def __init__(self, shape, prob=problem, grid=None):
        from safeopt_torch.parallel import replicate, shard_grid, shard_state
        from safeopt_torch.parallel.sharded_step import _Shards

        self.a = a = prob()
        if grid is not None:
            a["grid"] = grid
        self.n = a["grid"].shape[0]
        mesh = _mesh(shape)
        self.sgrid = shard_grid(a["grid"], mesh)[0]
        self.sh = _Shards(self.sgrid)
        self.grid = self.sgrid.full_tensor()
        self.consts = (a["fmin"], a["beta"], a["scaling"], a["threshold"])
        self.sconsts = replicate(self.consts, mesh)
        self.states = tuple(shard_state(s, mesh) for s in a["states"])

    def rows(self, full, local, what):
        """The rank's rows of ``full`` equal ``local`` bit for bit."""
        sh = self.sh
        assert torch.equal(_local(local), full[sh.offset:sh.offset + sh.n]), \
            f"{what} differs from the unsharded rows"

    def step(self, ref, res, what):
        """A sharded ``StepResult`` against the unsharded one: Q, S, M, G
        rows, next_idx, diag and the walk bit for bit."""
        for name in ("Q", "S", "M", "G"):
            self.rows(getattr(ref, name), getattr(res, name),
                      f"{what}: {name}")
        assert not bool(_local(res.S)[self.n - self.sh.offset:].any()), \
            f"{what}: a padding row is safe"
        for name in ("next_idx", "diag"):
            assert torch.equal(getattr(res, name), getattr(ref, name)), \
                f"{what}: {name} differs"
        assert res.walk_chunks == ref.walk_chunks, f"{what}: walk differs"


def _syncs(fn):
    """``(fn(), the host syncs it counted)``."""
    from safeopt_torch.utils.observability import host_syncs

    before = host_syncs.count
    out = fn()
    return out, host_syncs.count - before


def _certified_case(shape, prob=problem, branch=None, past_shard=False,
                    **kw):
    """``certified_scan`` over a mesh of ``shape`` against the unsharded
    call: the step and ``packed`` bit for bit, no more host syncs;
    ``branch`` ('refined' or 'full') names the refinement's branch the
    case must take; ``past_shard``, that its budget exceeds the rank's
    rows."""
    def case(out_dir):
        from safeopt_torch.algorithms.safe_opt_core import certified_scan

        c = _Certified(shape, prob)
        a = c.a
        fmin, beta, scaling, threshold = c.consts
        (ref, packed), n_ref = _syncs(lambda: certified_scan(
            a["kernels"], a["states"], c.grid, fmin, beta, scaling,
            threshold, BAND, None, c.n, k=K, chunk=16, **kw))
        (res, spacked), n_res = _syncs(lambda: certified_scan(
            a["kernels"], c.states, c.sgrid, *c.sconsts, BAND, None, c.n,
            k=K, chunk=16, **kw))
        what = f"certified_scan {shape} {kw}"
        c.step(ref, res, what)
        assert torch.equal(spacked, packed), f"{what}: packed differs"
        assert n_res <= n_ref, f"{what}: {n_res} host syncs > {n_ref}"
        if branch is not None:
            budget = kw["refine_k"] + kw["refine_band_k"]
            assert budget > c.sh.n or not past_shard, \
                f"{what}: budget {budget} within the rank's {c.sh.n} rows"
            assert (int(packed[6]) <= budget) == (branch == "refined"), \
                f"{what}: refine population {int(packed[6])}, budget {budget}"
    return case


def _device_oracle_case(shape, **kw):
    """``interval_scan`` -> ``device_oracle`` (on the float64 grid sharded
    alike) -> ``certified_finish`` against the unsharded calls: Q,
    ``packed_t``, the oracle's four tensors, the step and ``diag9`` bit
    for bit."""
    def case(out_dir):
        from safeopt_torch.algorithms import safe_opt_core as core

        c = _Certified(shape)
        a = c.a
        fmin, beta, scaling, threshold = c.consts
        ostates = tuple(g.device_oracle_state()[0] for g in a["gps"])
        Q, packed_t = core.interval_scan(a["kernels"], a["states"], c.grid,
                                         fmin, beta, scaling, BAND, c.n, k=K,
                                         **kw)
        sQ, spacked_t = core.interval_scan(a["kernels"], c.states, c.sgrid,
                                           fmin, beta, scaling, BAND, c.n,
                                           k=K, **kw)
        what = f"device oracle {shape} {kw}"
        c.rows(Q, sQ, f"{what}: Q")
        assert torch.equal(spacked_t, packed_t), f"{what}: packed_t differs"
        okw = dict(constrained=(True, True), k=K)
        fix = core.device_oracle(a["kernels"], ostates, c.grid, Q, packed_t,
                                 fmin, beta, **okw)
        sfix = core.device_oracle(a["kernels"], ostates, c.sgrid, sQ,
                                  spacked_t, fmin, beta, **okw)
        for name, x, y in zip(("fix_idx", "fix_bits", "flips", "n_within"),
                              fix, sfix):
            assert torch.equal(x, y), f"{what}: {name} differs"
        assert int(fix[3]) > 0, f"{what}: no band row"
        ref, diag9 = core.certified_finish(
            a["kernels"], a["states"], c.grid, Q, packed_t, *fix, fmin, beta,
            scaling, threshold, None, c.n, chunk=16)
        res, sdiag9 = core.certified_finish(
            a["kernels"], c.states, c.sgrid, sQ, spacked_t, *sfix,
            *c.sconsts, None, c.n, chunk=16)
        c.step(ref, res, what)
        assert torch.equal(sdiag9, diag9), f"{what}: diag9 differs"
    return case


def _boundary_case(shape):
    """``boundary_scan`` against the unsharded call: Q's rows, ``idx``,
    ``within`` and ``total_within`` bit for bit."""
    def case(out_dir):
        from safeopt_torch.algorithms.safe_opt_core import boundary_scan

        c = _Certified(shape)
        a = c.a
        fmin, beta, scaling, _ = c.consts
        ref = boundary_scan(a["kernels"], a["states"], c.grid, fmin, beta,
                            scaling, BAND, c.n, k=K)
        res = boundary_scan(a["kernels"], c.states, c.sgrid, *c.sconsts[:3],
                            BAND, c.n, k=K)
        c.rows(ref[0], res[0], f"boundary_scan {shape}: Q")
        for name, x, y in zip(("idx", "within", "total_within"), ref[1:],
                              res[1:]):
            assert torch.equal(x, y), f"boundary_scan {shape}: {name}"
        assert int(ref[3]) > 0
    return case


def _from_Q_case(shape):
    """``safeopt_step_from_Q`` with certified bits on rows of every shard
    (each the inverse of its strict verdict) and on the first padding
    row (set, and it stays unsafe) against the unsharded call."""
    def case(out_dir):
        from safeopt_torch.algorithms import safe_opt_core as core

        c = _Certified(shape)
        a = c.a
        fmin, beta, scaling, threshold = c.consts
        Q = core.boundary_scan(a["kernels"], a["states"], c.grid, fmin, beta,
                               scaling, BAND, c.n, k=K)[0]
        sQ = core.boundary_scan(a["kernels"], c.states, c.sgrid,
                                *c.sconsts[:3], BAND, c.n, k=K)[0]
        rows = [5, 100, 200, 300]
        S = torch.all(Q[:, 0::2] > fmin, dim=1)
        fix_idx = torch.tensor(rows + [c.n, -1], dtype=torch.int32)
        fix_bits = torch.cat([~S[rows], torch.tensor([True, True])])
        ref = core.safeopt_step_from_Q(
            a["kernels"], a["states"], c.grid, Q, fix_idx, fix_bits, fmin,
            beta, scaling, threshold, None, c.n, chunk=16)
        res = core.safeopt_step_from_Q(
            a["kernels"], c.states, c.sgrid, sQ, fix_idx, fix_bits,
            *c.sconsts, None, c.n, chunk=16)
        c.step(ref, res, f"safeopt_step_from_Q {shape}")
        assert torch.equal(ref.S[rows], ~S[rows]) and not bool(ref.S[c.n])
        owners = {r // c.sh.n for r in rows}
        assert len(owners) == c.sh.count, "the fixes miss a shard"
    return case


def _triage_tie_case(shape):
    """A triage tie across a shard edge: the row nearest a threshold is
    copied into two rows of its own shard and into one of another shard
    (an earlier one where there is one), so that four valid rows share
    one margin; the top 2 of ``certified_scan``'s triage (k = 2, so that
    a shard's offer takes two of its three tied rows) are the two smaller
    indices in order, sharded as unsharded (``top_k``'s rule, which
    each shard's ``top_k`` and ``merge_top`` keep)."""
    def case(out_dir):
        from safeopt_torch.algorithms import safe_opt_core as core

        a = problem()
        grid = a["grid"].clone()
        r = int(core.boundary_scan(a["kernels"], a["states"], grid,
                                   a["fmin"], a["beta"], a["scaling"], BAND,
                                   k=1)[1][0])
        n = -(-grid.shape[0] // int(np.prod(shape[:-1])))   # rows a shard
        same = [j for j in (r - 2, r - 1, r + 1, r + 2)
                if 0 <= j < grid.shape[0] and j // n == r // n][:2]
        other = r - n if r >= n else r + n
        grid[same] = grid[other] = grid[r].clone()
        c = _Certified(shape, grid=grid)
        what = f"triage tie {shape}"
        ref, packed = core.certified_scan(
            a["kernels"], a["states"], c.grid, *c.consts, BAND, None, c.n,
            k=2, chunk=16)
        res, spacked = core.certified_scan(
            a["kernels"], c.states, c.sgrid, *c.sconsts, BAND, None, c.n,
            k=2, chunk=16)
        c.step(ref, res, what)
        assert torch.equal(spacked, packed), f"{what}: packed differs"
        want = sorted([r, other] + same)[:2]
        assert packed[7:9].tolist() == want, \
            f"{what}: {packed[7:9].tolist()}, not {want}"
    return case


def _anchor_case():
    """``certified_scan`` and ``interval_scan`` (plain float64 path) on a
    (4, 1) mesh over ``problem(safe_last=True)``'s grid: rank 0 writes
    the gathered Q, S, M, G, next_idx, packed, the interval scan's Q and
    packed_t to ``out_dir/certified_anchor.npz``, which
    ``tests/test_torch_sharding.py`` holds against safeopt_tpu."""
    def case(out_dir):
        import torch.distributed as dist
        from safeopt_torch.algorithms import safe_opt_core as core

        c = _Certified((4, 1), lambda: problem(safe_last=True))
        a = c.a
        res, packed = core.certified_scan(
            a["kernels"], c.states, c.sgrid, *c.sconsts, BAND, None, c.n,
            k=K, chunk=16)
        Qt, packed_t = core.interval_scan(
            a["kernels"], c.states, c.sgrid, *c.sconsts[:3], BAND, c.n, k=K)
        out = {name: getattr(res, name).full_tensor()
               for name in ("Q", "S", "M", "G")}
        out.update(next_idx=res.next_idx, packed=packed,
                   Q_t=Qt.full_tensor(), packed_t=packed_t)
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "certified_anchor.npz"),
                     **{k: v.numpy() for k, v in out.items()})
    return case


def _swarm_fleet_case(shape, axis, K):
    """A SafeOptSwarm fleet split over ``mesh[axis]``, its uniforms and
    noise from generators drawn whole, against the fleet on one device
    from the same generators: queries and best lower bounds to 1e-12
    (each rank runs a smaller batch under vmap), safe-set counts equal,
    no campaign losing its safe set."""
    def case(out_dir):
        import safeopt_torch as pt
        from safeopt_torch.algorithms.swarm_opt_fused import SwarmIterState
        from safeopt_torch.parallel import (run_swarmopt_campaigns,
                                            stack_campaign_states)

        def objective(x):
            return 2.0 * torch.exp(-0.5 * torch.sum(x * x))

        per, iters = [], []
        for k in range(K):
            x0 = np.random.default_rng(k).uniform(-0.3, 0.3, size=(1, 2))
            gp = pt.GPRegression(x0, np.array([[float(objective(
                _t(x0[0])))]]), pt.RBF(2, variance=2.0, lengthscale=1.2),
                noise_var=1e-4, capacity=16, device="cpu", dtype=F64)
            per.append((gp.factor_state(),))
            S = torch.zeros((64, 2), dtype=F64)
            S[0] = _t(x0[0])
            iters.append(SwarmIterState(S=S, count=torch.tensor(1),
                                        greedy=_t(x0[0])))
        args = ((gp.kern,), stack_campaign_states(per),
                stack_campaign_states(iters), [0.3, 0.3],
                [[-3.0, 3.0], [-3.0, 3.0]], [0.0], [np.sqrt(2.0)], [0.0],
                np.full(3, 2.0), torch.stack([it.greedy for it in iters]),
                _t([-np.inf] * K))

        def run(mesh):
            return run_swarmopt_campaigns(
                *args, torch.Generator().manual_seed(11),
                torch.Generator().manual_seed(12), objectives=(objective,),
                n_iter=3, swarm_size=6, max_iters=5, noise_std=0.01,
                mesh=mesh, axis=axis)

        whole = run(None)
        fleet = run(_mesh(shape))
        xs = fleet.xs.full_tensor()
        assert xs.shape == whole.xs.shape
        assert float((xs - whole.xs).abs().max()) <= 1e-12
        assert float((fleet.best_lower_bounds.full_tensor()
                      - whole.best_lower_bounds).abs().max()) <= 1e-12
        assert torch.equal(fleet.safe_counts.full_tensor(),
                           whole.safe_counts)
        assert bool((fleet.num_safe_min.full_tensor() > 0).all())
    return case


CASES = {
    "data4": _step_case((4, 1)),
    "data4_ucb": _step_case((4, 1), ucb=True),
    "data4_lipschitz": _step_case((4, 1), lipschitz=_t([1.5, 1.5]),
                                  use_lipschitz=True),
    "data4_330": _step_case((4, 1), prob=lambda: problem(330)),
    "data4_safe_padding": _step_case(
        (4, 1), prob=lambda: problem(safe_last=True)),
    "data4_chunk1": _step_case((4, 1), chunk=1),
    "data4_context": _step_case((4, 1), prob=context_problem),
    "data4_full_sets": _full_sets_case((4, 1)),
    "data4_safe_maximum": _safe_maximum_case((4, 1)),
    "data4_ties": _tie_case(),
    "model2": _step_case((2, 2)),
    "model2_ucb": _step_case((2, 2), ucb=True),
    "model2_lipschitz": _step_case((2, 2), lipschitz=_t([1.5, 1.5]),
                                   use_lipschitz=True),
    "model2_full_sets": _full_sets_case((2, 2)),
    "model2_safe_maximum": _safe_maximum_case((2, 2)),
    "model2_safe_padding": _step_case(
        (2, 2), prob=lambda: problem(safe_last=True)),
    "hier2": _step_case((2, 2, 1)),
    "hier2_model2": _step_case((2, 1, 2)),
    "fleet_data": _fleet_case((4, 1), "data", 4),
    "fleet_dcn": _fleet_case((2, 2, 1), "dcn", 2),
    "fleet_data_shifted": _fleet_case((4, 1), "data", 4, shifted=True),
    "swarm_fleet_data": _swarm_fleet_case((4, 1), "data", 4),
    # the certified path over the three meshes
    **{f"{tag}_{name}": make(shape)
       for tag, shape in (("data4", (4, 1)), ("model2", (2, 2)),
                          ("hier2", (2, 2, 1)))
       for name, make in (
           ("certified", _certified_case),
           ("certified_refined", lambda s: _certified_case(
               s, branch="refined", **REFINED)),
           ("certified_full", lambda s: _certified_case(
               s, branch="full", **FULL)),
           ("certified_refined_wide", lambda s: _certified_case(
               s, branch="refined", past_shard=True, **WIDE)),
           ("device_oracle", lambda s: _device_oracle_case(s, **REFINED)),
           ("boundary", _boundary_case),
           ("from_Q", _from_Q_case),
           ("triage_tie", _triage_tie_case),
           ("certified_context", lambda s: _certified_case(
               s, context_problem, branch="refined",
               **dict(REFINED, refine_band_k=96))))},
    "certified_anchor": _anchor_case(),
    # two processes as two hosts (tools_torch/mp_dryrun.py)
    "dryrun_hier": _step_case((2, 1, 1)),
    "dryrun_fleet_dcn": _fleet_case((2, 1, 1), "dcn", 2),
}


def _worker(rank, world, port, cases, out_dir, verbose):
    """One rank: the cases in order, each given the world's ``out_dir``;
    the errors written to ``out_dir/rank<rank>.json``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    results = {}
    try:
        for name in cases:
            try:
                CASES[name](out_dir)
                results[name] = None
                if verbose:
                    print(f"rank {rank}: {name} OK", flush=True)
            except Exception:                 # recorded, then the next case
                results[name] = traceback.format_exc()
                if verbose:
                    print(f"rank {rank}: {name} FAILED\n{results[name]}",
                          flush=True)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world: int, cases, verbose: bool = False, out_dir=None):
    """Run ``cases`` in a fresh ``world``-rank gloo world; ``{case: [error
    text or None per rank]}``. The cases' files stay in ``out_dir`` when
    it is given (else a temporary directory holds them)."""
    import torch.multiprocessing as mp

    if out_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_world(world, cases, verbose, tmp)
    mp.start_processes(_worker, args=(world, free_port(), list(cases),
                                      str(out_dir), verbose),
                       nprocs=world, start_method="spawn")
    per_rank = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            per_rank.append(json.load(f))
    return {c: [p.get(c, "not run") for p in per_rank] for c in cases}


def main():
    """Run the named cases (default all but the dryrun's) verbosely."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("cases", nargs="*")
    a = ap.parse_args()
    cases = a.cases or [c for c in CASES if not c.startswith("dryrun")]
    out = run_world(a.world, cases, verbose=True)
    bad = {c: e for c, e in out.items() if any(e)}
    print(json.dumps({"cases": len(out), "failed": sorted(bad)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

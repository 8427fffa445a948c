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
``tests/test_campaigns.py``; ``tests/test_torch_sharding.py`` and
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
    return dict(kernels=(gp_f.kern, gp_g.kern),
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
    expanders, Q within 1e-12 (relative to its largest entry). Q is not
    held bit for bit even on a ``model`` axis of 1: the plain versions'
    CPU products (``lm @ gram``) round differently at different column
    counts, by up to 2.2e-15 on these problems."""
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
    def case():
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
    def case():
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
    def case():
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
    def case():
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
    def case():
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


def _certified_refused_case():
    """The certified functions refuse a ``DTensor`` grid, naming the
    roadmap item that takes them."""
    def case():
        from safeopt_torch.algorithms import safe_opt_core as core
        from safeopt_torch.parallel import shard_grid

        a = problem()
        grid, _ = shard_grid(a["grid"], _mesh((4, 1)))
        head = (a["kernels"], a["states"], grid, a["fmin"], a["beta"],
                a["scaling"])
        for call in (lambda: core.boundary_scan(*head, 1e-3),
                     lambda: core.interval_scan(*head, 1e-3),
                     lambda: core.certified_scan(*head, a["threshold"],
                                                 1e-3)):
            try:
                call()
            except NotImplementedError as e:
                assert "[16c]" in str(e), str(e)
            else:
                raise AssertionError("a certified function took a "
                                     "sharded grid")
    return case


def _swarm_fleet_case(shape, axis, K):
    """A SafeOptSwarm fleet split over ``mesh[axis]``, its uniforms and
    noise from generators drawn whole, against the fleet on one device
    from the same generators: queries and best lower bounds to 1e-12
    (each rank runs a smaller batch under vmap), safe-set counts equal,
    no campaign losing its safe set."""
    def case():
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
    "data4_certified_refused": _certified_refused_case(),
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
    # two processes as two hosts (tools_torch/mp_dryrun.py)
    "dryrun_hier": _step_case((2, 1, 1)),
    "dryrun_fleet_dcn": _fleet_case((2, 1, 1), "dcn", 2),
}


def _worker(rank, world, port, cases, out_dir, verbose):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    results = {}
    try:
        for name in cases:
            try:
                CASES[name]()
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


def run_world(world: int, cases, verbose: bool = False):
    """Run ``cases`` in a fresh ``world``-rank gloo world; ``{case: [error
    text or None per rank]}``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_worker, args=(world, free_port(), list(cases),
                                          out_dir, verbose),
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

"""The port's padding mask and sharded step against safeopt_tpu and
against its own unsharded step, float64 on the CPU.

One device: ``num_valid`` through ``safeopt_step`` (plain, ucb,
Lipschitz), ``safe_maximum``, ``full_expander_sets``, ``boundary_scan``,
``certified_scan`` and ``interval_scan`` on a padded grid, against
safeopt_tpu's with the same ``num_valid`` (``use_pallas=False``, its
plain path), and ``num_valid=None`` or the full count giving the
unpadded step's bits. ``pad_rows`` against ``safeopt_tpu.parallel
.shard_grid`` on the 8-device virtual mesh, and the mesh shapes' checks
against ``make_mesh``/``make_hier_mesh``.

Several ranks: the cases of ``tools_torch/sharding_checks.py`` in one
spawned 4-rank gloo world (meshes (4, 1), (2, 2), (2, 2, 1), (2, 1, 2);
the 333-row grid of ``tests/test_sharding.py``, so that padding and ties
cross shard edges): the sharded step's S, M, G, counts and ``next_idx``
equal the unsharded step's, Q within 1e-12; ucb, Lipschitz, full sets,
``safe_maximum``, the contextual kernel, a walk of one candidate a
chunk, padding that repeats a safe row; the global visit order under
ties; fleets over ``data`` and over ``dcn`` (one with a NumPy
``objective_args_batch``) equal their solo runs, a swarm fleet over
``data`` the fleet on one device. The certified functions on a
``DTensor`` grid, on (4, 1), (2, 2) and (2, 2, 1): ``certified_scan``
(plain, and at ``'high'`` with the refinement within its budget, with
a budget larger than a rank's rows, and past the budget), ``interval_scan`` -> ``device_oracle`` -> ``certified_finish``,
``boundary_scan``, ``safeopt_step_from_Q`` with certified bits on every
shard and on a padding row, a triage tie across a shard edge and the
contextual kernel's certified scan, each bit for bit the unsharded call
on the same padded grid; and the gathered results of ``certified_scan``
and ``interval_scan`` on (4, 1) against safeopt_tpu's on its virtual
4-device mesh. Then ``tools_torch/mp_dryrun.py``'s two processes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import safeopt_torch as pt
import safeopt_tpu as jt
from safeopt_torch.algorithms import safe_opt_core as pcore
from safeopt_torch.parallel import make_mesh
from safeopt_torch.parallel.sharding import mesh_shape, pad_rows
from safeopt_tpu.algorithms import safe_opt_core as jcore
from tools_torch import sharding_checks

N, PAD = 333, 3


def _problems():
    """The port's and safeopt_tpu's GPs of ``sharding_checks.problem``,
    its grid with a safe row last, and that grid with 3 copies of the
    last row appended."""
    rng = np.random.default_rng(3)
    X = rng.uniform(-1.0, 1.0, size=(6, 2))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    Yg = (1.0 - 0.2 * np.sum(X ** 2, axis=1))[:, None]
    out = {}
    for pkg, kw in ((pt, {"device": "cpu"}), (jt, {})):
        gp_f = pkg.GPRegression(X, Yf, pkg.RBF(2, variance=2.0),
                                noise_var=0.01, capacity=16, **kw)
        gp_g = pkg.GPRegression(X, Yg, pkg.Matern32(2, variance=1.0,
                                                    lengthscale=1.5),
                                noise_var=0.01, capacity=16, **kw)
        out[pkg] = ((gp_f.kern, gp_g.kern), (gp_f.state, gp_g.state))
    grid = np.asarray(jt.linearly_spaced_combinations(
        [(-3.0, 3.0), (-3.0, 3.0)], 19))[:N]
    # the row nearest the data moves to the end, so that the padding rows
    # repeat a safe row and the mask decides them
    last = int(np.argmin(np.sum(grid ** 2, axis=1)))
    grid = np.concatenate([np.delete(grid, last, axis=0),
                           grid[last:last + 1]])
    padded = np.concatenate([grid, np.repeat(grid[-1:], PAD, axis=0)])
    return out, grid, padded


PROBS, GRID, PADDED = _problems()
CONSTS = ([0.2, 0.4], 2.0, [np.sqrt(2.0), 1.0], [0.0, 0.0])


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _port(fn, grid, *args, **kw):
    kernels, states = PROBS[pt]
    return fn(kernels, states, _t(grid), *args, **kw)


def _jax(fn, grid, *args, **kw):
    kernels, states = PROBS[jt]
    return fn(kernels, states, jnp.asarray(grid), *args, **kw)


def _consts(conv):
    fmin, beta, scaling, threshold = CONSTS
    return conv(fmin), beta, conv(scaling), conv(threshold)


STEP_VARIANTS = {
    "plain": {},
    "ucb": {"ucb": True},
    "lipschitz": {"use_lipschitz": True, "lipschitz": [1.5, 1.5]},
}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_padded_step_matches_safeopt_tpu(variant):
    """``safeopt_step`` on the padded grid with ``num_valid``: the port's
    S, M, G and next_idx are safeopt_tpu's, Q to 1e-12, and no padding
    row is safe, unsafe-listed, an expander or chosen."""
    kw = dict(STEP_VARIANTS[variant])
    lip = kw.pop("lipschitz", None)
    ours = _port(pcore.safeopt_step, PADDED, *_consts(_t),
                 None if lip is None else _t(lip), N, chunk=16, **kw)
    theirs = _jax(jcore.safeopt_step, PADDED, *_consts(jnp.asarray),
                  None if lip is None else jnp.asarray(lip), N, chunk=16,
                  **kw)
    assert_allclose(ours.Q.numpy(), np.asarray(theirs.Q), rtol=1e-12,
                    atol=1e-13)
    for name in ("S", "M", "G"):
        assert_array_equal(getattr(ours, name).numpy(),
                           np.asarray(getattr(theirs, name)), name)
    assert int(ours.next_idx) == int(theirs.next_idx)
    assert ours.S[N - 1] and not ours.S[N:].any() and not ours.G[N:].any()
    # the padded step decides as the unpadded one on the real rows
    plain = _port(pcore.safeopt_step, GRID, *_consts(_t),
                  None if lip is None else _t(lip), chunk=16, **kw)
    for name in ("S", "M", "G"):
        assert torch.equal(getattr(ours, name)[:N], getattr(plain, name))
    assert int(ours.next_idx) == int(plain.next_idx)


def test_num_valid_none_is_the_unmasked_step():
    """``num_valid=None`` and ``num_valid=N`` on an unpadded grid give the
    same bits (the mask is all True), Q included."""
    a = _port(pcore.safeopt_step, GRID, *_consts(_t), chunk=16)
    b = _port(pcore.safeopt_step, GRID, *_consts(_t), None, N, chunk=16)
    for name in ("Q", "S", "M", "G", "next_idx", "diag"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_padded_safe_maximum_and_full_sets_match_safeopt_tpu():
    fmin, beta, scaling, _ = _consts(_t)
    jfmin, _, jscaling, _ = _consts(jnp.asarray)
    ours = _port(pcore.safe_maximum, PADDED, fmin, beta, N)
    theirs = _jax(jcore.safe_maximum, PADDED, jfmin, beta, N)
    assert int(ours[0]) == int(theirs[0])
    assert abs(float(ours[1]) - float(theirs[1])) <= 1e-12
    assert_array_equal(ours[4].numpy(), np.asarray(theirs[4]))
    ours = _port(pcore.full_expander_sets, PADDED, fmin, beta, scaling,
                 None, N, chunk=16)
    theirs = _jax(jcore.full_expander_sets, PADDED, jfmin, beta, jscaling,
                  None, N, chunk=16)
    for name in ("S", "M", "G"):
        assert_array_equal(getattr(ours, name).numpy(),
                           np.asarray(getattr(theirs, name)), name)
    assert int(ours.G.sum()) >= 1 and not ours.G[N:].any()


def test_padded_certified_functions_match_safeopt_tpu():
    """``boundary_scan``, ``certified_scan`` and ``interval_scan`` with
    ``num_valid``: the padding rows never enter the band, and the triage
    and decisions are safeopt_tpu's (plain float64 path, no refinement).
    The band is wide enough to hold rows on both sides of each
    threshold."""
    fmin, beta, scaling, threshold = _consts(_t)
    jfmin, _, jscaling, jthreshold = _consts(jnp.asarray)
    k, band = 32, 0.05
    ours = _port(pcore.boundary_scan, PADDED, fmin, beta, scaling, band, N,
                 k=k)
    theirs = _jax(jcore.boundary_scan, PADDED, jfmin, beta, jscaling, band,
                  N, k=k)
    assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    assert int(ours[3]) == int(theirs[3]) > 0
    assert (ours[1][ours[2]] < N).all()
    res, packed = _port(pcore.certified_scan, PADDED, fmin, beta, scaling,
                        threshold, band, None, N, k=k, chunk=16)
    jres, jpacked = _jax(jcore.certified_scan, PADDED, jfmin, beta,
                         jscaling, jthreshold, band, None, N, k=k, chunk=16)
    for name in ("S", "M", "G"):
        assert_array_equal(getattr(res, name).numpy(),
                           np.asarray(getattr(jres, name)), name)
    assert_array_equal(packed.numpy(), np.asarray(jpacked))
    Q, packed_t = _port(pcore.interval_scan, PADDED, fmin, beta, scaling,
                        band, N, k=k)
    assert torch.equal(packed_t, packed[5:7 + 2 * k])
    # the padded step from Q with no certified bit is the step itself
    none = torch.full((k,), -1, dtype=torch.int32)
    again = pcore.safeopt_step_from_Q(
        *PROBS[pt], _t(PADDED), Q, none, torch.zeros(k, dtype=torch.bool),
        fmin, beta, scaling, threshold, None, N, chunk=16)
    for name in ("S", "M", "G", "next_idx"):
        assert torch.equal(getattr(again, name), getattr(res, name)), name


def test_a_certified_bit_on_a_padding_row_stays_unsafe():
    fmin, beta, scaling, threshold = _consts(_t)
    Q = _port(pcore.boundary_scan, PADDED, fmin, beta, scaling, 0.05, N)[0]
    fix_idx = torch.tensor([N, N + 2, -1], dtype=torch.int32)
    res = pcore.safeopt_step_from_Q(
        *PROBS[pt], _t(PADDED), Q, fix_idx,
        torch.ones(3, dtype=torch.bool), fmin, beta, scaling, threshold,
        None, N, chunk=16)
    assert not res.S[N:].any()


def test_pad_rows_matches_safeopt_tpu_shard_grid():
    """The port's padding (``shard_grid``'s) equals safeopt_tpu's on the
    8-device virtual mesh: the last row repeated, the same count."""
    from safeopt_tpu.parallel import make_mesh as jax_mesh
    from safeopt_tpu.parallel import shard_grid as jax_shard_grid

    theirs, jpad = jax_shard_grid(GRID, jax_mesh(n_devices=8))
    ours, pad = pad_rows(GRID, 8)
    assert pad == jpad == 3
    assert_array_equal(ours.numpy(), np.asarray(theirs))
    same, none = pad_rows(_t(GRID[:8]), 8)
    assert none == 0 and torch.equal(same, _t(GRID[:8]))


@pytest.mark.parametrize("n,mp,hosts", [
    (7, 2, None), (8, 4, None), (8, 1, None), (8, 2, 2), (8, 1, 3),
    (8, 3, 2), (4, 1, 2)])
def test_mesh_shapes_match_safeopt_tpu(n, mp, hosts):
    """``make_mesh``/``make_hier_mesh``'s shape and ``ValueError``s for n
    ranks are safeopt_tpu's for n devices (axis order dcn, data,
    model)."""
    from safeopt_tpu.parallel import make_hier_mesh as jax_hier
    from safeopt_tpu.parallel import make_mesh as jax_mesh

    def theirs():
        if hosts is None:
            return jax_mesh(n_devices=n, model_parallel=mp)
        return jax_hier(hosts, model_parallel=mp, n_devices=n)

    try:
        want = tuple(theirs().devices.shape)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_shape(n, mp, hosts)
        return
    assert mesh_shape(n, mp, hosts) == want


def test_a_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")


# --- spawned worlds ----------------------------------------------------------

WORLD_CASES = [c for c in sharding_checks.CASES if not c.startswith("dryrun")]


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """The world's output directory (``certified_anchor``'s file)."""
    return tmp_path_factory.mktemp("world")


@pytest.fixture(scope="module")
def world(world_dir):
    """Every case of ``WORLD_CASES`` in one spawned 4-rank gloo world."""
    return sharding_checks.run_world(4, WORLD_CASES, out_dir=world_dir)


@pytest.mark.parametrize("case", WORLD_CASES)
def test_sharded_equals_unsharded(world, case):
    errors = [e for e in world[case] if e]
    assert not errors, f"{case}:\n" + "\n".join(errors)


def test_sharded_certified_matches_safeopt_tpu(world, world_dir):
    """The port's ``certified_scan`` and ``interval_scan`` on a (4, 1)
    mesh (``certified_anchor``, gathered) against safeopt_tpu's on
    ``shard_grid(grid, make_mesh(4))`` of the virtual CPU mesh, its
    plain path (``use_pallas=False``): S, M, G, next_idx, ``packed`` and
    ``packed_t`` equal, Q within 1e-12."""
    from safeopt_tpu.parallel import make_mesh as jax_mesh
    from safeopt_tpu.parallel import shard_grid as jax_shard_grid

    assert not any(world["certified_anchor"])
    ours = np.load(world_dir / "certified_anchor.npz")
    jgrid, pad = jax_shard_grid(GRID, jax_mesh(n_devices=4))
    assert pad == PAD
    band, k = sharding_checks.BAND, sharding_checks.K
    fmin, beta, scaling, threshold = _consts(jnp.asarray)
    kernels, states = PROBS[jt]
    res, packed = jcore.certified_scan(kernels, states, jgrid, fmin, beta,
                                       scaling, threshold, band, None, N,
                                       k=k, chunk=16)
    Q_t, packed_t = jcore.interval_scan(kernels, states, jgrid, fmin, beta,
                                        scaling, band, N, k=k)
    for name in ("S", "M", "G", "next_idx"):
        assert_array_equal(ours[name], np.asarray(getattr(res, name)), name)
    assert_array_equal(ours["packed"], np.asarray(packed))
    assert_array_equal(ours["packed_t"], np.asarray(packed_t))
    assert int(ours["packed"][5]) > 0 and ours["G"].any()
    for mine, theirs in ((ours["Q"], res.Q), (ours["Q_t"], Q_t)):
        assert_allclose(mine, np.asarray(theirs), rtol=0, atol=1e-12)


def test_two_process_dryrun():
    """``tools_torch/mp_dryrun.py``: two processes as two hosts of a
    (dcn, data, model) mesh; both checks pass in both."""
    from tools_torch.mp_dryrun import run_two_process

    out = run_two_process()
    assert set(out) == {"dryrun_hier", "dryrun_fleet_dcn"}
    for name, errors in out.items():
        assert errors == [None, None], f"{name}: {errors}"

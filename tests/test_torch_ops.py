"""The plain versions of K1-K4 and the exact top-k against the JAX ops.

The JAX kernels run as the JAX package's own tests run them on the CPU
(Pallas interpret mode, float64). Both packages hold the identical host
factor (``safeopt_torch.convert``). K1's and K2's intervals must agree
to atol 1e-10 (difference-form grams in both; only summation order
differs), K3's and K4's predicates must be identical, and ``top_k``
must equal ``lax.top_k`` exactly, ties included. On CPU tensors the
wrappers run the plain versions and never count a kernel launch. The
CUDA K1/K2 stop at each GP's count: the operands carry the JAX state's
count, the factor is exactly zero past it, and interval rows summed in
index order over the leading block equal those over the capacity
bitwise (the plain version's BLAS sums only to 1e-12), at capacities
that are and are not multiples of the kernels' 32-row bands. The CUDA
K3/K4 stop there too: their ``scal`` carries the count, M2 is exactly
zero past it, and the plain predicate over the leading rows is the one
over the capacity. The three-pass plain versions of K1-3p/K2-3p agree
with the JAX kernels at ``three_pass=True`` to atol 1e-10 in float64,
and in float32 cut the limbs of the kernel's own gram; a 9-leaf plan and
a 65-column grid decide on the CPU as the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import safeopt_tpu as jt
import torch
from safeopt_torch.convert import (gp_arrays, gp_from_arrays,
                                   kernel_from_params, kernel_params)
from safeopt_torch.ops import fused_expander as pfe
from safeopt_torch.ops import fused_posterior as pfp
from safeopt_torch.ops.topk import top_k
from safeopt_tpu.ops import fused_expander as jfe
from safeopt_tpu.ops import fused_posterior as jfp


def _models(family, n_gps, cap, seed, d=2, n_obs=11):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_obs, d))
    jgps = []
    for g in range(n_gps):
        Y = (1.0 - 0.2 * g + np.cos(X.sum(axis=1))
             + 0.05 * rng.normal(size=n_obs))[:, None]
        kern = getattr(jt, family)(d, variance=1.0 + 0.5 * g,
                                   lengthscale=[0.8 + 0.3 * g, 1.3][:d],
                                   ARD=True)
        jgps.append(jt.GPRegression(X, Y, kern, noise_var=0.01,
                                    capacity=cap))
    pgps = [gp_from_arrays(kernel_from_params(**kernel_params(g.kern)),
                           **gp_arrays(g), device="cpu") for g in jgps]
    grid = rng.uniform(-3.0, 3.0, size=(1000, d))
    return jgps, pgps, grid


CASES = [("RBF", 2, 64), ("Matern32", 2, 16), ("Matern52", 1, 16),
         ("Exponential", 3, 32)]


@pytest.mark.parametrize("family,n_gps,cap", CASES)
def test_intervals_plain_matches_pallas(family, n_gps, cap):
    jgps, pgps, grid = _models(family, n_gps, cap, seed=cap + n_gps)
    beta = 2.0
    jout = jfp.fused_intervals_batched(
        tuple(g.kern for g in jgps), tuple(g.state for g in jgps),
        jnp.asarray(grid), beta, block=256)
    before = pfp.fused_intervals.launches
    pout = pfp.fused_intervals_batched(
        [g.kern for g in pgps], [g.state for g in pgps],
        torch.tensor(grid), beta)
    assert pfp.fused_intervals.launches == before   # CPU: no kernel launch
    assert pout.shape == (n_gps, 2, grid.shape[0])
    for g, (l, u) in enumerate(jout):
        np.testing.assert_allclose(pout[g, 0].numpy(), np.asarray(l),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(pout[g, 1].numpy(), np.asarray(u),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("n_obs,cap", [(600, 1024), (2000, 2048)])
def test_intervals_plain_matches_jax_past_resident_rows(n_obs, cap):
    # capacities whose active rows K1's resident body cannot hold on the
    # card (float32 past 512 rows), where the port launches its tiled
    # body; the JAX package takes its XLA route at both (fused_vmem_ok:
    # past 12 MB of factor and blocks)
    rng = np.random.default_rng(cap)
    X = rng.uniform(-4.0, 4.0, size=(n_obs, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=n_obs))[:, None]
    jgp = jt.GPRegression(X, Y, jt.RBF(2, variance=2.0, lengthscale=1.0),
                          noise_var=0.05 ** 2, capacity=cap)
    pgp = gp_from_arrays(kernel_from_params(**kernel_params(jgp.kern)),
                         **gp_arrays(jgp), device="cpu")
    grid = rng.uniform(-5.0, 5.0, size=(1000, 2))
    (l, u), = jfp.fused_intervals_batched(
        (jgp.kern,), (jgp.state,), jnp.asarray(grid), 2.0, block=256)
    pout = pfp.fused_intervals_batched([pgp.kern], [pgp.state],
                                       torch.tensor(grid), 2.0)
    assert int(pgp.state.count) == n_obs
    np.testing.assert_allclose(pout[0, 0].numpy(), np.asarray(l), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(pout[0, 1].numpy(), np.asarray(u), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("family,n_gps,cap", CASES)
def test_expander_plain_matches_pallas(family, n_gps, cap):
    jgps, pgps, grid = _models(family, n_gps, cap, seed=7 * cap + n_gps)
    beta = 2.0
    fmin = np.array([0.4, 0.6, 0.5][:n_gps])
    kerns = tuple(g.kern for g in jgps)
    states = tuple(g.state for g in jgps)
    jint = jfp.fused_intervals_batched(kerns, states, jnp.asarray(grid),
                                       beta, block=256)
    l = np.stack([np.asarray(a) for a, _ in jint])           # (G, N)
    u = np.stack([np.asarray(b) for _, b in jint])
    mu, sigma = (l + u) / 2, (u - l) / (2 * beta)
    safe = np.all(l > fmin[:, None], axis=0)
    unsafe = ~safe
    cand = np.flatnonzero(safe)[:16]
    assert cand.size > 0 and unsafe.any()
    Xc = grid[cand]
    ucs = u[:, cand]
    valid = np.ones(cand.size, bool)
    valid[-1] = False                                         # a pad slot
    jpred = np.asarray(jfe.fused_expander_predicate_batched(
        kerns, states, jnp.asarray(grid), jnp.asarray(unsafe),
        jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(Xc),
        jnp.asarray(ucs), jnp.asarray(valid), jnp.asarray(beta),
        jnp.asarray(fmin), block=256))
    t = torch.tensor
    before = pfe.fused_expander.launches
    ppred = pfe.fused_expander_predicate_batched(
        [g.kern for g in pgps], [g.state for g in pgps], t(grid), t(unsafe),
        t(mu), t(sigma), t(Xc), t(ucs), t(valid), beta, t(fmin))
    assert pfe.fused_expander.launches == before
    np.testing.assert_array_equal(ppred.numpy(), jpred)
    assert jpred.any() and not jpred[:, -1].any()


def _ordered_rows(k, lm, w, kdiag, beta):
    """(2, B) interval rows with every sum taken in index order (no BLAS
    blocking), so that two problems that differ only by terms that are
    exact zeros give the same bits."""
    V = torch.zeros_like(k)
    for c in range(lm.shape[1]):
        V = V + lm[:, c, None] * k[c, None, :]
    mu, ssq = torch.zeros_like(k[0]), torch.zeros_like(k[0])
    for r in range(lm.shape[0]):
        mu = mu + w[r] * V[r]
        ssq = ssq + V[r] * V[r]
    spread = beta * torch.sqrt(torch.clamp(kdiag - ssq, min=0.0))
    return torch.stack([mu - spread, mu + spread])


def _check_active_rows(k, lm, w, kdiag, beta, n, plain_full, plain_cut):
    """Past the count n the masked factor and w are exactly zero, so the
    rows summed in order over the leading n x n block equal those over
    cap bitwise, and the plain version (BLAS order) agrees to 1e-12."""
    assert not lm[n:].any() and not lm[:, n:].any() and not w[n:].any()
    assert torch.equal(_ordered_rows(k, lm, w, kdiag, beta),
                       _ordered_rows(k[:n], lm[:n, :n], w[:n], kdiag, beta))
    assert (plain_full - plain_cut).abs().max().item() <= 1e-12


@pytest.mark.parametrize("family,n_gps,cap", [("RBF", 2, 64),
                                              ("Matern52", 1, 100),
                                              ("Matern32", 2, 13),
                                              ("Exponential", 3, 512)])
def test_intervals_read_only_the_active_rows(family, n_gps, cap):
    # K1 stops its rows and its contraction at each GP's count, which it
    # reads from scal[:, 3]
    jgps, pgps, grid = _models(family, n_gps, cap, seed=5 * cap + n_gps)
    zt, ils, xs, lm, w, scal, kind = pfp.interval_operands(
        [g.kern for g in pgps], [g.state for g in pgps], torch.tensor(grid),
        2.0)
    for g, jgp in enumerate(jgps):
        n = int(jgp.state.count)
        assert 0 < n < cap
        assert scal[g, 3].item() == n
        one = dict(zt=zt, ils=ils[g:g + 1], scal=scal[g:g + 1], kind=kind)
        full = pfp.fused_intervals_plain(xs=xs[g:g + 1], lm=lm[g:g + 1],
                                         w=w[g:g + 1], **one)
        cut = pfp.fused_intervals_plain(
            xs=xs[g:g + 1, :n].contiguous(),
            lm=lm[g:g + 1, :n, :n].contiguous(),
            w=w[g:g + 1, :n].contiguous(), **one)
        k = pfp.gram(kind, xs[g], zt * ils[g][:, None], scal[g, 0])
        _check_active_rows(k, lm[g], w[g], scal[g, 1], scal[g, 2], n,
                           full[0], cut[0])


def test_transposed_factor_pads_rows():
    lm = torch.arange(2 * 40 * 40, dtype=torch.float64).reshape(2, 40, 40)
    lmt = pfp.transposed_factor(lm)
    assert lmt.shape == (2, 40, 64)
    assert torch.equal(lmt[:, :, :40], lm.transpose(1, 2))
    assert not lmt[:, :, 40:].any()
    lm = lm[:, :32, :32].contiguous()   # a multiple of 32: no padding
    lmt = pfp.transposed_factor(lm)
    assert lmt.is_contiguous() and torch.equal(lmt, lm.transpose(1, 2))


def test_wrappers_raise_off_cpu_and_cuda():
    _, pgps, grid = _models("RBF", 1, 16, seed=0)
    ops = pfp.interval_operands([pgps[0].kern], [pgps[0].state],
                                torch.tensor(grid), 2.0)
    meta = [o.to("meta") if torch.is_tensor(o) else o for o in ops]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pfp.fused_intervals(*meta)


def test_mixed_families_are_rejected_in_one_launch():
    _, pgps, grid = _models("RBF", 1, 16, seed=0)
    with pytest.raises(ValueError, match="one stationary family"):
        pfp.kind_of([pgps[0].kern, jt.Matern32(2)])


def test_operand_checks():
    zt = torch.zeros((2, 10), dtype=torch.float32)
    cpu = torch.device("cpu")
    pfp.check_operands(dict(zt=zt), cpu, torch.float32, dict(zt=(2, 10)))
    wide = torch.zeros((pfp.MAX_DIM + 1, 10), dtype=torch.float32)
    with pytest.raises(ValueError, match="grid columns"):
        pfp.check_operands(dict(zt=wide), cpu, torch.float32,
                           dict(zt=tuple(wide.shape)))
    with pytest.raises(TypeError, match="dtype"):
        pfp.check_operands(dict(zt=zt), cpu, torch.float64, dict(zt=(2, 10)))
    with pytest.raises(ValueError, match="shape"):
        pfp.check_operands(dict(zt=zt), cpu, torch.float32, dict(zt=(2, 9)))
    with pytest.raises(ValueError, match="contiguous"):
        pfp.check_operands(dict(zt=zt.T), cpu, torch.float32,
                           dict(zt=(10, 2)))


# -- K2 / K4: kernel algebras, one GP --------------------------------------

def _algebra(name):
    """The bench's context product, a Sum with a Bias leaf, and a
    Cosine product, as JAX kernels over 2 columns."""
    if name == "context":
        return (jt.RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0])
                * jt.RBF(1, variance=1.0, lengthscale=1.5, active_dims=[1]))
    if name == "sum_bias":
        return (jt.RBF(2, variance=1.5, lengthscale=[0.8, 1.2], ARD=True)
                + jt.Bias(2, variance=0.5))
    return (jt.Cosine(1, variance=1.0, lengthscale=2.0, active_dims=[1])
            * jt.Matern52(1, variance=1.5, active_dims=[0])
            + jt.Exponential(2, variance=0.3, lengthscale=2.0))


def _algebra_model(name, cap, seed, n_obs=23):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n_obs, 2))
    Y = (1.0 + np.cos(X.sum(axis=1))
         + 0.05 * rng.normal(size=n_obs))[:, None]
    jgp = jt.GPRegression(X, Y, _algebra(name), noise_var=0.01,
                          capacity=cap)
    pgp = gp_from_arrays(kernel_from_params(**kernel_params(jgp.kern)),
                         **gp_arrays(jgp), device="cpu")
    return jgp, pgp, rng.uniform(-3.0, 3.0, size=(1000, 2))


ALGEBRAS = [("context", 64), ("sum_bias", 32), ("cosine", 40)]


@pytest.mark.parametrize("name,cap", ALGEBRAS)
def test_plan_intervals_plain_matches_pallas(name, cap):
    jgp, pgp, grid = _algebra_model(name, cap, seed=cap)
    assert pfp.supports_plan(pgp.kern, 2)
    assert not pfp.supports_kernel(pgp.kern, 2)
    l, u = jfp.fused_intervals(jgp.kern, jgp.state, jnp.asarray(grid), 2.0,
                               block=256)
    before = pfp.fused_intervals_plan.launches
    out = pfp.fused_intervals_single(pgp.kern, pgp.state,
                                     torch.tensor(grid), 2.0)
    assert pfp.fused_intervals_plan.launches == before
    assert out.shape == (2, grid.shape[0])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(l), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(u), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("name,n_obs,cap", [("context", 600, 1024),
                                            ("context", 2000, 2048),
                                            ("nine", 600, 1024)])
def test_plan_intervals_plain_matches_jax_past_resident_rows(name, n_obs,
                                                             cap):
    # capacities whose active rows K2's resident body cannot hold on the
    # card (float32 past 512 rows), where the port launches its tiled
    # body (the nine-leaf plan its wide tiled instance): a long contextual
    # campaign, observations over contexts in [-1, 1]
    rng = np.random.default_rng(cap + n_obs)
    X = np.hstack([rng.uniform(-3.0, 3.0, size=(n_obs, 1)),
                   rng.uniform(-1.0, 1.0, size=(n_obs, 1))])
    Y = (2.0 * np.exp(-0.5 * X[:, 0] ** 2 - 0.5 * (X[:, 1] / 1.5) ** 2)
         + 0.05 * rng.normal(size=n_obs))[:, None]
    kern = _algebra("context") if name == "context" else _nine_leaves(jt)
    jgp = jt.GPRegression(X, Y, kern, noise_var=0.05 ** 2, capacity=cap)
    pgp = gp_from_arrays(kernel_from_params(**kernel_params(jgp.kern)),
                         **gp_arrays(jgp), device="cpu")
    grid = np.hstack([rng.uniform(-3.0, 3.0, size=(1000, 1)),
                      rng.uniform(-1.0, 1.0, size=(1000, 1))])
    l, u = jfp.fused_intervals(jgp.kern, jgp.state, jnp.asarray(grid), 2.0,
                               block=256)
    before = pfp.fused_intervals_plan.launches
    out = pfp.fused_intervals_single(pgp.kern, pgp.state,
                                     torch.tensor(grid), 2.0)
    assert pfp.fused_intervals_plan.launches == before
    assert int(pgp.state.count) == n_obs
    assert pfp.part_plan(pgp.kern, 2, out)[2].shape[1] == (
        2 if name == "context" else pfp.MAX_LEAVES + 1)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(l), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(u), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("name,cap", ALGEBRAS)
def test_plan_expander_plain_matches_pallas(name, cap):
    jgp, pgp, grid = _algebra_model(name, cap, seed=3 * cap)
    beta = 2.0
    l, u = (np.asarray(a) for a in jfp.fused_intervals(
        jgp.kern, jgp.state, jnp.asarray(grid), beta, block=256))
    mu, sigma = (l + u) / 2, (u - l) / (2 * beta)
    fmin = float(np.quantile(l, 0.4))
    safe = l > fmin
    cand = np.flatnonzero(safe)[::40][:16]
    Xc, uc = grid[cand], u[cand]
    valid = np.ones(cand.size, bool)
    valid[-2:] = False                                        # pad slots
    seen = set()
    for shift in (0.0, 0.2, 0.6):
        jpred = np.asarray(jfe.fused_expander_predicate(
            jgp.kern, jgp.state, jnp.asarray(grid), jnp.asarray(~safe),
            jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(Xc),
            jnp.asarray(uc), jnp.asarray(valid), beta, fmin + shift,
            block=256))
        t = torch.tensor
        before = pfe.fused_expander_plan.launches
        ppred = pfe.fused_expander_predicate_single(
            pgp.kern, pgp.state, t(grid), t(~safe), t(mu), t(sigma), t(Xc),
            t(uc), t(valid), beta, t(fmin + shift))
        assert pfe.fused_expander_plan.launches == before
        np.testing.assert_array_equal(ppred.numpy(), jpred)
        assert not jpred[-2:].any()
        seen.update(jpred[:-2].tolist())
    assert seen == {True, False}


@pytest.mark.parametrize("name,cap", ALGEBRAS)
def test_plan_intervals_read_only_the_active_rows(name, cap):
    # K2 as K1: scal[3] is the JAX state's count
    jgp, pgp, grid = _algebra_model(name, cap, seed=cap + 1)
    zt, xs, lm, w, scales, pvar, plan, scal = pfp.interval_plan_operands(
        pgp.kern, pgp.state, torch.tensor(grid), 2.0)
    n = int(jgp.state.count)
    assert 0 < n < cap
    assert scal[3].item() == n
    full = pfp.fused_intervals_plan_plain(zt, xs, lm, w, scales, pvar, plan,
                                          scal)
    cut = pfp.fused_intervals_plan_plain(
        zt, xs[:n].contiguous(), lm[:n, :n].contiguous(), w[:n].contiguous(),
        scales, pvar, plan, scal)
    kinds, terms = plan.tolist()
    k = pfp.plan_gram(xs, zt, scales.tolist(), pvar, kinds, terms)
    _check_active_rows(k, lm, w, scal[1], scal[2], n, full, cut)


def _candidate_pass(safe, u):
    """Up to 16 safe points, every third, as one expander chunk with its
    last slot padding: (candidate indices, valid)."""
    cand = torch.nonzero(safe).squeeze(1)[::3][:16]
    valid = torch.ones(cand.numel(), dtype=torch.bool)
    valid[-1] = False
    return cand, valid


@pytest.mark.parametrize("family,n_gps,cap", [("RBF", 2, 64),
                                              ("Matern52", 1, 100),
                                              ("Matern32", 2, 13),
                                              ("Exponential", 3, 512)])
def test_expander_reads_only_the_active_rows(family, n_gps, cap):
    # K3 stops its contraction and its gram at each GP's count, which it
    # reads from scal[:, 1]: past the count M2 is exactly zero, so the
    # predicate over the leading n rows is the one over cap
    jgps, pgps, grid = _models(family, n_gps, cap, seed=11 * cap + n_gps)
    kerns, states = [g.kern for g in pgps], [g.state for g in pgps]
    grid = torch.tensor(grid)
    beta = 2.0
    iv = pfp.fused_intervals_batched(kerns, states, grid, beta)
    l, u = iv[:, 0], iv[:, 1]
    fmin = torch.quantile(l, 0.2, dim=1)
    safe = torch.all(l > fmin[:, None], dim=0)
    cand, valid = _candidate_pass(safe, u)
    zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, kind = (
        pfe.expander_operands(kerns, states, grid, ~safe, (l + u) / 2,
                              (u - l) / (2 * beta), grid[cand], u[:, cand],
                              valid, beta, fmin))
    seen = set()
    for g, jgp in enumerate(jgps):
        n = int(jgp.state.count)
        assert 0 < n < cap
        assert scal[g, 1].item() == n
        assert not m2[g, :, n:].any()
        one = dict(zt=zt, unsafe=unsafe, mu=mu[g:g + 1], sigma=sigma[g:g + 1],
                   ils=ils[g:g + 1], xc=xc[g:g + 1], cvec=cvec[g:g + 1],
                   kind=kind)
        for shift in (0.0, 0.3, 1.0):
            s = scal[g:g + 1].clone()
            s[:, 3] += shift
            full = pfe.fused_expander_plain(xs=xs[g:g + 1], m2=m2[g:g + 1],
                                            scal=s, **one)
            cut = pfe.fused_expander_plain(
                xs=xs[g:g + 1, :n].contiguous(),
                m2=m2[g:g + 1, :, :n].contiguous(), scal=s, **one)
            assert torch.equal(full, cut)
            seen.update(full[0, :-1].tolist())
    assert seen == {True, False}


@pytest.mark.parametrize("name,cap", ALGEBRAS)
def test_plan_expander_reads_only_the_active_rows(name, cap):
    # K4 as K3: scal[1] is the JAX state's count
    jgp, pgp, grid = _algebra_model(name, cap, seed=cap + 2)
    grid = torch.tensor(grid)
    beta = 2.0
    l, u = pfp.fused_intervals_single(pgp.kern, pgp.state, grid, beta)
    fmin = torch.quantile(l, 0.4)
    safe = l > fmin
    cand, valid = _candidate_pass(safe, u)
    ops = pfe.expander_plan_operands(pgp.kern, pgp.state, grid, ~safe,
                                     (l + u) / 2, (u - l) / (2 * beta),
                                     grid[cand], u[cand], valid, beta, fmin)
    zt, unsafe, mu, sigma, xs, xc, m2, cvec, scales, pvar, plan, scal = ops
    n = int(jgp.state.count)
    assert 0 < n < cap
    assert scal[1].item() == n
    assert not m2[:, n:].any()
    seen = set()
    for shift in (0.0, 0.2, 0.6):
        s = scal.clone()
        s[3] += shift
        full = pfe.fused_expander_plan_plain(zt, unsafe, mu, sigma, xs, xc,
                                             m2, cvec, scales, pvar, plan, s)
        cut = pfe.fused_expander_plan_plain(
            zt, unsafe, mu, sigma, xs[:n].contiguous(), xc,
            m2[:, :n].contiguous(), cvec, scales, pvar, plan, s)
        assert torch.equal(full, cut)
        seen.update(full[:-1].tolist())
    assert seen == {True, False}


def test_plan_layout_and_limits():
    kern = kernel_from_params(**kernel_params(_algebra("cosine")))
    f64 = torch.zeros(1, dtype=torch.float64)
    scales, pvar, plan, kdiag = pfp.part_plan(kern, 2, f64)
    # cos(col 1) * matern52(col 0) + exponential(both): 3 leaves, 2 terms
    np.testing.assert_array_equal(plan.numpy(), [[4, 2, 3], [0, 0, 1]])
    np.testing.assert_allclose(scales.numpy(),
                               [[0.0, 0.5], [1.0, 0.0], [0.5, 0.5]])
    np.testing.assert_array_equal(pvar.numpy(), [1.0, 1.5, 0.3])
    assert kdiag == 1.0 * 1.5 + 0.3
    # past the leaves staged in static shared memory the plan is built
    # all the same and the CUDA wrappers' checks pass it (the kernels'
    # wide instances stage it in dynamic shared memory); a grid past
    # MAX_DIM columns fails them
    big = jt.RBF(2)
    for _ in range(pfp.MAX_LEAVES):
        big = big * jt.RBF(2)
    big = kernel_from_params(**kernel_params(big))
    scales, pvar, plan, kdiag = pfp.part_plan(big, 2, f64)
    assert plan.shape == (2, pfp.MAX_LEAVES + 1)
    np.testing.assert_array_equal(plan[1].numpy(), 0)     # one term
    P = pfp.MAX_LEAVES + 1
    named = dict(zt=torch.zeros((2, 5), dtype=torch.float64), scales=scales,
                 pvar=pvar, plan=plan)
    shapes = dict(zt=(2, 5), scales=(P, 2), pvar=(P,), plan=(2, P))
    pfp.check_operands(named, f64.device, torch.float64, shapes)
    wide = dict(named, zt=torch.zeros((pfp.MAX_DIM + 1, 5),
                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="grid columns"):
        pfp.check_operands(wide, f64.device, torch.float64,
                           dict(shapes, zt=(pfp.MAX_DIM + 1, 5)))
    assert not pfp.supports_plan(kernel_from_params(**kernel_params(
        jt.RBF(1) + jt.White(1))), 1)
    assert not pfp.supports_plan(kernel_from_params(**kernel_params(
        jt.RBF(1, active_dims=[2]))), 2)


# -- past the static plan's leaves and the kernels' columns -------------------

def _nine_leaves(pkg, d=2):
    kern = pkg.RBF(d, variance=2.0, lengthscale=3.0)
    for _ in range(pfp.MAX_LEAVES):
        kern = kern * pkg.RBF(d, lengthscale=3.0)
    return kern


def test_plan_past_the_leaf_limit_matches_pallas():
    """A 9-leaf product (one leaf past K2's static plan) on the CPU: the
    plain version takes it and agrees with the JAX package's Pallas
    kernel, which takes any tree of stationary leaves."""
    rng = np.random.default_rng(9)
    X = rng.uniform(-2.0, 2.0, size=(15, 2))
    Y = (1.0 + np.cos(X.sum(axis=1)))[:, None]
    jgp = jt.GPRegression(X, Y, _nine_leaves(jt), noise_var=0.01,
                          capacity=32)
    pgp = gp_from_arrays(kernel_from_params(**kernel_params(jgp.kern)),
                         **gp_arrays(jgp), device="cpu")
    grid = rng.uniform(-3.0, 3.0, size=(700, 2))
    l, u = jfp.fused_intervals(jgp.kern, jgp.state, jnp.asarray(grid), 2.0,
                               block=256)
    out = pfp.fused_intervals_single(pgp.kern, pgp.state, torch.tensor(grid),
                                     2.0)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(l), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(u), rtol=0,
                               atol=1e-10)


def test_grid_past_the_column_limit_decides_on_the_cpu():
    """MAX_DIM: a grid one column wider than the CUDA kernels take
    (they refuse it, tests/test_torch_cuda.py) decides on CPU tensors,
    through the plain versions, as the JAX step does."""
    from safeopt_torch.algorithms import safe_opt_core as pcore
    from safeopt_tpu.algorithms import safe_opt_core as jcore

    # a product over 64 + 1 columns: the JAX package's native host gram
    # refuses one stationary leaf wider than 64 (ROADMAP Queue 3)
    d = pfp.MAX_DIM + 1
    rng = np.random.default_rng(65)
    X = rng.uniform(-0.3, 0.3, size=(6, d))
    Y = (1.2 - 0.2 * np.sum(X ** 2, axis=1))[:, None]
    kern = (jt.RBF(d - 1, variance=1.5, lengthscale=3.0,
                   active_dims=list(range(d - 1)))
            * jt.RBF(1, lengthscale=2.0, active_dims=[d - 1]))
    jgp = jt.GPRegression(X, Y, kern, noise_var=0.01)
    pgp = gp_from_arrays(kernel_from_params(**kernel_params(jgp.kern)),
                         **gp_arrays(jgp), device="cpu")
    grid = rng.uniform(-1.0, 1.0, size=(400, d))
    assert pcore._gp_groups((pgp.kern,), (pgp.state,), d) == [([0], "plan")]
    rj = jcore.safeopt_step((jgp.kern,), (jgp.state,), jnp.asarray(grid),
                            jnp.asarray([0.5]), jnp.asarray(2.0),
                            jnp.asarray([1.0]), jnp.asarray([0.0]), chunk=8)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    rp = pcore.safeopt_step((pgp.kern,), (pgp.state,), t(grid), t([0.5]),
                            2.0, t([1.0]), t([0.0]), chunk=8)
    np.testing.assert_allclose(rp.Q.numpy(), np.asarray(rj.Q), rtol=0,
                               atol=1e-10)
    for name in ("S", "M", "G"):
        np.testing.assert_array_equal(getattr(rp, name).numpy(),
                                      np.asarray(getattr(rj, name)))
    assert int(rp.next_idx) == int(rj.next_idx)


# -- K1-3p / K2-3p: the three-pass plain versions -----------------------------

# capacities past the float32 K1-3p/K2-3p resident body's rows on the card
# (``fused_posterior.three_pass_body``: the tiled body) and their
# observations; a few hundred grid points there
PAST_RESIDENT = {640: 600, 1024: 700}
THREE_PASS_CASES = CASES + [("RBF", 1, 640), ("Matern52", 1, 1024)]


@pytest.mark.parametrize("family,n_gps,cap", THREE_PASS_CASES)
def test_three_pass_plain_matches_pallas(family, n_gps, cap):
    """float64, lo unrounded: the three-pass plain version is the JAX
    package's ``_fused_intervals_multi_impl(three_pass=True)`` (interpret
    mode) up to summation order, also at capacities past the card's
    resident rows."""
    jgps, pgps, grid = _models(family, n_gps, cap, seed=3 * cap + n_gps,
                               n_obs=PAST_RESIDENT.get(cap, 11))
    if cap in PAST_RESIDENT:
        grid = grid[:300]
    jout = jfp.fused_intervals_batched(
        tuple(g.kern for g in jgps), tuple(g.state for g in jgps),
        jnp.asarray(grid), 2.0, block=256, three_pass=True)
    before = pfp.fused_intervals3.launches
    pout = pfp.fused_intervals_batched(
        [g.kern for g in pgps], [g.state for g in pgps], torch.tensor(grid),
        2.0, three_pass=True)
    assert pfp.fused_intervals3.launches == before   # CPU: no kernel launch
    full = pfp.fused_intervals_batched(
        [g.kern for g in pgps], [g.state for g in pgps], torch.tensor(grid),
        2.0)
    assert (pout - full).abs().max().item() > 1e-9   # the limbs dropped lo lo
    for g, (l, u) in enumerate(jout):
        np.testing.assert_allclose(pout[g, 0].numpy(), np.asarray(l),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(pout[g, 1].numpy(), np.asarray(u),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,cap", ALGEBRAS + [("context", 640),
                                                ("sum_bias", 1024)])
def test_plan_three_pass_plain_matches_pallas(name, cap):
    """As above for K2-3p: ``_fused_intervals_impl(three_pass=True)``."""
    jgp, pgp, grid = _algebra_model(name, cap, seed=2 * cap,
                                    n_obs=PAST_RESIDENT.get(cap, 23))
    if cap in PAST_RESIDENT:
        grid = grid[:300]
    l, u = jfp.fused_intervals(jgp.kern, jgp.state, jnp.asarray(grid), 2.0,
                               block=256, three_pass=True)
    before = pfp.fused_intervals_plan3.launches
    out = pfp.fused_intervals_single(pgp.kern, pgp.state, torch.tensor(grid),
                                     2.0, three_pass=True)
    assert pfp.fused_intervals_plan3.launches == before
    np.testing.assert_allclose(out[0].numpy(), np.asarray(l), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(u), rtol=0,
                               atol=1e-10)


def _reconstruct_three_pass(gram32, lm, w, kdiag, beta):
    """The rows from an independent cut: bf16 hi of float32 values, lo
    rounded to bf16, three float64 products."""
    def cut(x):
        hi = x.to(torch.bfloat16).float()
        return hi.double(), (x - hi).to(torch.bfloat16).double()

    hi, lo = cut(lm)
    k_hi, k_lo = cut(gram32)
    V = hi @ k_hi + hi @ k_lo + lo @ k_hi
    mu = (w.double()[:, None] * V).sum(dim=0)
    sd = float(beta) * torch.sqrt(torch.clamp(float(kdiag)
                                              - (V * V).sum(dim=0), min=0))
    return torch.stack([mu - sd, mu + sd]).float()


def test_three_pass_float32_plain_cuts_the_kernels_limbs():
    """float32: K1-3p's and K2-3p's plain versions are, bit for bit, the
    limbs of the kernel's gram (``kernel_gram`` / ``kernel_plan_gram``)
    and of Lm cut with lo rounded to bf16, the three products in float64."""
    jgps, pgps, grid = _models("RBF", 2, 64, seed=5)
    ops = pfp.interval_operands([g.kern for g in pgps],
                                [g.state for g in pgps],
                                torch.tensor(grid, dtype=torch.float32), 2.0)
    ops = tuple(o.float() if torch.is_tensor(o) else o for o in ops)
    zt, ils, xs, lm, w, scal, kind = ops
    out = pfp.fused_intervals3_plain(*ops)
    assert out.dtype == torch.float32
    for g in range(2):
        k = pfp.kernel_gram(kind, xs[g], zt * ils[g][:, None], scal[g, 0])
        assert torch.equal(out[g], _reconstruct_three_pass(
            k, lm[g], w[g], scal[g, 1], scal[g, 2]))
    _, pgp, grid = _algebra_model("context", 64, seed=11)
    pops = pfp.interval_plan_operands(pgp.kern, pgp.state,
                                      torch.tensor(grid), 2.0)
    pops = tuple(o.float() if o.is_floating_point() else o for o in pops)
    zt, xs, lm, w, scales, pvar, plan, scal = pops
    kinds, terms = plan.tolist()
    k = pfp.kernel_plan_gram(xs, zt, scales.tolist(), pvar, kinds, terms)
    assert torch.equal(pfp.fused_intervals_plan3_plain(*pops),
                       _reconstruct_three_pass(k, lm, w, scal[1], scal[2]))


def test_kernel_plan_gram_rounds_as_the_kernel():
    """The float32 plan gram adds each square with one rounding (a fused
    multiply-add) and otherwise takes the plain float32 gram's steps; in
    float64 it is ``plan_gram``."""
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert pfp._fma32(a, a, c.double()).item() == 2.0 ** -24
    assert (a * a + c).item() == 0.0           # two roundings lose it
    _, pgp, grid = _algebra_model("sum_bias", 32, seed=4)
    pops = pfp.interval_plan_operands(pgp.kern, pgp.state,
                                      torch.tensor(grid), 2.0)
    zt, xs, lm, w, scales, pvar, plan, scal = pops
    kinds, terms = plan.tolist()
    rows = scales.tolist()
    want = pfp.plan_gram(xs, zt, rows, pvar, kinds, terms)
    assert torch.equal(pfp.kernel_plan_gram(xs, zt, rows, pvar, kinds,
                                            terms), want)
    got32 = pfp.kernel_plan_gram(xs.float(), zt.float(), rows, pvar.float(),
                                 kinds, terms)
    assert got32.dtype == torch.float32
    assert (got32.double() - want).abs().max().item() <= 1e-5


# -- K5: exact top-k ----------------------------------------------------------

def _check_topk(key, k):
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(key), k)
    v, i = top_k(torch.tensor(key), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_random(k):
    rng = np.random.default_rng(99_991 + k)
    _check_topk(rng.normal(size=99_991).astype(np.float32), k)


def test_topk_massive_ties():
    rng = np.random.default_rng(0)
    _check_topk(rng.integers(0, 5, size=50_000).astype(np.float32), 64)


def test_topk_single_value_everywhere():
    _check_topk(np.full(40_000, 3.5, np.float32), 32)


def test_topk_masked_minus_inf():
    rng = np.random.default_rng(1)
    key = np.full(80_000, -np.inf, np.float32)
    live = rng.choice(80_000, size=17, replace=False)
    key[live] = rng.normal(size=17).astype(np.float32)
    _check_topk(key, 64)          # fewer finite entries than k


def test_topk_all_minus_inf():
    _check_topk(np.full(70_000, -np.inf, np.float32), 32)


def test_topk_flip_trick_tie_order():
    key = np.zeros(30_000, np.float32)
    key[[7, 19, 19_000]] = 2.0
    _check_topk(key[::-1].copy(), 16)


@pytest.mark.parametrize("n,k", [(300, 32), (31, 31), (20_000, 4096)])
def test_topk_sort_path(n, k):
    rng = np.random.default_rng(n)
    _check_topk(rng.integers(0, 9, size=n).astype(np.float64), k)


def test_topk_rejects_bad_k():
    with pytest.raises(ValueError):
        top_k(torch.zeros(4), 5)

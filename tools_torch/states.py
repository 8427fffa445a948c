"""The problem states that ``chip_smoke.py`` and the tools share.

The flagship's two GPs (``build_gps``), the cap-512 state of the interval
experiments in K1's operand layout (``cap512_operands``) and
``measure.py``'s long-campaign states (``long_operands``), their one-GP
slices (``one_gp``, ``first_gp``), B1's launch layouts (``LAYOUTS``) and
the float32 B1-3p's (``LAYOUTS3``),
the long-campaign sparse model (``sparse_data``, ``sparse_gp``) and the
exact GP on its data (``sparse_exact_gp``), the hyperparameter fits'
data and kernel (``fit_data``, ``fit_kernel``), the 10-d swarm problem
(``swarm_data``, ``swarm_gps``, ``swarm_problem``, ``swarm_plant``) and
the CUDA-event timer. It imports nothing of ``chip_smoke.py`` or of the
tools, so each of them imports it and the dependency runs one way.
"""

import numpy as np
import torch

BETA = 2.0
# B1's launch layouts (slices per block, resident gram rows, shared-memory
# carveout), by capacity and dtype; (0, 0, -1) is K1's own layout at the
# kernel's own carveout
LAYOUTS = {
    512: {torch.float32: [(0, 0, -1), (1, 256, -1), (1, 0, -1),
                          (2, 512, -1), (2, 256, -1), (4, 128, -1),
                          (8, 64, -1), (0, 0, 100), (0, 0, 0)],
          torch.float64: [(0, 0, -1), (1, 0, -1), (1, 512, -1),
                          (2, 128, -1), (4, 64, -1), (8, 16, -1),
                          (0, 0, 100)]},
    64: dict.fromkeys((torch.float32, torch.float64),
                      [(0, 0, -1), (1, 0, -1), (1, 64, 100), (2, 32, -1),
                       (4, 0, 0), (8, 64, -1)]),
}


# The float32 B1-3p's launch layouts (consumer warpgroups, ring stages,
# resident gram rows, shared-memory carveout; 0 and -1 are K1-3p's own
# choice), by capacity. A count of warpgroups other than K1-3p's (one up
# to capacity 128, three past it: ``b1_3p_groups``) changes the order in
# which the rows are added; the others keep K1-3p's bits.
LAYOUTS3 = {
    512: [(0, 0, 0, -1), (0, 2, 0, -1), (0, 4, 0, -1), (0, 0, 256, -1),
          (0, 0, 32, -1), (0, 2, 128, -1), (0, 0, 0, 100), (0, 0, 0, 0),
          (3, 3, 512, -1), (1, 0, 0, -1), (1, 4, 64, -1)],
    64: [(0, 0, 0, -1), (0, 2, 0, -1), (0, 4, 0, -1), (0, 0, 32, -1),
         (0, 0, 0, 100), (1, 3, 64, 0), (3, 0, 0, -1), (3, 2, 32, -1)],
}


def b1_3p_groups(cap):
    """K1-3p's consumer warpgroups a block at capacity ``cap`` (its
    resident body; csrc/intervals3.cuh kSmallCap3)."""
    return 1 if cap <= 128 else 3


def build_gps(rng, n_obs, capacity, device, dtype, spread=1.5, d=2):
    """The bench flagship's two GPs (objective + one constraint)."""
    from safeopt_torch import RBF, GPRegression

    X = rng.uniform(-spread, spread, size=(n_obs, d))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
          + 0.05 * rng.normal(size=n_obs))[:, None]
    Yg = (1.0 - 0.1 * np.sum(X ** 2, axis=1)
          + 0.05 * rng.normal(size=n_obs))[:, None]
    return [GPRegression(X, Yf, RBF(d, variance=2.0, lengthscale=1.0),
                         noise_var=0.05 ** 2, capacity=capacity,
                         device=device, dtype=dtype),
            GPRegression(X, Yg, RBF(d, variance=1.0, lengthscale=1.5),
                         noise_var=0.05 ** 2, capacity=capacity,
                         device=device, dtype=dtype)]


def sparse_data(n=2000, seed=11):
    """The JAX bench's long-campaign data (``bench.py:969-980``): n
    observations of the flagship's objective, 2 exp(-|x|^2 / 2) plus noise
    of std 0.05, uniform in [-4, 4]^2."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4.0, 4.0, size=(n, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=n))[:, None]
    return X, Y


def sparse_gp(m, device, dtype, data=None, **kw):
    """A ``SparseGPRegression`` with m inducing points over ``data``
    (``sparse_data()`` when None): RBF(2, variance 2, lengthscale 1), noise
    0.05^2, the bench's model; ``kw`` are the floor's settings."""
    from safeopt_torch import RBF, SparseGPRegression

    X, Y = sparse_data() if data is None else data
    return SparseGPRegression(X, Y, RBF(2, variance=2.0, lengthscale=1.0),
                              noise_var=0.05 ** 2, inducing=m,
                              device=device, dtype=dtype, **kw)


def sparse_exact_gp(device, dtype, data=None, capacity=2048):
    """The exact GP on ``sparse_data()`` (the sparse model's kernel and
    noise) at ``capacity``."""
    from safeopt_torch import RBF, GPRegression

    X, Y = sparse_data() if data is None else data
    return GPRegression(X, Y, RBF(2, variance=2.0, lengthscale=1.0),
                        noise_var=0.05 ** 2, capacity=capacity,
                        device=device, dtype=dtype)


# the JAX bench's swarm problem (bench.py:1333-1353 ``_swarm_config``)
SWARM_D = 10
SWARM_SIZE = 20


def swarm_data(n=5, seed=0, spread=0.5):
    """n points uniform in [-spread, spread]^10 from ``default_rng(seed)``
    and their two measurements: the objective 2 exp(-|x|^2 / 2) and the
    constraint 1 - 0.05 |x|^2 (the bench's 5 points at the defaults)."""
    X = np.random.default_rng(seed).uniform(-spread, spread,
                                            size=(n, SWARM_D))
    r2 = np.sum(X ** 2, axis=1)
    return X, (2.0 * np.exp(-0.5 * r2))[:, None], (1.0 - 0.05 * r2)[:, None]


def swarm_gps(num_gps, device, dtype, data=None, capacity=None):
    """The bench's swarm GPs over ``data`` (``swarm_data()`` when None):
    RBF(10, variance 2, lengthscale 2) on the objective and, for two GPs,
    Matern32(10, variance 1, lengthscale 3) on the constraint, noise
    variance 0.01."""
    from safeopt_torch import GPRegression, Matern32, RBF

    X, Yf, Yg = swarm_data() if data is None else data
    kw = dict(noise_var=0.01, capacity=capacity, device=device, dtype=dtype)
    gps = [GPRegression(X, Yf, RBF(SWARM_D, variance=2.0, lengthscale=2.0),
                        **kw)]
    if num_gps == 2:
        gps.append(GPRegression(
            X, Yg, Matern32(SWARM_D, variance=1.0, lengthscale=3.0), **kw))
    return gps


def swarm_problem(num_gps):
    """``SafeOptSwarm``'s arguments besides the GPs: fmin [0] for the
    objective alone, [-inf, 0] with the constraint; bounds [-3, 3]^10;
    20 particles (100 PSO iterations a swarm, the default)."""
    return dict(fmin=[0.0] if num_gps == 1 else [-np.inf, 0.0],
                bounds=[(-3.0, 3.0)] * SWARM_D, swarm_size=SWARM_SIZE)


def swarm_plant(x, num_gps):
    """The swarm problem's measurements at x, in NumPy float64: (1, G)."""
    r2 = float(np.sum(np.asarray(x, dtype=float) ** 2))
    return np.array([[2.0 * np.exp(-0.5 * r2), 1.0 - 0.05 * r2][:num_gps]])


def fit_data(seed=7, n=512, n_sparse=2000):
    """The JAX bench's hyperparameter data (``bench.py:1675-1686`` and
    ``:1701-1703``): n points of 1.5 exp(-|x / (1, 1.8)|^2 / 2) plus noise
    of std 0.05, uniform in [-3, 3]^2, then ``n_sparse`` more from the same
    generator for the sparse fit. Returns ((X, Y), (Xs, Ys))."""
    rng = np.random.default_rng(seed)
    out = []
    for size in (n, n_sparse):
        X = rng.uniform(-3.0, 3.0, size=(size, 2))
        Y = (1.5 * np.exp(-0.5 * np.sum((X / [1.0, 1.8]) ** 2, axis=1))
             + 0.05 * rng.normal(size=size))[:, None]
        out.append((X, Y))
    return tuple(out)


def fit_kernel():
    """The fits' starting kernel: RBF-ARD(2, variance 0.6, lengthscales
    0.4, 0.4), as the JAX bench starts them."""
    from safeopt_torch import RBF

    return RBF(2, variance=0.6, lengthscale=[0.4, 0.4], ARD=True)


def cap512_operands(dtype, grid=None):
    """K1's operands of the cap-512 state in ``dtype`` on the card: the
    flagship's GPs with 400 observations from ``default_rng(512)`` in
    [-4, 4]^2, over ``grid`` (the 1000 x 1000 grid on [-5, 5]^2 when
    None)."""
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops import fused_posterior as fp

    if grid is None:
        grid = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    gps = build_gps(np.random.default_rng(512), 400, 512, "cuda", dtype,
                    spread=4.0)
    return fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                                torch.tensor(grid, dtype=dtype,
                                             device="cuda"), BETA)


def long_operands(name, dtype, grid=None):
    """K1's operands of one of ``measure.py``'s long-campaign states in
    ``dtype`` on the card, G = 1, over ``grid`` (the 1000 x 1000 grid on
    [-5, 5]^2 when None): ``cap1024`` GP 0 of the flagship pair with 600
    observations from ``default_rng(1024)`` in [-4, 4]^2 at capacity
    1024, ``cap2048`` the exact GP on ``sparse_data()`` (2000
    observations) at capacity 2048."""
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.ops import fused_posterior as fp

    if grid is None:
        grid = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    if name == "cap2048":
        gps = [sparse_exact_gp("cuda", dtype)]
    elif name == "cap1024":
        gps = build_gps(np.random.default_rng(1024), 600, 1024, "cuda",
                        dtype, spread=4.0)[:1]
    else:
        raise ValueError(f"unknown long-campaign state {name!r}")
    return fp.interval_operands([g.kern for g in gps], [g.state for g in gps],
                                torch.as_tensor(grid, dtype=dtype,
                                                device="cuda"), BETA)


def one_gp(ops, g=0):
    """GP g's operands in B4's single-GP layout."""
    zt, ils, xs, lm, w, scal, kind = ops
    return zt, ils[g], xs[g], lm[g], w[g], scal[g], kind


def first_gp(ops):
    """K1's operands of GP 0 alone."""
    zt, ils, xs, lm, w, scal, kind = ops
    return zt, ils[:1], xs[:1], lm[:1], w[:1], scal[:1], kind


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

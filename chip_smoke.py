#!/usr/bin/env python3
"""Drive the PyTorch port of SafeOpt and SafeOptSwarm once on an NVIDIA GPU
and check it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the CUDA kernels from ``safeopt_torch/ops/csrc``
   (one nvcc per source, in parallel), prints ptxas's line of each
   kernel and checks that the SASS of the float32 K1-3p and K2-3p
   (``csrc/fused_intervals3.cu``: K1-3p and K2-3p's static and wide
   plans, each with three consumer warpgroups a block and with one)
   holds HGMMA, Hopper's warpgroup tensor-core product;
3. K1 (fused intervals) against its plain PyTorch version at G=2, d=2,
   N=1e6, capacity 64 (the flagship) and 512 (400 observations), one
   launch of two GPs at capacity 512 whose counts differ (20 and 300),
   G=1 at capacity 1024 (600 observations: the gram is not resident in
   shared memory, in float32 past row 512, in float64 past 256) and G=1
   at capacity 64: float64 kernel vs float64 plain to 1e-9; float32
   kernel vs float64 plain with identical ``l > fmin`` decisions outside
   a scaled band of 1e-3;
4. K3 (fused expander predicate) on a chunk of 32 candidates from the
   head and the middle of the visit order, with padding slots, at
   several raised thresholds so that the plain predicate holds both
   values: float64 identical, float32 identical outside the band; on the
   flagship's GPs (capacity 64), at capacity 512 (400 observations), one
   launch of two GPs at capacity 512 whose counts differ (20 and 300,
   observations in [-1.5, 1.5]^2), and G=1 at capacity 1024 (600
   observations in [-1.5, 1.5]^2: M2 is not all resident in shared
   memory, in float32 past row 512, in float64 past 256);
5. K2 (intervals of one GP with a kernel algebra) against its plain
   version on the bench's contextual kernel, RBF(parameter) x
   RBF(context), over the same grid (column 1 is the context): capacity
   64 with 50 observations, capacity 256 with 250, capacity 1024 with
   600 (gram not resident), a Sum with a Bias leaf and a Cosine leaf
   on one column, and the contextual kernel written as a product of nine
   leaves at capacity 256 (one leaf past the plan K2/K4 stage in static
   shared memory: their wide instances); tolerances as K1's;
6. K4 (expander predicate of one GP with a kernel algebra) as K3's
   check, on the contextual kernel's two GPs at capacity 256, and on the
   same GPs with the nine-leaf kernel (K4's wide instances);
7. K5 (exact top-k) on CUDA tensors with massive ties and all -inf;
8. the interval-stage experiments B1-B5
   (``safeopt_torch/ops/interval_experiments.py``) against their plain
   versions at the cap-512 state (G=2, 400 observations, N=1e6) and the
   flagship's cap 64, in float64 and float32: B1 (K1 at other launch
   layouts) bit-identical to K1; B2/B5 (ablations) and B3 (mu from the
   gram) to 1e-9 in float64 and in float32 within ``float32_bound``, the
   worst case of their float32 arithmetic, against the plain version in
   float64 on the same operands; B4 (the split-limb tensor-core product,
   bf16 and tf32 limbs) within ``float32_bound`` of its plain version,
   the same bits with Lm's limbs split in the kernel or passed
   pre-split, and its scaled error against the float64 plain rows
   printed beside K1's; beside each float32 bound its median and the
   rows' median |.|, and how far past it the rows of a kernel that drops
   each GP's first (which must be past the bound) or last 32 active
   rows land (``drop_band``); the harnesses' three-pass columns, which
   keep the mma.sync body K1-3p ran before its wgmma kernel: B1-3p
   bit-identical at every launch layout to itself at its automatic
   layout (0, 0, -1) in float64 and float32, and B1-3p (K1-3p's plain
   version), B2-3p (the rank-1 solve) and B3-3p (mu from the gram) to
   1e-9 in float64 and in float32 within their float32 bound of the
   plain version on the same operands, both planted faults past it,
   and the max scaled |dQ| against the float64 rows (B1-3p's and
   B3-3p's below ``refine_band - boundary_band``; B2-3p's rank-1 rows
   are no SafeOpt intervals, and theirs is printed beside the plain
   version's own); then the experiment path,
   ``tools_torch/bench_interval_experiments.py``'s five harnesses on the
   cap-512 state in float32 (B1-B3 with their ``3pass`` columns), with
   every count zeroed before it and read after it;
9. the flagship path: two RBF GPs, 1000 x 1000 grid, 50 observations,
   capacity 64, chunk 32, through ``SafeOpt.optimize`` and
   ``add_new_data_point`` for 10 iterations against a NumPy plant, with
   the first query checked against the float64 plain path on the CPU;
10. the contextual path: two GPs (objective + constraint) with the
   contextual kernel, 240 observations at context 0, capacity 256, a
   1e6-point parameter grid with one context column, chunk 32, through
   ``optimize(context=...)`` and ``add_new_data_point(..., context=...)``
   for 10 iterations (context 0.0, then 0.1 from iteration 6) and
    ``get_maximum(context=0.1)``, first query checked as in phase 9.
    Every kernel's launch count is zeroed just before each path and read
    just after it; neither path launches an experiment kernel;
11. K1-3p and K2-3p (``fused_intervals3`` / ``fused_intervals_plan3``,
    the three-pass bf16 product of the certified path; in float32 the
    wgmma kernels of ``csrc/fused_intervals3.cu``) against their
    plain versions: K1-3p at capacity 64 (the flagship's GPs), 512 (400
    observations), 512 with counts 20 and 300 in one launch and 1024 (600
    observations); K2-3p on the contextual kernel at
    capacity 256, on the Sum with Bias and Cosine leaves and on the
    nine-leaf kernel (the wide instance): float64 to 1e-9, float32
    within ``float32_bound(..., "split", "bf16")`` (``float32_bound_plan``
    for K2-3p) of the plain version on the same operands, and that bound
    below a planted fault (the plain rows with each GP's first, then
    last, 32 active rows dropped, ``drop_band``, must land past it);
    beside each the max scaled |dQ| against the float64 plain rows of
    K1/K2 (which must stay below ``refine_band - boundary_band`` at the
    defaults) and the decisions outside the 1e-3 band;
12. the certified paths: the cap-512 state (phase 3's GPs, 400
    observations), the contextual one (phase 10's) and the contextual
    one early in its run (20 observations in [-0.5, 0.5], context 0),
    each with
    ``exact_boundaries=True, interval_precision='high'`` and the host
    and the device oracle, 10 iterations of ``optimize`` and
    ``add_new_data_point`` in float32, in lockstep with a float64 plain
    ``SafeOpt`` of the same data on the card (and a float32 plain one,
    for the time): at every step the certified S equals the float64 S
    at every row whose float64 scaled margin is at least 1e-9 (the rows
    below it are counted), and the query equals the float64 query or
    their scaled widths agree within 1e-3. The cap-512 state and the
    early contextual one must refine their band within the budget
    (``REFINE_BAND_SHARE`` of the grid) at every step; the contextual
    state's band is past it at context 0 (those steps take the full
    float32 pass) and within it on at least two steps at context 0.1.
    Launch counts are zeroed just before each
    certified ``optimize()`` and read just after it: K1-3p (K2-3p) once
    per GP group, K1 (K2) once per group on the refined rows (or the
    full pass), no experiment kernel;
13. mixed routes at the flagship's width: GP 0 RBF(variance 2,
    lengthscale 1) on K1/K3, GP 1 RBF(variance 1, lengthscale 1.5) +
    White(1e-2) on the eager route (no kernel takes White), the
    flagship's grid and data; 10 iterations of ``optimize`` and
    ``add_new_data_point`` in float32 in lockstep with a float64
    ``SafeOpt`` of the same data on the card: S equal outside the 1e-3
    band, the query the float64 query or their scaled widths within 1e-3;
    K1 once a step and K3 once a walk chunk (GP 0's group), nothing of
    K2/K4 or the three-pass kernels; on the first step the float64
    run's rows of GP 1 within 1e-9 of ``mu -+ beta sigma`` from the
    host factor (``HostFactor.predict``) on 1e4 grid rows; the eager
    route's share of a step;
14. ``run_safeopt_loop`` on the flagship (10 iterations, noise 0) and
    on the contextual state (10 iterations, context 0.0 then 0.1 from
    iteration 6, through ``contexts``), each against the blocking
    ``SafeOpt`` loop on the same plant on the card: queries identical up
    to a first divergence, allowed only where the two queries' scaled
    widths agree within 1e-3; ``has_safe`` all true, counts grown by 10;
    ms per iteration of each, host syncs per iteration, launch counts
    zeroed before each loop and read after it;
15. ``run_lagged_campaign`` on the flagship, ``pipelined=True`` against
    ``False``, 8 iterations each, plain and certified
    (``interval_precision='high'``, device oracle): queries and
    observations bitwise equal; ms per iteration of each;
16. the sparse path at the JAX bench's long-campaign size
    (``bench.py:969-980``: 2000 observations in [-4, 4]^2 from
    ``default_rng(11)``, RBF(2, variance 2, lengthscale 1), noise 0.05^2,
    ``fmin=[0.2]``, the flagship's grid): K1 and K3 on
    ``SparseGPRegression`` states at m=64, 100 and 256 (capacity 64, 128,
    256: count == capacity at 64 and 256) as phases 3-4 hold them, beside
    max |R| and R's strict upper triangle, which must be zero on the card;
    ``SafeOpt`` on the m=64 model for 10 iterations in float32 in lockstep
    with a float64 twin on the card (K1 once a step, K3 once a walk chunk,
    no eager GP); the recommended floor (``conservative=0.75,
    calibration=0.99``) likewise, on the eager route (``eager_gps == 1``,
    no kernel launched); the certified path (``exact_boundaries=True,
    interval_precision='high'``, host and device oracle, whose kind is
    ``'sparse'``) on the m=64 model as phase 12 drives it, and the device
    oracle's verdicts against ``predict_f64``'s on the band rows; the
    optimistic and conservative drift of both models against the exact GP
    on the same data (capacity 2048), and ms per ``optimize()`` and
    ``add_new_data_point()`` of each path and of the exact GP;
17. hyperparameter fits (``bench.py:1675-1703``'s data, RBF-ARD):
    ``optimize_restarts(num_restarts=8, max_iters=200)`` of an exact GP on
    512 points on the card and with ``device='cpu'``, both above the
    initial LML, the card's LML within 1e-6 of the CPU's and within 1e-9
    of the host's SciPy LML at its parameters, the card's memory peak
    holding the restarts' grams; a sparse fit with moving inducing points
    (m=32, 2000 points) above its initial DTC LML; seconds of each;
18. times of the paths and of each kernel against its plain version
    (K3 also at capacity 512, K2 also on the nine-leaf kernel; B1-B5
    and B1-3p-B3-3p from the experiment path), beside the
    least time the card could take (``bound_ms``: the least work the
    output needs; for B2's rank-1 solve and B5's epilogue also the work
    the kernel is told to do, printed apart) and the share of that bound
    the kernel reaches; K1 also at phase 16's exact GP (G=1, 2000
    observations, capacity 2048, past the resident gram), timed after
    the others;
19. SafeOptSwarm at the JAX bench's widths (``bench.py:1333-1353``,
    ``tools_torch/states.py`` ``swarm_*``: d=10, 20 particles, 100 PSO
    iterations, bounds [-3, 3]^10): (a) G=1 and G=2 from the bench's 5
    observations (GP capacity 8, grown at the fourth append), (b) G=2 at
    250 observations (capacity 256, grown to 512) and (c) the sparse m=64
    model of phase 16, 10 float32 steps of ``optimize()`` and
    ``add_new_data_point()`` each against a NumPy plant. On (a) and (b) a
    graph-replaying optimizer and an eager twin fed the same uniforms:
    queries identical and the packed diagnostics bitwise equal at every
    step (or the differing outputs printed and held within 1e-6
    relative). Each dispatch, captures included, runs under
    ``torch.cuda.set_sync_debug_mode("error")`` and makes exactly one
    pull. Every query and every row a step adds to the safe set is safe
    by float64 (``predict_f64``) within 1e-3 of the scaling, or the query
    is a safe-set row held from before the step (the reference's rule,
    ROADMAP Queue 3 entry 13), and every row of the device safe set
    passed when it joined. (a) in float64 on the card against the CPU:
    queries within 1e-9 at each step (a flipped final choice is allowed
    past step 3 with a margin below 1e-12, and printed).
    ``run_swarmopt_loop`` on (a) G=2 under the same sync mode against
    the blocking loop on the same uniforms; ``run_lagged_campaign`` on
    (a) G=2, pipelined and serial bitwise equal. K1-K4 and K1-3p/K2-3p
    launch 0 times over the phase. It prints the eager and replayed ms
    per ``optimize()``, the captures' ms, kernels per step and the busy
    share (torch.profiler), and the loops' ms per iteration;
20. campaign fleets (``safeopt_torch.parallel``): (a) 8 campaigns of the
    flagship, campaign k from its own 50 observations (``build_gps``
    seeded 200 + k), and (b) the JAX bench's fleet (``bench.py:1510-1560``:
    8 campaigns of one RBF(2, variance 2, lengthscale 1.2) GP from one
    observation each, a 100 x 100 grid on [-2, 2]^2, capacity 16, chunk
    16), 8 iterations of ``run_safeopt_campaigns`` in float32 and in
    float64 against 8 solo ``run_safeopt_loop`` calls on the same states
    and normals: ``next_idx`` trajectories equal (float64 queries within
    1e-9), K1 once a fleet step for every campaign's GPs and K3 once a
    walk round (the counts zeroed before each fleet run and read after
    it), host syncs per fleet step against the solo loops' sum, ms per
    fleet iteration and per campaign-iteration against the solo loops'
    summed, (a)'s busy share; (c) one K3 launch for (a)'s 8 campaigns,
    each with its own mask (its ~S) and 32-slot chunk (phase 4's rule)
    and campaign 3's mask all False, at raised thresholds: float64 equal
    to its plain version, float32 outside the band, bitwise equal to 8
    single-mask launches in both dtypes, the planted campaign's rows all
    False while its neighbours hit; K1's launch over (a)'s 16 GPs held to
    its plain version (float64 within 1e-9, float32 decisions outside the
    band), then timed against its plain version and its bound, and so the
    K3 launch on the same chunks with the masks unplanted (each ~S, as
    the walk passes them); (d) 4 campaigns
    of phase 19's (a) G=2 state, each from its own 5 observations, 8
    iterations of ``run_swarmopt_campaigns`` replaying one CUDA graph a
    fleet step, every call under ``set_sync_debug_mode("error")``: step
    by step with each campaign's query and added rows held to phase 19's
    float64 safety rule, then at once against the batched eager run
    (bitwise) and each campaign's solo ``run_swarmopt_loop`` (float64
    queries within 1e-9), no grid kernel launched; replayed ms per fleet
    iteration against the solo loops' summed, kernels per fleet step and
    the capture's ms;
21. the utilities (``safeopt_torch.utils``), in float32 unless noted:
    (a) resume: the flagship, the certified flagship
    (``interval_precision='high'``: K1-3p runs after the load), the
    sparse m=64 model of phase 16 and phase 19's (a) G=2 swarm, each 4
    iterations, ``checkpoint.save``, ``checkpoint.load`` into a fresh
    object and 4 more, the queries (and SafeOpt's intervals) bitwise
    equal to 8 unbroken iterations; phase 20 (a)'s flagship fleet through
    ``save_state`` / ``load_state`` after 4 of 8 fleet iterations,
    bitwise equal to the unbroken fleet; save and load ms and bytes;
    (b) deployment: ``export_step`` of the flagship step and of the
    contextual one (phase 10's state at context 0), saved to a file,
    ``load_step`` and a call: S, M, G, next_idx and Q equal to the live
    ``safeopt_step``'s, K1 once and K3 once a walk round (K2 per GP and
    K4 per GP a round) through the ``torch.library`` operators, counted
    from zero around the call; its host syncs, counted under
    ``set_sync_debug_mode('warn')``, are its walk's ``while_loop``
    condition reads, two more than its rounds (PyTorch reads an exported
    loop's condition on the host before the loop, before each round and
    after the last); its median ms against the live
    ``optimize()``'s and both syncs; ``export_campaign`` of the flagship,
    8 iterations in float32 and float64, queries equal to
    ``run_safeopt_loop``'s on the same noise, ms per iteration of each;
    ``export_swarm_campaign`` of phase 19's (a) G=2 swarm, 4 iterations,
    queries bitwise equal to the eager ``run_swarmopt_loop``'s on the same
    streams; export seconds and artifact bytes of each (the five exports
    run in a child process, ``chip_smoke.py --export-to DIR``, started
    with the run, so that their tracing overlaps the build and phases
    3-20 on the host's other cores); (c) an RBF prior
    path drawn on ``examples/example_2d.py``'s grid (30 points a
    dimension), evaluated at the flagship's 1e6 points on the card in
    float64 within 1e-9 of the CPU; the draw's host ms and the
    evaluation's device ms; (d) ``profile_trace`` around one flagship
    ``optimize()``: the trace names K1's and K3's CUDA kernels.

Any failed check exits non-zero. The last lines are one JSON object of
the kernels, the nvidia-smi line, and the result line.
"""

import functools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from tools_torch.states import (BETA, LAYOUTS, build_gps, cap512_operands,
                                 cuda_ms, first_gp, fit_data, fit_kernel,
                                 one_gp, sparse_data, sparse_exact_gp,
                                 sparse_gp, swarm_data, swarm_gps,
                                 swarm_plant, swarm_problem)

BAND = 1e-3          # scaled decision band for float32 comparisons
FMIN = [0.2, 0.5]
SCALING = [math.sqrt(2.0), 1.0]
K3_SHIFTS = (0.0, 0.1, 0.3, 1.0)   # fmin raises, in units of scaling
# K4's state (250 observations, contexts over [-5, 5]) lifts unsafe
# points further: its plain predicate holds for every candidate up to a
# raise of 1.0 and turns mixed between 1.5 and 2.0
K4_SHIFTS = (0.0, 1.0, 1.5, 2.0, 2.5)
# the contextual path (bench.py _context_config / _context_measure)
CTX_FMIN = [0.2, 0.3]
CTX_SCALING = [math.sqrt(2.0), 1.0]
# the sparse path (bench.py _sparse_secondary): the objective alone
SPARSE_FMIN = [0.2]
SPARSE_SCALING = [math.sqrt(2.0)]
SPARSE_MS = (64, 100, 256)          # count == capacity at 64 and 256
# m=256's pseudo-factor (max |R| near 800, K_ZZ's condition number
# 4.7e9) puts the float32 intervals' error past the band: on an H100, 2
# of the 1e6 float32 decisions differed from float64 outside it (ROADMAP
# Queue 3 entry 10).
# Its float32 decisions are recorded, the kernel held by its float32
# bound, and one certified step is read beside them.
SPARSE_F32_RECORDED = (256,)
# the sparse states' expander predicates turn false within a few
# hundredths of the scaling: finer raises than K3_SHIFTS
SPARSE_K3_SHIFTS = (0.0, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0)
# the JAX package's recommended safety floor (README.md:36)
FLOOR = dict(conservative=0.75, calibration=0.99)
# Published peaks of one H100 SXM at 700 W: FP32 outside the tensor
# cores, FP64 likewise, and HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# dense tensor-core peaks of the same card (B4's limb formats)
PEAK_TENSOR = {"bf16": 989e12, "tf32": 495e12}
EXPERIMENT_REPS = 5


def fail(msg):
    """Stop the run with a non-zero exit and the reason."""
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    """``fail(msg)`` unless ``cond`` holds."""
    if not cond:
        fail(msg)


def context_kernel(variant=None):
    """The bench's contextual kernel, RBF on the parameter column times
    RBF on the context column. ``"extra"``: a Sum with a Bias leaf and a
    Cosine leaf on the context column; ``"nine"``: the contextual kernel
    as a product of nine leaves, five RBFs of lengthscale sqrt(5) on the
    parameter and four of lengthscale 3 on the context (the same
    function), one leaf past the plan K2/K4 stage in static shared
    memory, so that they run their wide instances."""
    from safeopt_torch import RBF, Bias, Cosine

    if variant == "extra":
        return (RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0])
                * Cosine(1, variance=1.0, lengthscale=3.0, active_dims=[1])
                + Bias(2, variance=0.5))
    if variant == "nine":
        kern = RBF(1, variance=2.0, lengthscale=math.sqrt(5.0),
                   active_dims=[0])
        for _ in range(4):
            kern = kern * RBF(1, lengthscale=math.sqrt(5.0), active_dims=[0])
        for _ in range(4):
            kern = kern * RBF(1, lengthscale=3.0, active_dims=[1])
        return kern
    return (RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0])
            * RBF(1, variance=1.0, lengthscale=1.5, active_dims=[1]))


def context_gps(n_gps, n_obs, cap, device, dtype, variant=None,
                spread=3.0):
    """``n_gps`` contextual GPs (``context_kernel(variant)``) with
    ``n_obs`` shared observations in [-spread, spread] at context 0
    (``bench.py`` ``_context_config``; for ``"extra"``, contexts uniform
    in [-1, 1])."""
    from safeopt_torch import GPRegression

    rng = np.random.default_rng(3)
    ctx = (rng.uniform(-1.0, 1.0, size=(n_obs, 1)) if variant == "extra"
           else np.zeros((n_obs, 1)))
    X = np.hstack([rng.uniform(-spread, spread, size=(n_obs, 1)), ctx])
    return [GPRegression(X, context_truth(X)[:, g:g + 1],
                         context_kernel(variant), noise_var=0.05 ** 2,
                         capacity=cap, device=device, dtype=dtype)
            for g in range(n_gps)]


def context_truth(X):
    """The contextual plant's two functions at rows (parameter,
    context): ``bench.py``'s objective and constraint, damped away from
    context 0."""
    X = np.atleast_2d(X)
    base = np.exp(-0.5 * X[:, 0] ** 2) * np.exp(-0.5 * (X[:, 1] / 1.5) ** 2)
    return np.stack([2.0 * base, 1.5 * base], axis=1)


def plant(rng, x):
    """One noisy measurement of the flagship's two functions at ``x``."""
    r2 = float(np.sum(np.asarray(x) ** 2))
    return np.array([[2.0 * math.exp(-0.5 * r2) + 0.05 * rng.normal(),
                      1.0 - 0.1 * r2 + 0.05 * rng.normal()]])


def timed_ms(fn):
    """``(fn(), milliseconds)`` between CUDA events recorded around one
    call; the stream is drained before the end event is read."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(dtype, flops, nbytes):
    """(least ms, what bounds it): the larger of ``flops`` over the
    card's peak rate for ``dtype`` and ``nbytes`` over its memory rate."""
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def plan_leaves(scales, plan):
    """``(kind, active columns)`` of each leaf of a K2/K4 plan: the
    columns where its scale row is not 0."""
    return list(zip(plan[0].tolist(), (scales != 0).sum(dim=1).tolist()))


def gram_flops(d, leaves=None):
    """Operations of one gram entry: per distance leaf a difference,
    scale, square and add on each of its active columns (a column with
    scale 0 adds exactly nothing) plus its kind's few operations, a
    transcendental counted as one; a Bias leaf is its variance. Leaves
    multiply or add: one operation each. ``leaves`` (from
    ``plan_leaves``) None is one stationary family on prescaled inputs,
    a difference, square and add per column."""
    if leaves is None:
        return 3 * d + 4
    return sum(1 if k == 5 else 4 * a + 4 for k, a in leaves) + len(leaves)


def interval_bound(dtype, G, N, d, cap, n, leaves=None):
    """Least time of K1/K2 on these inputs: per point and GP the gram of
    the n active rows, the n(n+1)/2 FMAs of the triangular product, mu
    and the sum of squares; inputs read once, the (G, 2, N) rows written
    once."""
    flops = G * N * (n * gram_flops(d, leaves) + n * (n + 1) + 4 * n + 8)
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (d * N + G * (cap * d + cap * cap + cap + 4 + 2 * N))
    return bound(dtype, flops, nbytes)


def ablation_bound(mode, dtype, G, N, d, cap, n, prescribed=False):
    """Least time of B2/B5's ``mode`` on these inputs: the least work its
    output needs, the inputs it depends on read once, the (G, 2, N) rows
    written once. ``gram_sums``: per point and GP the gram of the n
    active rows, an add and an FMA an entry; ``no_product``: the gram,
    two FMAs an entry (mu and the sum of squares) and the epilogue. Under
    ``solve_rank1`` and ``epilogue`` V is one column v times z[0] (v = Lm
    xs[:, 0], or 0.01 in every row), so mu = z[0] (w . v) and sum V^2 =
    z[0]^2 (v . v): one pass over Lm a GP (over w for ``epilogue``), then
    per point three operations and the epilogue on grid column 0 alone.
    ``prescribed`` counts for these two the work the kernel is told to do
    instead: every row of V, the rank-1 gram and the triangular product."""
    size = torch.finfo(dtype).bits // 8
    if mode == "gram_sums":
        return bound(dtype, G * N * n * (gram_flops(d) + 3),
                     size * (d * N + G * (cap * d + d + 4 + 2 * N)))
    if mode == "no_product":
        return bound(dtype, G * N * (n * (gram_flops(d) + 4) + 8),
                     size * (d * N + G * (cap * d + d + cap + 4 + 2 * N)))
    solve = mode == "solve_rank1"
    nbytes = size * (N + G * (2 * N + cap + 4
                              + (cap * cap + cap if solve else 0)))
    if prescribed:
        return bound(dtype, G * N * (n * (5 if solve else 4)
                                     + (n * (n + 1) if solve else 0) + 8),
                     nbytes)
    return bound(dtype, G * ((n * (n + 1) + 4 * n if solve else 2 * n)
                             + 11 * N), nbytes)


def split_bound(limb, N, d, cap, n, G=1, leaves=None, gram=True):
    """Least time of B4, K1-3p, K2-3p, B1-3p and B3-3p on these inputs (G
    GPs; a plan's ``leaves`` for K2-3p): the three limb products' 3
    n(n+1) flops a point on the tensor cores at the limb format's peak;
    on the FP32 pipe the gram, its split (two roundings and a difference
    an entry) and the epilogue; inputs read once, the (G, 2, N) rows
    written once. The largest of the three. ``gram`` False (B2-3p): no
    gram term, and grid and inputs read in column 0 only (the rank-1
    gram; its limbs are no rank-1 product, so the product stays)."""
    dg = d if gram else 1
    t_tc = 3 * G * N * n * (n + 1) / PEAK_TENSOR[limb]
    t_fp = (G * N * (n * ((gram_flops(d, leaves) if gram else 0) + 3)
                     + 4 * n + 8) / PEAK_FLOPS[torch.float32])
    t_mem = 4 * (dg * N + G * (cap * dg + cap * cap + cap + 4 + 2 * N)
                 ) / PEAK_BYTES
    t, by = max((t_tc, "operations"), (t_fp, "operations"),
                (t_mem, "bytes"))
    return t * 1e3, by


def band_macs(n):
    """Multiply-adds per point and GP that K1/K2 execute at count n:
    band b of 32 rows contracts over min(32 (b + 1), n) columns."""
    return sum(32 * min(32 * (b + 1), n) for b in range(-(-n // 32)))


def expander_macs(n, C, dtype):
    """Multiply-adds per point and GP that K3/K4 execute at count n: a
    pass of CW candidates (the power of two from 32 to 256 that covers C;
    passes of 256 past it) over n rounded up to one 16-byte vector."""
    cw = 32
    while cw < C and cw < 256:
        cw *= 2
    v = 16 // (torch.finfo(dtype).bits // 8)
    return -(-C // cw) * cw * (-(-n // v) * v)


def expander_bound(dtype, G, N, U, d, cap, n, C, leaves=None, masks=1):
    """Least time of K3/K4 on these inputs: at each of the U unsafe
    points (a GP's mean, with ``masks`` masks of N bytes: one per
    campaign of a fleet launch) and per GP the gram of the n active rows
    and of the C candidates, the C n FMAs of the cross term and the
    epilogue; inputs read once, the (G, C) predicate written once."""
    g = gram_flops(d, leaves)
    flops = G * U * (n * g + C * g + 2 * C * n + 12 * C)
    size = torch.finfo(dtype).bits // 8
    nbytes = (size * (d * N + G * (2 * N + cap * d + C * d + C * cap
                                   + 3 * C + 4)) + masks * N + 4 * G * C)
    return bound(dtype, flops, nbytes)


def decisions_agree(l32, l64, fmin, scaling):
    """(mismatches outside the band, rows inside the band)."""
    margin = (l64 - fmin) / scaling
    outside = margin.abs() > BAND
    wrong = ((l32 > fmin) != (l64 > fmin)) & outside
    return int(wrong.sum()), int((~outside).sum())


def flagship_gps(n_obs, cap, n_gps, seed, spread, dtype):
    """The GPs ``check_k1`` and ``check_k3`` take: ``n_obs`` is one count
    for every GP or a tuple of one per GP (GP g taken from the flagship
    pair built with that count)."""
    counts = n_obs if isinstance(n_obs, tuple) else (n_obs,) * n_gps
    return [build_gps(np.random.default_rng(seed), n, cap, "cuda", dtype,
                      spread=spread)[g] for g, n in enumerate(counts)]


def check_k1(label, n_obs, cap, n_gps, grid64, seed, spread=1.5):
    """K1 vs its plain version in f64 and f32 on ``flagship_gps``;
    returns both errors."""
    return check_k1_gps(label, {dt: flagship_gps(n_obs, cap, n_gps, seed,
                                                 spread, dt)
                                for dt in (torch.float64, torch.float32)},
                        grid64, FMIN[:n_gps], SCALING[:n_gps])


def check_k1_gps(label, gps, grid64, fmin, scaling, bounded=False,
                 gate=True):
    """K1 vs its plain version: ``gps`` {float64: GPs, float32: the same
    GPs}; float64 kernel to 1e-9 of the float64 plain version, float32
    decisions ``l > fmin`` equal outside the band. ``bounded``: the
    float32 kernel also within ``float32_bound(..., "intervals")`` of the
    plain version on its own operands, and a planted fault (each GP's
    first 32 active rows of Lm dropped) past that bound. ``gate`` False
    prints the float32 decisions without failing on them, for a state
    whose float32 arithmetic cannot hold the band (the bound holds the
    kernel there). Returns both errors."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {}
    for dtype in (torch.float64, torch.float32):
        ops = fp.interval_operands([g.kern for g in gps[dtype]],
                                   [g.state for g in gps[dtype]],
                                   grid64.to(dtype), BETA)
        out[dtype] = (fp.fused_intervals(*ops), ops)
    k64, ops64 = out[torch.float64]
    k32, ops32 = out[torch.float32]
    p64 = fp.fused_intervals_plain(*ops64)
    torch.cuda.synchronize()
    err64 = (k64 - p64).abs().max().item()
    diff32 = (k32.double() - p64).abs()
    scale = torch.tensor(scaling, dtype=torch.float64,
                         device="cuda")[:, None, None]
    err32 = diff32.max().item()
    err32_scaled = (diff32 / scale).max().item()
    fmin = torch.tensor(fmin, dtype=torch.float64, device="cuda")[:, None]
    wrong, in_band = decisions_agree(k32[:, 0].double(), p64[:, 0], fmin,
                                     scale[:, :, 0])
    print(f"K1 {label}: f64 max|kernel-plain|={err64:.3e} (limit 1e-9); "
          f"f32 max abs err={err32:.3e}, max scaled err={err32_scaled:.3e}; "
          f"f32 decisions differing outside the {BAND:g} band={wrong} "
          f"(rows inside the band: {in_band})"
          + ("" if gate else "; recorded, not held: this state's float32 "
             "arithmetic cannot hold the band"), flush=True)
    check(err64 <= 1e-9, f"K1 {label} f64 error {err64}")
    check(wrong == 0 or not gate,
          f"K1 {label} f32 decisions differ outside the band")
    if bounded:
        up = tuple(o.double() if torch.is_tensor(o) and o.is_floating_point()
                   else o for o in ops32)
        want = fp.fused_intervals_plain(*up)
        bound_ = ie.float32_bound(*ops32, "intervals")
        share = ((k32.double() - want).abs() / bound_).max().item()
        faults = fault_readings(fp.fused_intervals_plain, up, "intervals",
                                bound_)
        print(f"K1 {label} float32 against its plain version on the same "
              f"operands: at most {share:.3g} of float32_bound (limit 1); "
              f"the bound's median {bound_.median().item():.3e}; the first "
              f"32-row band dropped reads {faults[0]:.3g} x the bound (must "
              f"be past 1), the last {faults[1]:.3g} x", flush=True)
        check(share <= 1.0, f"K1 {label} f32 past its float32 bound")
        check(faults[0] > 1.0, f"K1 {label}: the float32 bound cannot see "
                               "a dropped band")
    return err64, err32


def k1_operands(n_obs, cap, n_gps, grid64, seed, spread=1.5):
    """{dtype: K1's operands} of GPs built as ``check_k1`` builds them."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {}
    for dtype in (torch.float64, torch.float32):
        gps = flagship_gps(n_obs, cap, n_gps, seed, spread, dtype)
        out[dtype] = fp.interval_operands([g.kern for g in gps],
                                          [g.state for g in gps],
                                          grid64.to(dtype), BETA)
    return out


def refine_slack():
    """``refine_band - boundary_band`` at the certified path's defaults
    (``safe_opt.REFINE_BAND``, ``SafeOpt``'s ``boundary_band``): the slack
    the three-pass error must stay under."""
    import inspect

    from safeopt_torch import SafeOpt
    from safeopt_torch.algorithms.safe_opt import REFINE_BAND

    return REFINE_BAND - inspect.signature(SafeOpt).parameters[
        "boundary_band"].default


def check_three_pass(label, ops, fmin, scale, what="split"):
    """A three-pass kernel against its plain version on ``ops`` {dtype:
    operands}: float64 to 1e-9, float32 within its float32 bound, and a
    planted fault (the plain rows with each GP's first, then last, 32
    active rows of Lm dropped) past that bound; beside them the float32
    rows' max scaled |dQ| against the float64 rows of the full-precision
    function (and the plain version's own), checked below
    ``refine_slack()``, and their decisions outside the band. ``what``:
    ``"split"`` K1-3p, ``"launch"`` B1-3p at its automatic layout (K1-3p's
    plain version), ``"plan"`` K2-3p, ``"solve_rank1"`` B2-3p (its
    |dQ| printed, not held: the rank-1 stand-in gram reaches |k| = 20,
    and its rows are no SafeOpt intervals), ``"mu_from_gram"`` B3-3p
    (against K1's rows, its function). ``fmin`` and ``scale`` per GP.
    Returns (float64 error, float32 max scaled |dQ|, the fault
    readings)."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    slack = refine_slack()
    o64, o32 = ops[torch.float64], ops[torch.float32]
    if what == "plan":
        kernel = fp.fused_intervals_plan3
        plain, full = (fp.fused_intervals_plan3_plain,
                       fp.fused_intervals_plan_plain)
        name, fault = "K2-3p", "split"
        bound_ = ie.float32_bound_plan(*o32)
    elif what in ("split", "launch"):
        kernel, plain = fp.fused_intervals3, fp.fused_intervals3_plain
        full, name, fault = fp.fused_intervals_plain, "K1-3p", "split"
        if what == "launch":
            kernel = functools.partial(ie.intervals_launch, three_pass=True)
            name = "B1-3p"
        bound_ = ie.float32_bound(*o32, "split", limb="bf16")
    else:
        if what == "mu_from_gram":
            name, kernel = "B3-3p", ie.intervals_mu_from_gram
            plain = ie.intervals_mu_from_gram_plain
            full = fp.fused_intervals_plain
        else:
            name = f"B2-3p {what}"
            kernel = functools.partial(ie.interval_ablation, mode=what)
            plain = functools.partial(ie.interval_ablation_plain, mode=what)
            full = plain
        kernel, plain = (functools.partial(f, three_pass=True)
                         for f in (kernel, plain))
        fault = what
        bound_ = ie.float32_bound(*o32, what, three_pass=True)
    err64 = (kernel(*o64) - plain(*o64)).abs().max().item()
    k32 = kernel(*o32)
    p32 = plain(*o32)
    ratio = ((k32.double() - p32.double()).abs() / bound_).max().item()
    faults = fault_readings(plain, o32, fault, bound_)
    N = o64[0].shape[1]
    ref = full(*o64).view(-1, 2, N)
    k32 = k32.view(-1, 2, N).double()
    sc = torch.tensor(scale, dtype=torch.float64, device="cuda")[:, None]
    dq = ((k32 - ref).abs() / sc[:, None]).max().item()
    dq_plain = ((p32.view(-1, 2, N).double() - ref).abs()
                / sc[:, None]).max().item()
    wrong, in_band = decisions_agree(
        k32[:, 0], ref[:, 0], torch.tensor(fmin, dtype=torch.float64,
                                           device="cuda")[:, None], sc)
    held = what != "solve_rank1"
    torch.cuda.synchronize()
    print(f"{name} {label}: f64 max|kernel-plain|={err64:.3e} (limit 1e-9); "
          f"f32 at most {ratio:.3f} of its float32 bound (limit 1), a "
          f"kernel dropping the first / last 32 active rows "
          f"{faults[0]:.4g} / {faults[1]:.4g} of it (limit: past 1); f32 "
          f"max scaled |dQ| against the float64 rows {dq:.3e} (the plain "
          f"version's own {dq_plain:.3e}; "
          + (f"limit {slack:g}" if held else "not held") +
          f"); f32 decisions differing outside the {BAND:g} band={wrong} "
          f"(rows inside the band: {in_band})", flush=True)
    check(err64 <= 1e-9, f"{name} {label} f64 error {err64}")
    check(ratio <= 1.0, f"{name} {label} f32 error past its bound")
    check(min(faults) > 1.0, f"{name} {label}: a kernel dropping a band of "
                             f"rows stays within the float32 bound {faults}")
    check(not held or dq < slack, f"{name} {label}: the three-pass error "
                                  f"{dq} is past refine_band - boundary_band")
    return err64, dq, faults


def check_k3(label, n_obs, cap, n_gps, grid64, seed, spread=1.5):
    """``check_k3_gps`` on ``flagship_gps``."""
    return check_k3_gps(label, *(flagship_gps(n_obs, cap, n_gps, seed,
                                              spread, dt)
                                 for dt in (torch.float64, torch.float32)),
                        grid64, FMIN[:n_gps], SCALING[:n_gps])


def check_k3_gps(label, gps64, gps32, grid64, fmin, scaling,
                 shifts=K3_SHIFTS, gate=True):
    """K3 vs its plain version in f64 and f32 on one chunk of 32
    candidates of ``gps64`` and ``gps32`` (the same GPs): the first 16 in
    visit order and 16 from the middle of it, with the last 4 slots
    padding (valid=False). The candidates are the expander candidates,
    or the safe points where there are fewer than 64 of those (as
    ``compute_sets(full_sets=True)`` tests every safe point). It runs at
    fmin raised by each of ``shifts`` times the scaling, so that the
    plain predicate is false for some valid candidates; the check fails
    unless some launch holds both values. ``gate`` False prints the
    float32 predicates without failing on them (``check_k1_gps``).
    Returns the f64 error and the float32 operands at the path's fmin."""
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.ops import fused_expander as fe

    n_gps = len(gps64)
    f64 = torch.tensor(fmin, dtype=torch.float64, device="cuda")
    s64 = torch.tensor(scaling, dtype=torch.float64, device="cuda")
    kerns = [g.kern for g in gps64]
    Q, mu, sigma = core._confidence_intervals(
        kerns, [g.state for g in gps64], grid64, BETA)
    S, _, cand, width, _ = core._classify(
        Q, f64, s64, torch.zeros(n_gps, dtype=torch.float64, device="cuda"),
        BETA)
    pool = cand if int(cand.sum()) >= 64 else S
    n_cand = int(pool.sum())
    check(n_cand >= 64, f"K3 {label}: only {n_cand} safe points")
    order = core._visit_order(torch.where(pool, width, float("-inf")),
                              n_cand)
    gidx = torch.cat([order[:16], order[n_cand // 2:n_cand // 2 + 16]])
    valid = torch.ones(32, dtype=torch.bool, device="cuda")
    valid[-4:] = False
    args = (grid64, ~S, mu, sigma, grid64[gidx], Q[gidx][:, 1::2].T.clone(),
            valid, BETA, f64)
    ops64 = fe.expander_operands(kerns, [g.state for g in gps64], *args)
    ops32 = fe.expander_operands(
        [g.kern for g in gps32], [g.state for g in gps32],
        *[a.float() if torch.is_tensor(a) and a.is_floating_point() else a
          for a in args])

    def at(ops, delta):          # the operands at fmin + delta * scaling
        scal = ops[9].clone()
        scal[:, 3] += delta * s64.to(scal.dtype)
        return ops[:9] + (scal, ops[10])

    err64, wrong64, wrong32, in_band, mixed, pad_hits = 0.0, 0, 0, 0, 0, 0
    counts = []
    for delta in shifts:
        plain = fe.fused_expander_plain(*at(ops64, delta))
        k64 = fe.fused_expander(*at(ops64, delta))
        k32 = fe.fused_expander(*at(ops32, delta))
        decided = (fe.fused_expander_plain(*at(ops64, delta + BAND))
                   == fe.fused_expander_plain(*at(ops64, delta - BAND)))
        torch.cuda.synchronize()
        hits = int(plain[:, valid].sum())
        counts.append(hits)
        mixed += 0 < hits < plain[:, valid].numel()
        pad_hits += int(k64[:, ~valid].sum() + k32[:, ~valid].sum())
        err64 = max(err64, (k64 != plain).float().max().item())
        wrong64 += int((k64 != plain).sum())
        wrong32 += int(((k32 != plain) & decided).sum())
        in_band += int((~decided).sum())
    print(f"K3 {label} C=32 (16 head + 16 mid-order of {n_cand} "
          f"{'candidates' if pool is cand else 'safe points'}, 4 pad "
          f"slots) at fmin + {list(shifts)} x scaling: plain hits per "
          f"shift {counts} of {n_gps * int(valid.sum())} valid; f64 "
          f"predicates differing={wrong64} (limit 0); f32 differing outside "
          f"the band={wrong32}, inside the band={in_band}; hits in pad "
          f"slots={pad_hits}", flush=True)
    check(mixed > 0, f"no K3 {label} launch had a plain predicate holding "
                     "both values, so the check cannot see a wrong hit")
    check(pad_hits == 0, f"K3 {label} reported a hit in a padding slot")
    check(wrong64 == 0, f"K3 {label} f64 predicate differs from its plain "
                        "version")
    if not gate and wrong32:
        print(f"K3 {label}: the float32 predicates differing outside the "
              f"band are recorded, not held (as K1's decisions)", flush=True)
    check(wrong32 == 0 or not gate,
          f"K3 {label} f32 predicate differs outside the band")
    return err64, ops32


def check_k2(label, n_obs, cap, grid64, variant=None):
    """K2 vs its plain version in f64 and f32 on one contextual GP
    (``context_kernel(variant)``); returns the f64 error and the float32
    operands."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {}
    for dtype in (torch.float64, torch.float32):
        gp = context_gps(1, n_obs, cap, "cuda", dtype, variant=variant)[0]
        ops = fp.interval_plan_operands(gp.kern, gp.state, grid64.to(dtype),
                                        BETA)
        out[dtype] = (fp.fused_intervals_plan(*ops), ops)
    k64, ops64 = out[torch.float64]
    k32, ops32 = out[torch.float32]
    p64 = fp.fused_intervals_plan_plain(*ops64)
    torch.cuda.synchronize()
    err64 = (k64 - p64).abs().max().item()
    scale = math.sqrt(float(ops64[7][1]))          # prior std, sqrt(kdiag)
    diff32 = (k32.double() - p64).abs()
    wrong, in_band = decisions_agree(k32[0].double(), p64[0], CTX_FMIN[0],
                                     scale)
    print(f"K2 {label}: plan kinds/terms {ops64[6].tolist()}; f64 "
          f"max|kernel-plain|={err64:.3e} (limit 1e-9); f32 max abs err="
          f"{diff32.max().item():.3e}, max scaled err="
          f"{diff32.max().item() / scale:.3e}; f32 decisions differing "
          f"outside the {BAND:g} band={wrong} (rows inside the band: "
          f"{in_band})", flush=True)
    check(err64 <= 1e-9, f"K2 {label} f64 error {err64}")
    check(wrong == 0, f"K2 {label} f32 decisions differ outside the band")
    return err64, ops32


def check_k4(grid64, variant=None):
    """K4 vs its plain version in f64 and f32, as ``check_k3``: the two
    contextual GPs (``context_kernel(variant)``) at capacity 256 with 250
    observations, one chunk of
    32 candidates (16 from the head of the visit order, 16 from its
    middle, the last 4 slots padding) at fmin raised by each of
    ``K4_SHIFTS`` times the scaling. The candidates are safe points in
    the walk's order (width descending): on this state every wide safe
    point is also a potential maximizer, so the expander candidates
    proper are empty, and the predicate takes any safe point, as
    ``compute_sets(full_sets=True)`` does. Returns the f64 error and the
    float32 operands of GP 0 at the path's fmin."""
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.ops import fused_expander as fe

    f64 = torch.tensor(CTX_FMIN, dtype=torch.float64, device="cuda")
    s64 = torch.tensor(CTX_SCALING, dtype=torch.float64, device="cuda")
    gps = {dt: context_gps(2, 250, 256, "cuda", dt, variant=variant)
           for dt in (torch.float64, torch.float32)}
    kerns = [g.kern for g in gps[torch.float64]]
    states = [g.state for g in gps[torch.float64]]
    Q, mu, sigma = core._confidence_intervals(kerns, states, grid64, BETA)
    S, _, _, width, _ = core._classify(
        Q, f64, s64, torch.zeros(2, dtype=torch.float64, device="cuda"),
        BETA)
    n_cand = int(S.sum())
    check(n_cand >= 64, f"only {n_cand} contextual safe points")
    order = core._visit_order(torch.where(S, width, float("-inf")), n_cand)
    gidx = torch.cat([order[:16], order[n_cand // 2:n_cand // 2 + 16]])
    valid = torch.ones(32, dtype=torch.bool, device="cuda")
    valid[-4:] = False

    def operands(i, dt):
        g = gps[dt][i]
        args = (grid64, ~S, mu[i], sigma[i], grid64[gidx], Q[gidx, 2 * i + 1],
                valid, BETA, f64[i])
        return fe.expander_plan_operands(
            g.kern, g.state, *[a.to(dt) if torch.is_tensor(a)
                               and a.is_floating_point() else a
                               for a in args])

    def at(ops, i, delta):      # the operands at fmin + delta * scaling
        scal = ops[11].clone()
        scal[3] += delta * CTX_SCALING[i]
        return ops[:11] + (scal,)

    wrong64 = wrong32 = in_band = mixed = pad_hits = 0
    counts = []
    for i in range(2):
        ops64, ops32 = operands(i, torch.float64), operands(i, torch.float32)
        if i == 0:
            ops32_gp0 = ops32
        for delta in K4_SHIFTS:
            plain = fe.fused_expander_plan_plain(*at(ops64, i, delta))
            k64 = fe.fused_expander_plan(*at(ops64, i, delta))
            k32 = fe.fused_expander_plan(*at(ops32, i, delta))
            decided = (
                fe.fused_expander_plan_plain(*at(ops64, i, delta + BAND))
                == fe.fused_expander_plan_plain(*at(ops64, i, delta - BAND)))
            torch.cuda.synchronize()
            hits = int(plain[valid].sum())
            counts.append(hits)
            mixed += 0 < hits < int(valid.sum())
            pad_hits += int(k64[~valid].sum() + k32[~valid].sum())
            wrong64 += int((k64 != plain).sum())
            wrong32 += int(((k32 != plain) & decided).sum())
            in_band += int((~decided).sum())
    print(f"K4 2 GPs cap=256{' ' + variant if variant else ''} C=32 (16 head "
          f"+ 16 mid-order of {n_cand} safe points, 4 pad slots) at fmin + {list(K4_SHIFTS)} x scaling: "
          f"plain hits per GP and shift {counts} of {int(valid.sum())} "
          f"valid; f64 predicates differing={wrong64} (limit 0); f32 "
          f"differing outside the band={wrong32}, inside the band="
          f"{in_band}; hits in pad slots={pad_hits}", flush=True)
    check(mixed > 0, "no K4 launch had a plain predicate holding both "
                     "values, so the check cannot see a wrong hit")
    check(pad_hits == 0, "K4 reported a hit in a padding slot")
    check(wrong64 == 0, "K4 f64 predicate differs from its plain version")
    check(wrong32 == 0, "K4 f32 predicate differs outside the band")
    return float(wrong64 > 0), ops32_gp0


def zero_launches():
    """Set every kernel's launch count to 0."""
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    for fn in (fp.fused_intervals, fe.fused_expander,
               fp.fused_intervals_plan, fe.fused_expander_plan,
               fp.fused_intervals3, fp.fused_intervals_plan3,
               ie.intervals_launch, ie.interval_ablation,
               ie.intervals_mu_from_gram, ie.intervals_split):
        fn.launches = 0
    for fn in (ie.intervals_launch, ie.interval_ablation,
               ie.intervals_mu_from_gram):
        fn.three_pass_launches = 0
    for counts in (ie.interval_ablation.mode_launches,
                   ie.intervals_split.limb_launches):
        counts.update(dict.fromkeys(counts, 0))


def experiment_launches():
    """Each experiment kernel's launch count, by its kernels-line name."""
    from safeopt_torch.ops import interval_experiments as ie

    modes = ie.interval_ablation.mode_launches
    limbs = ie.intervals_split.limb_launches
    return {"B1": ie.intervals_launch.launches,
            "B2 gram_sums": modes["gram_sums"],
            "B2 solve_rank1": modes["solve_rank1"],
            "B3": ie.intervals_mu_from_gram.launches,
            "B4 bf16": limbs["bf16"], "B4 tf32": limbs["tf32"],
            "B5 no_product": modes["no_product"],
            "B5 epilogue": modes["epilogue"],
            "B1-3p": ie.intervals_launch.three_pass_launches,
            "B2-3p solve_rank1": ie.interval_ablation.three_pass_launches,
            "B3-3p": ie.intervals_mu_from_gram.three_pass_launches}


def read_launches():
    """Every kernel's launch count."""
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp

    return {"K1": fp.fused_intervals.launches,
            "K3": fe.fused_expander.launches,
            "K2": fp.fused_intervals_plan.launches,
            "K4": fe.fused_expander_plan.launches,
            "K1-3p": fp.fused_intervals3.launches,
            "K2-3p": fp.fused_intervals_plan3.launches}


def fault_readings(plain, ops, what, bound_):
    """How far past ``bound_`` a kernel whose rows are ``plain``'s with
    each GP's first, and then last, 32 active rows dropped lands: max
    |fault - plain| / bound over the outputs, for each (past 1: the
    float32 check fails it)."""
    from safeopt_torch.ops import interval_experiments as ie

    want = plain(*ops).double()
    return [((plain(*ie.drop_band(ops, what, first)).double() - want).abs()
             / bound_).max().item() for first in (True, False)]


def check_experiments(label, ops64, ops32):
    """B1-B5 and B1-3p-B3-3p against their plain versions on K1's
    operands of one state in float64 and float32, and how each float32
    bound compares with the rows and with a planted fault. Returns
    {kernels-line name: max abs error} (float64; B4's float32 against its
    plain version)."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    f32, f64 = torch.float32, torch.float64
    cap = ops64[2].shape[1]
    for ops in (ops64, ops32):
        k1 = fp.fused_intervals(*ops)
        for slices, res, carveout in LAYOUTS[cap][ops[0].dtype]:
            got = ie.intervals_launch(*ops, slices=slices, res=res,
                                      carveout=carveout)
            check(torch.equal(got, k1),
                  f"B1 {label} {ops[0].dtype} slices={slices} res={res} "
                  f"carveout={carveout} differs from K1")
    print(f"B1 {label}: K1's bits at every launch layout, float64 and "
          f"float32", flush=True)
    # every layout of LAYOUTS fits the card (B1 ran them all, with the
    # same shared memory): a raise here is B1-3p's own and fails. B1-3p
    # keeps the mma.sync body that K1-3p ran before its wgmma redesign,
    # whose sums run in another order: its bits at every layout are its
    # own at the automatic layout, and its rows are held against the
    # plain version below
    for ops in (ops64, ops32):
        auto = ie.intervals_launch(*ops, three_pass=True)
        for slices, res, carveout in LAYOUTS[cap][ops[0].dtype]:
            where = (f"B1-3p {label} {ops[0].dtype} slices={slices} "
                     f"res={res} carveout={carveout}")
            try:
                got = ie.intervals_launch(*ops, slices=slices, res=res,
                                          carveout=carveout, three_pass=True)
            except RuntimeError as err:
                fail(f"{where} raised: {err}")
            check(torch.equal(got, auto),
                  f"{where} differs from B1-3p at the automatic layout")
    print(f"B1-3p {label}: its automatic layout's bits at every launch "
          f"layout ({len(LAYOUTS[cap][f32])} float32, "
          f"{len(LAYOUTS[cap][f64])} float64)", flush=True)
    # B5 takes GP 0 alone, as its harness does (GP 1's prior variance, 1,
    # is all of sum V^2 at the grid's edge under ``epilogue``: sqrt would
    # magnify a last-bit difference there)
    both, gp0 = (ops64, ops32), (first_gp(ops64), first_gp(ops32))
    runs = {"B2 gram_sums": ("gram_sums", both),
            "B2 solve_rank1": ("solve_rank1", both),
            "B5 no_product": ("no_product", gp0),
            "B5 epilogue": ("epilogue", gp0), "B3": ("mu_from_gram", both)}
    errs = {"B1": 0.0}   # K1's bits
    for name, (what, (o64, o32)) in runs.items():
        if what == "mu_from_gram":
            kernel, plain = (ie.intervals_mu_from_gram,
                             ie.intervals_mu_from_gram_plain)
        else:
            kernel = functools.partial(ie.interval_ablation, mode=what)
            plain = functools.partial(ie.interval_ablation_plain, mode=what)
        up = tuple(o.double() if torch.is_tensor(o) else o for o in o32)
        err64 = (kernel(*o64) - plain(*o64)).abs().max().item()
        want = plain(*up)
        err32 = (kernel(*o32).double() - want).abs()
        lim = ie.float32_bound(*o32, what)
        ratio = (err32 / lim).max().item()
        first, last = fault_readings(plain, up, what, lim)
        print(f"{name} {label}: f64 max|kernel-plain|={err64:.3e} (limit "
              f"1e-9); f32 max abs err={err32.max().item():.3e}, at most "
              f"{ratio:.3f} of float32_bound (limit 1); the bound's median "
              f"{lim.median().item():.3e} against the rows' median |.| "
              f"{want.abs().median().item():.3e}; the first 32-row band "
              f"dropped reads {first:.3g} x the bound (must be past 1), "
              f"the last {last:.3g} x", flush=True)
        check(err64 <= 1e-9, f"{name} {label} f64 error {err64}")
        check(ratio <= 1.0, f"{name} {label} f32 error past its bound")
        check(first > 1.0, f"{name} {label}: float32_bound hides a dropped "
                           "band")
        errs[name] = err64
    ref = fp.fused_intervals_plain(*ops64)
    scale = torch.tensor(SCALING, dtype=torch.float64, device="cuda")
    k1_dq = ((fp.fused_intervals(*ops32).double() - ref).abs()
             / scale[:, None, None]).max().item()
    for limb in ie.LIMBS:
        err, ratio, dq, lo_fault = 0.0, 0.0, 0.0, 0.0
        first, last, lims, rows = math.inf, math.inf, [], []
        for g in range(ops32[2].shape[0]):
            one = one_gp(ops32, g)
            got = ie.intervals_split(*one, limb=limb)
            check(torch.equal(got, ie.intervals_split(
                *one, limb=limb, limbs=ie.split_factor(one[3], limb))),
                  f"B4 {limb} {label}: in-kernel and hoisted limbs differ")
            plain = functools.partial(ie.intervals_split_plain, limb=limb)
            want = plain(*one)
            lim = ie.float32_bound(*one, "split", limb=limb)
            lims.append(lim)
            rows.append(want.double().abs())
            diff = (got.double() - want.double()).abs()
            err = max(err, diff.max().item())
            ratio = max(ratio, (diff / lim).max().item())
            dq = max(dq, (got.double() - ref[g]).abs().max().item()
                     / SCALING[g])
            readings = fault_readings(plain, one, "split", lim)
            first, last = min(first, readings[0]), min(last, readings[1])
            unrounded = plain(*one, round_lo=False)
            lo_fault = max(lo_fault, ((unrounded.double() - want.double())
                                      .abs() / lim).max().item())
        print(f"B4 {limb} {label}: in-kernel == hoisted bitwise; max abs "
              f"err against its plain version={err:.3e}, at most "
              f"{ratio:.3f} of float32_bound (limit 1); the bound's median "
              f"{torch.cat(lims).median().item():.3e} against the rows' "
              f"median |.| {torch.cat(rows).median().item():.3e}; max "
              f"scaled |dQ| against float64 {dq:.3e} (K1 float32: "
              f"{k1_dq:.3e}); per "
              f"GP the first 32-row band dropped reads at least {first:.3g} "
              f"x the bound (must be past 1), the last {last:.3g} x, lo "
              f"left unrounded at most {lo_fault:.3g} x", flush=True)
        check(ratio <= 1.0, f"B4 {limb} {label} error past its bound")
        check(first > 1.0, f"B4 {limb} {label}: float32_bound hides a "
                           "dropped band")
        errs[f"B4 {limb}"] = err
    for name, what in (("B1-3p", "launch"),
                       ("B2-3p solve_rank1", "solve_rank1"),
                       ("B3-3p", "mu_from_gram")):
        errs[name] = check_three_pass(label, {f64: ops64, f32: ops32}, FMIN,
                                      SCALING, what=what)[0]
    return errs


def drive(opt, ref, label, plant_fn, contexts, scaling, get_max):
    """Run ``opt`` for ``len(contexts)`` iterations and check the first
    query against ``ref`` (the float64 plain path on the CPU, already
    stepped once at ``contexts[0]``). Returns (launches, optimize ms,
    add ms, walk chunks, get_maximum result)."""
    idx_ref = ref.stats.last.next_index
    kw = (lambda c: {}) if contexts[0] is None else (lambda c: {"context": c})
    zero_launches()
    opt_ms, add_ms, walked = [], [], 0
    for it, c in enumerate(contexts):
        x, ms = timed_ms(lambda: opt.optimize(**kw(c)))
        opt_ms.append(ms)
        last = opt.stats.last
        check(last.safe_count > 0, f"{label}: empty safe set at {it}")
        walked += last.walk_chunks
        if it == 0:
            idx0 = last.next_index
            w = (ref.Q[:, 1::2] - ref.Q[:, 0::2]) / np.asarray(scaling)
            gap = abs(w[idx0].max() - w[idx_ref].max())
            print(f"{label} first query: port f32 index {idx0}, f64 plain "
                  f"index {idx_ref}, scaled-width gap {gap:.3e}", flush=True)
            check(idx0 == idx_ref or gap <= BAND,
                  f"{label}: first query differs from the float64 plain "
                  "path")
        y = plant_fn(x, c)
        add_ms.append(timed_ms(
            lambda: opt.add_new_data_point(x, y, **kw(c)))[1])
    maximum = get_max()
    torch.cuda.synchronize()
    launches = read_launches()
    check(maximum is not None and np.all(np.isfinite(maximum[0])),
          f"{label}: get_maximum returned no point")
    return launches, opt_ms, add_ms, walked, maximum


def drive_certified(label, make, plant_fn, contexts, iters=10,
                    min_refined=0):
    """The certified path of ``make(device, dtype, **kw)`` in float32
    with ``oracle`` host and device, each for ``iters`` iterations in
    lockstep with float64 and float32 plain twins on the card (the
    certified query and measurement are added to all three); at least
    ``min_refined`` of the steps must refine their band within the
    budget (the others take the full float32 pass). Returns {oracle: (summed launches of the
    certified optimize() calls, its optimize() ms, the float32 plain
    twin's ms, rows below the 1e-9 margin, queries that differed)}."""
    out = {}
    for oracle in ("host", "device"):
        cert = make("cuda", torch.float32, exact_boundaries=True,
                    interval_precision="high", oracle=oracle)
        f64 = make("cuda", torch.float64)
        plain = make("cuda", torch.float32)
        kw = (lambda c: {}) if contexts[0] is None else (
            lambda c: {"context": c})
        launches, ms, plain_ms, knife, differ, full = {}, [], [], 0, 0, 0
        pops = []
        fmin = np.asarray(cert.fmin, dtype=float)
        scaling = np.asarray(cert.scaling, dtype=float)
        for it in range(iters):
            c = contexts[it]
            zero_launches()
            x, t = timed_ms(lambda: cert.optimize(**kw(c)))
            for k, v in read_launches().items():
                launches[k] = launches.get(k, 0) + v
            check(not any(experiment_launches().values()),
                  f"{label} {oracle}: the certified path launched an "
                  "experiment kernel")
            ms.append(t)
            full += cert.stats.last.refine_full_pass
            pops.append(cert._refine_band_population)
            f64.optimize(**kw(c))
            plain_ms.append(timed_ms(lambda: plain.optimize(**kw(c)))[1])
            l64 = f64.Q[:, 0::2]
            margin = np.min(np.abs(l64 - fmin) / scaling, axis=1)
            far = margin >= 1e-9
            knife += int((~far).sum())
            bad = int((cert.S[far] != f64.S[far]).sum())
            check(bad == 0, f"{label} {oracle} iteration {it}: {bad} "
                            "certified safe bits differ from float64")
            i, j = cert.stats.last.next_index, f64.stats.last.next_index
            w = np.max((f64.Q[:, 1::2] - l64) / scaling, axis=1)
            check(i == j or abs(w[i] - w[j]) <= BAND,
                  f"{label} {oracle} iteration {it}: query {i} against "
                  f"float64 {j}, scaled widths {w[i]} and {w[j]}")
            differ += i != j
            y = plant_fn(x, c)
            for opt in (cert, f64, plain):
                opt.add_new_data_point(x, y, **kw(c))
        last = cert.stats.last
        print(f"{label} certified path, oracle={oracle}: {iters} iterations "
              f"in lockstep with float64; S equal at every row with scaled "
              f"margin >= 1e-9 (rows below it over the run: {knife}); "
              f"queries differing within the width band: {differ}; last "
              f"step |S|={last.safe_count}, band rows "
              f"{last.band_population}, corrections "
              f"{last.certified_corrections}, triage overflow "
              f"{last.band_overflow}, refine band rows per step {pops} "
              f"(budget {cert._refine_band_k + cert._refine_k}; steps past "
              f"it, recomputed at full float32: {full}); launches "
              f"{launches}", flush=True)
        check(iters - full >= min_refined,
              f"{label} {oracle}: {iters - full} steps refined their band "
              f"within the budget, fewer than {min_refined}")
        out[oracle] = (launches, ms, plain_ms, knife, differ)
    return out


def mixed_gps(device, dtype):
    """The flagship's GPs and data with GP 1's kernel RBF(variance 1,
    lengthscale 1.5) + White(1e-2): GP 0 takes K1/K3, GP 1 the eager
    route."""
    from safeopt_torch import RBF, GPRegression, White

    gps = build_gps(np.random.default_rng(0), 50, 64, device, dtype)
    kern = RBF(2, variance=1.0, lengthscale=1.5) + White(2, variance=1e-2)
    return [gps[0], GPRegression(gps[1].X_host, gps[1].Y_host, kern,
                                 noise_var=0.05 ** 2, capacity=64,
                                 device=device, dtype=dtype)]


def widths_agree(opt64, i, j, scaling):
    """Whether grid rows i and j have scaled widths within the band in
    ``opt64``'s current intervals."""
    w = np.max((opt64.Q[:, 1::2] - opt64.Q[:, 0::2]) / np.asarray(scaling),
               axis=1)
    return i == j or abs(w[i] - w[j]) <= BAND


def drive_mixed(grid_np):
    """Phase 13: the flagship with GP 1 on the eager route, float32 in
    lockstep with float64 on the card. Returns (the float32 optimize()
    ms, the eager route's ms per step)."""
    from safeopt_torch import SafeOpt
    from safeopt_torch.algorithms import safe_opt_core as core

    def make(dtype):
        return SafeOpt(mixed_gps("cuda", dtype), grid_np, fmin=FMIN,
                       beta=BETA, scaling=SCALING, expander_chunk=32)

    f32, f64 = make(torch.float32), make(torch.float64)
    routes = [r for _, r in core._gp_groups(
        [g.kern for g in f32.gps], [g.state for g in f32.gps], 2)]
    check(routes == ["batched", "eager"], f"mixed routes {routes}")
    rng = np.random.default_rng(7)

    def first(f64):
        rows = 10_000
        mu, var = f64.gps[1]._host.predict(grid_np[:rows])
        want = np.stack([mu - BETA * np.sqrt(var),
                         mu + BETA * np.sqrt(var)], axis=1)
        err = float(np.abs(f64.Q[:rows, 2:4] - want).max())
        print(f"mixed routes, first step: float64 eager rows of GP 1 "
              f"against the host factor's predict on {rows} rows: max "
              f"|dQ| {err:.3e} (limit 1e-9)", flush=True)
        check(err <= 1e-9, f"eager rows off the host factor by {err}")

    launches, ms, _, stats = lockstep("mixed routes", f32, f64,
                                      lambda x: plant(rng, x), first=first)
    walked = sum(st.walk_chunks for st in stats)
    check(all(st.eager_gps == 1 for st in stats),
          f"mixed steps' eager GPs {[st.eager_gps for st in stats]}")
    check(launches["K1"] == 10 and launches["K3"] == walked,
          f"mixed path: K1 {launches['K1']} (want 10), K3 {launches['K3']} "
          f"(want one a walk chunk, {walked})")
    check(all(launches[k] == 0 for k in ("K2", "K4", "K1-3p", "K2-3p")),
          f"mixed path launched a kernel off GP 0's route: {launches}")
    # the eager route's work in a step: GP 1's posterior and its
    # predicate on one chunk of 32 candidates, timed alone
    kernels = tuple(g.kern for g in f32.gps)
    states = tuple(g.state for g in f32.gps)
    grid = f32._grid()
    mu, var, V = core._eager_posterior(kernels[1], states[1], grid)
    eager_ms = cuda_ms(lambda: core._eager_posterior(kernels[1], states[1],
                                                     grid), reps=5)
    Xc = grid[:32]
    pred_ms = cuda_ms(lambda: core._eager_predicate(
        kernels[1], states[1], grid, ~f32._dev.S, mu, torch.sqrt(var), V,
        Xc, mu[:32] + 1.0, FMIN[1], BETA), reps=5)
    step_eager = eager_ms + pred_ms * walked / 10
    med = float(np.median(ms[1:]))
    print(f"mixed routes times (CUDA events, iterations 2-10): median "
          f"optimize() {med:.3f} ms; GP 1's eager posterior "
          f"{eager_ms:.4f} ms and eager predicate {pred_ms:.4f} ms a chunk, "
          f"{step_eager:.3f} ms a step: {step_eager / med:.1%} of it",
          flush=True)
    return ms, step_eager


def check_sparse_kernels(grid64):
    """Phase 16.1: K1 and K3 on the sparse pseudo-factor states of
    ``sparse_gp(m)`` for m in ``SPARSE_MS``, as ``check_k1_gps`` and
    ``check_k3_gps`` hold them, with R's strict upper triangle zero on the
    card and ``max |R|`` printed. Returns {m: (K1 f64 error, K3 f64
    error)}."""
    from safeopt_torch.gp.regression import gp_predict

    data = sparse_data()
    errs = {}
    for m in SPARSE_MS:
        gps = {dt: [sparse_gp(m, "cuda", dt, data)]
               for dt in (torch.float64, torch.float32)}
        gp = gps[torch.float64][0]
        cap, count = gp.state.capacity, int(gp.state.count)
        upper = max(float(torch.triu(g[0].state.Linv, 1).abs().max())
                    for g in gps.values())
        r_max = float(np.abs(gp._R).max())
        # the device state's mean V^T w against the DTC mean k^T alpha
        # that predict_f64 and the oracles use (ROADMAP Queue 3 entry 8)
        rows = grid64[::100]
        mu_dev = gp_predict(gp.kern, gp.state, rows)[0].cpu().numpy()
        mu_gap = float(np.abs(mu_dev - gp.predict_f64(
            rows.cpu().numpy())[0]).max())
        label = f"sparse m={m} (capacity {cap}, count {count})"
        print(f"{label}: max |R| {r_max:.6g}; largest |entry| of the strict "
              f"upper triangle of R on the card {upper} (limit 0); float64 "
              f"mean of the state (V^T w) against predict_f64's (k^T "
              f"alpha) on {rows.shape[0]} grid rows: max gap {mu_gap:.3e}",
              flush=True)
        check(upper == 0.0, f"{label}: the pseudo-factor is not lower "
                            "triangular on the card")
        gate = m not in SPARSE_F32_RECORDED
        k1_err, _ = check_k1_gps(label, gps, grid64, SPARSE_FMIN,
                                 SPARSE_SCALING, bounded=True, gate=gate)
        k3_err, _ = check_k3_gps(label, gps[torch.float64],
                                 gps[torch.float32], grid64, SPARSE_FMIN,
                                 SPARSE_SCALING, SPARSE_K3_SHIFTS, gate=gate)
        errs[m] = (k1_err, k3_err)
        if not gate:
            certified_reading(label, gps, grid64)
    return errs


def certified_reading(label, gps, grid64):
    """One certified step (three-pass, device oracle) of the float32
    sparse model beside a float64 plain step of the same model on the
    card, and the model's float64 truth (``predict_f64``, mu = k^T
    alpha): how many safe bits the certified step and the float64 plain
    step give against that truth at rows whose float64 margin is at
    least 1e-9. Printed, not held."""
    from safeopt_torch import SafeOpt

    grid_np = grid64.cpu().numpy()
    kw = dict(fmin=SPARSE_FMIN, beta=BETA, scaling=SPARSE_SCALING,
              expander_chunk=32)
    cert = SafeOpt(gps[torch.float32], grid_np, exact_boundaries=True,
                   interval_precision="high", oracle="device", **kw)
    plain = SafeOpt(gps[torch.float64], grid_np, **kw)
    cert.optimize()
    plain.optimize()
    gp = gps[torch.float64][0]
    truth = np.empty(grid_np.shape[0], dtype=bool)
    margin = np.empty(grid_np.shape[0])
    for s in range(0, grid_np.shape[0], 100_000):
        mu, var = gp.predict_f64(grid_np[s:s + 100_000])
        lb = mu - BETA * np.sqrt(var)
        truth[s:s + 100_000] = lb > SPARSE_FMIN[0]
        margin[s:s + 100_000] = np.abs(lb - SPARSE_FMIN[0]) / SPARSE_SCALING[0]
    far = margin >= 1e-9
    last = cert.stats.last
    print(f"{label}, one certified step (float32, device oracle) against "
          f"the model's float64 truth (predict_f64) at rows with margin >= "
          f"1e-9: {int((cert.S[far] != truth[far]).sum())} safe bits "
          f"differ; the float64 plain step's: "
          f"{int((plain.S[far] != truth[far]).sum())}; the certified "
          f"step's against the float64 plain step's: "
          f"{int((cert.S[far] != plain.S[far]).sum())}; band rows "
          f"{last.band_population}, corrections "
          f"{last.certified_corrections}, refine band rows "
          f"{cert._refine_band_population}", flush=True)


def lockstep(label, f32, f64, plant_fn, iters=10, first=None):
    """``iters`` steps of ``f32`` in lockstep with its float64 twin on the
    card (the float32 query and its measurement added to both): S equal
    outside the band, the query the float64 query or within the width
    band. ``first(f64)``, when given, runs after the twin's first step.
    Returns (summed launches of the float32 optimize() calls, their ms,
    the add_new_data_point() ms, each step's ``IterationStats``)."""
    fmin, scaling = np.asarray(f32.fmin), np.asarray(f32.scaling)
    launches, opt_ms, add_ms, stats, knife, differ = {}, [], [], [], 0, 0
    for it in range(iters):
        zero_launches()
        x, t = timed_ms(f32.optimize)
        for k, v in read_launches().items():
            launches[k] = launches.get(k, 0) + v
        check(not any(experiment_launches().values()),
              f"{label} launched an experiment kernel")
        opt_ms.append(t)
        last = f32.stats.last
        stats.append(last)
        f64.optimize()
        if it == 0 and first is not None:
            first(f64)
        l64 = f64.Q[:, 0::2]
        far = np.min(np.abs(l64 - fmin) / scaling, axis=1) >= BAND
        knife += int((~far).sum())
        bad = int((f32.S[far] != f64.S[far]).sum())
        check(bad == 0, f"{label} step {it}: {bad} safe bits differ from "
                        "float64 outside the band")
        i, j = last.next_index, f64.stats.last.next_index
        check(widths_agree(f64, i, j, scaling),
              f"{label} step {it}: query {i} against float64 {j}")
        differ += i != j
        y = plant_fn(x)
        add_ms.append(timed_ms(lambda: f32.add_new_data_point(x, y))[1])
        f64.add_new_data_point(x, y)
    print(f"{label}: {iters} float32 iterations in lockstep with float64 on "
          f"the card; S equal outside the band (rows inside it over the "
          f"run: {knife}); queries differing within the width band: "
          f"{differ}; |S| last={f32.stats.last.safe_count}; launches "
          f"{launches}; walk chunks {sum(st.walk_chunks for st in stats)}; "
          f"eager GPs per step {[st.eager_gps for st in stats]}; host syncs "
          f"per step {[st.host_syncs for st in stats]}", flush=True)
    return launches, opt_ms, add_ms, stats


def drive_sparse(grid_np, grid64):
    """Phase 16.2-16.5: SafeOpt on the m=64 sparse model (plain, with the
    recommended floor, certified with the device oracle's 'sparse' kind),
    the drift against the exact GP on the same data, and the times.
    Returns {path: (launches, optimize ms, add ms)} and the certified
    runs."""
    from safeopt_torch import SafeOpt
    from safeopt_torch.algorithms import safe_opt_core as core

    data = sparse_data()

    def make(dtype, floor=False, **kw):
        gp = sparse_gp(64, "cuda", dtype, data, **(FLOOR if floor else {}))
        return SafeOpt(gp, grid_np, fmin=SPARSE_FMIN, beta=BETA,
                       scaling=SPARSE_SCALING, expander_chunk=32, **kw)

    rng = np.random.default_rng(16)

    def objective(x):
        return plant(rng, x)[:, :1]

    out = {}
    # 16.2: the plain sparse step on K1/K3
    f32 = make(torch.float32)
    routes = [r for _, r in core._gp_groups([f32.gp.kern], [f32.gp.state],
                                            2)]
    check(routes == ["batched"], f"sparse m=64 routes {routes}")
    launches, o_ms, a_ms, stats = lockstep(
        "sparse m=64 path", f32, make(torch.float64), objective)
    walked = sum(st.walk_chunks for st in stats)
    eager = [st.eager_gps for st in stats]
    check(launches["K1"] == 10 and launches["K3"] == walked,
          f"sparse path: K1 {launches['K1']} (want 10), K3 "
          f"{launches['K3']} (want one a walk chunk, {walked})")
    check(not any(eager) and all(launches[k] == 0 for k in
                                 ("K2", "K4", "K1-3p", "K2-3p")),
          f"sparse path left K1/K3: eager {eager}, launches {launches}")
    out["sparse c=0"] = (launches, o_ms, a_ms)

    # 16.3: the recommended floor runs on the eager route
    f32 = make(torch.float32, floor=True)
    check(f32.gp._floor > 0.0, "the floored model has no floor")
    launches, o_ms, a_ms, stats = lockstep(
        f"sparse m=64 with the floor {FLOOR} (floor "
        f"{f32.gp._floor:.6g}), eager route", f32,
        make(torch.float64, floor=True), objective)
    eager = [st.eager_gps for st in stats]
    check(eager == [1] * 10 and not any(launches.values()),
          f"the floored model left the eager route: eager {eager}, "
          f"launches {launches}")
    out["sparse floor"] = (launches, o_ms, a_ms)

    # 16.4: the certified path with the device oracle's 'sparse' kind
    def make_cert(device, dtype, **kw):
        return make(dtype, **kw)

    certified = drive_certified("sparse m=64", make_cert,
                                lambda x, c: objective(x), [None] * 10,
                                min_refined=5)
    for oracle, (n, _, _, _, _) in certified.items():
        check(n["K1-3p"] == 10 and n["K1"] == 10,
              f"sparse certified ({oracle}): K1-3p {n['K1-3p']} and K1 "
              f"{n['K1']} launches, not 10 each")
    cert = make(torch.float32, exact_boundaries=True,
                interval_precision="high", oracle="device")
    ost, kind = cert.gp.device_oracle_state()
    check(kind == "sparse", f"the sparse model's oracle kind is {kind!r}")
    k = cert._boundary_k
    grid = cert._grid()
    f64 = lambda a: torch.tensor(a, dtype=torch.float64,  # noqa: E731
                                 device="cuda")
    Q, packed_t = core.interval_scan(
        (cert.gp.kern,), (cert.gp.state,), grid, f64(SPARSE_FMIN).float(),
        BETA, f64(SPARSE_SCALING).float(), cert._boundary_band,
        refine_band=cert._refine_band, k=k, refine_k=cert._refine_k,
        refine_band_k=cert._refine_band_k, interval_precision="high")
    fix_idx, fix_bits, flips, n_within = core.device_oracle(
        (cert.gp.kern,), (ost,), grid64, Q, packed_t, f64(SPARSE_FMIN),
        BETA, constrained=(True,), k=k, kinds=(kind,))
    rows = fix_idx.cpu().numpy()
    rows = rows[rows >= 0]
    mu, var = cert.gp.predict_f64(grid_np[rows])
    host = mu - BETA * np.sqrt(var) > SPARSE_FMIN[0]
    dev = fix_bits.cpu().numpy()[fix_idx.cpu().numpy() >= 0]
    print(f"sparse m=64 device oracle ('sparse' kind, mu = k^T alpha): "
          f"{rows.size} band rows, verdicts equal to predict_f64's on "
          f"{int((host == dev).sum())}; float32 verdicts flipped "
          f"{int(flips)}", flush=True)
    check(rows.size > 0, "the sparse band was empty: the oracle went "
                         "unchecked")
    check(np.array_equal(host, dev), "the device oracle's verdicts differ "
                                     "from predict_f64's")

    # 16.5: drift against the exact GP on the same data, and its times
    X, Y = data
    exact = {dt: sparse_exact_gp("cuda", dt, data)
             for dt in (torch.float32, torch.float64)}
    route = [r for _, r in core._gp_groups(
        [exact[torch.float32].kern], [exact[torch.float32].state], 2)]
    safe = {}
    for name, gp in (("exact", exact[torch.float64]),
                     ("sparse c=0", sparse_gp(64, "cuda", torch.float64,
                                              data)),
                     ("sparse floor", sparse_gp(64, "cuda", torch.float64,
                                                data, **FLOOR))):
        Q = core._confidence_intervals((gp.kern,), (gp.state,), grid64,
                                       BETA)[0]
        safe[name] = (Q[:, 0] > SPARSE_FMIN[0]).cpu().numpy()
    drift = {name: (int((safe[name] & ~safe["exact"]).sum()),
                    int((~safe[name] & safe["exact"]).sum()))
             for name in ("sparse c=0", "sparse floor")}
    print(f"sparse drift against the exact GP on the same {X.shape[0]} "
          f"observations (float64 intervals, {grid64.shape[0]} grid points, "
          f"|S| exact "
          f"{int(safe['exact'].sum())}): (optimistic, conservative) rows "
          f"{drift}", flush=True)
    opt = SafeOpt(exact[torch.float32], grid_np, fmin=SPARSE_FMIN,
                  beta=BETA, scaling=SPARSE_SCALING, expander_chunk=32)
    zero_launches()
    e_ms, e_add = [], []
    for _ in range(4):
        x, t = timed_ms(opt.optimize)
        e_ms.append(t)
        y = objective(x)
        e_add.append(timed_ms(lambda: opt.add_new_data_point(x, y))[1])
    launches = read_launches()
    check(launches["K1"] == 4, f"exact cap-2048 path: K1 {launches['K1']}")
    out["exact cap 2048"] = (launches, e_ms, e_add)
    print(f"exact GP at capacity 2048 (2000 observations, route "
          f"{route}): launches {launches}", flush=True)
    for name, (_, o_ms, a_ms) in out.items():
        print(f"{name} times (CUDA events, median of iterations 2-): "
              f"optimize() {float(np.median(o_ms[1:])):.3f} ms, "
              f"add_new_data_point() {float(np.median(a_ms[1:])):.3f} ms",
              flush=True)
    for oracle, (_, c_ms, p_ms, _, _) in certified.items():
        print(f"sparse m=64 certified ({oracle} oracle) times (CUDA events, "
              f"iterations 2-10): median optimize() "
              f"{float(np.median(c_ms[1:])):.3f} ms against the float32 "
              f"plain twin's {float(np.median(p_ms[1:])):.3f} ms",
              flush=True)
    return out, certified


def drive_fits():
    """Phase 17: ``optimize_restarts(num_restarts=8, max_iters=200)`` of
    an exact RBF-ARD GP on 512 points, on the card and with
    ``device='cpu'``, and a sparse fit with moving inducing points
    (m=32, 2000 points) on the card. Returns the seconds of each."""
    from safeopt_torch import GPRegression, SparseGPRegression

    (X, Y), (Xs, Ys) = fit_data()
    out = {}
    lml = {}
    gps = {}
    for device in ("accel", "cpu"):
        gp = GPRegression(X, Y, fit_kernel(), noise_var=0.02, device="cuda")
        lml0 = gp.log_likelihood()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        lml[device] = gp.optimize_restarts(num_restarts=8, max_iters=200,
                                           device=device)
        torch.cuda.synchronize()
        out[device] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        gps[device] = gp
        print(f"fit on {'the card' if device == 'accel' else 'the CPU'}: "
              f"LML {lml0:.10g} -> {lml[device]:.10g} in {out[device]:.3f} "
              f"s (host clock); card memory peak above the model's "
              f"{peak / 2 ** 20:.1f} MiB; "
              f"lengthscales {gp.kern.lengthscale.tolist()}, variance "
              f"{float(gp.kern.variance):.6g}, noise {gp.noise_var:.6g}",
              flush=True)
        check(lml[device] > lml0, f"the {device} fit ended below its "
                                  "initial LML")
        if device == "accel":
            # the batch of 9 restarts' (512, 512) float64 grams lived on
            # the card: the fit did not run on the CPU
            check(peak >= 9 * 512 * 512 * 8, f"the card fit's memory peak "
                                             f"{peak} B is below its grams")
    rel = abs(lml["accel"] - lml["cpu"]) / abs(lml["cpu"])
    host = gps["accel"].log_likelihood()
    rel_host = abs(host - lml["accel"]) / abs(host)
    print(f"fits: card LML {lml['accel']:.12g} against the CPU's "
          f"{lml['cpu']:.12g}, relative {rel:.3e} (limit 1e-6); the host "
          f"float64 (SciPy) LML at the card's parameters {host:.12g}, "
          f"relative {rel_host:.3e} (limit 1e-9)", flush=True)
    check(rel <= 1e-6, "the card's fit and the CPU's differ")
    check(rel_host <= 1e-9, "the card's LML differs from the host's at its "
                            "parameters")
    sp = SparseGPRegression(Xs, Ys, fit_kernel(), noise_var=0.02,
                            inducing=32, device="cuda")
    Z0 = sp.Z.copy()
    lml0 = sp.log_likelihood()
    t0 = time.perf_counter()
    lml_sp = sp.optimize_restarts(num_restarts=2, max_iters=100,
                                  optimize_inducing=True)
    torch.cuda.synchronize()
    out["sparse"] = time.perf_counter() - t0
    moved = float(np.abs(sp.Z - Z0).max())
    print(f"sparse fit on the card (m=32, 2000 points, inducing points "
          f"moving, 2 restarts, 100 steps): DTC LML {lml0:.10g} -> "
          f"{lml_sp:.10g} in {out['sparse']:.3f} s; inducing points moved "
          f"up to {moved:.4g}; host LML after the rebuild "
          f"{sp.log_likelihood():.10g}", flush=True)
    check(lml_sp > lml0, "the sparse fit ended below its initial LML")
    check(abs(sp.log_likelihood() - lml_sp) <= 1e-6 * abs(lml_sp),
          "the sparse model's LML after the fit is not the fit's")
    return out


def flag_objectives():
    """The flagship plant's two functions as torch objectives."""
    return (lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x)),
            lambda x: 1.0 - 0.1 * torch.sum(x * x))


def ctx_objectives():
    """The contextual plant's two functions (``context_truth``) as torch
    objectives of (parameter, context)."""
    def base(x):
        return torch.exp(-0.5 * x[0] ** 2) * torch.exp(
            -0.5 * (x[1] / 1.5) ** 2)

    return (lambda x: 2.0 * base(x), lambda x: 1.5 * base(x))


def compare_loops(label, blocking, xs_block, loop, scaling):
    """How many leading queries of the device loop equal the blocking
    loop's; at a first divergence the two queries' scaled widths in the
    blocking loop's intervals at that step (``blocking[t]``, its Q at
    step t) must agree within the band."""
    mine = loop.next_idx.tolist()
    theirs = [s.next_index for s in blocking]
    agree = 0
    while agree < len(mine) and mine[agree] == theirs[agree]:
        agree += 1
    if agree < len(mine):
        Q = xs_block[agree]
        w = np.max((Q[:, 1::2] - Q[:, 0::2]) / np.asarray(scaling), axis=1)
        i, j = mine[agree], theirs[agree]
        check(abs(w[i] - w[j]) <= BAND,
              f"{label}: the loop's query {i} at step {agree} against the "
              f"blocking loop's {j}, scaled widths {w[i]} and {w[j]}")
    return agree


def drive_runner(label, make_opt, objectives, grid_np, contexts):
    """Phase 14: ``run_safeopt_loop`` against the blocking SafeOpt loop
    of ``make_opt()`` on the same plant (noise 0). Returns (agreeing
    steps, loop ms per iteration, blocking ms per iteration, loop host
    syncs per iteration, blocking host syncs per iteration, launches of
    the loop, launches of the blocking loop)."""
    from safeopt_torch.algorithms.runner import run_safeopt_loop

    n_iter = len(contexts)
    blocking = make_opt()
    kw = (lambda c: {}) if contexts[0] is None else (
        lambda c: {"context": c})
    zero_launches()
    qs, stats, block_ms = [], [], []
    for c in contexts:
        def one():
            x = blocking.optimize(**kw(c))
            full = x if c is None else np.concatenate([x, [c]])
            xt = torch.tensor(full, dtype=torch.float64, device="cuda")
            blocking.add_new_data_point(
                x, np.array([[float(f(xt)) for f in objectives]]), **kw(c))
        block_ms.append(timed_ms(one)[1])
        stats.append(blocking.stats.last)
        qs.append(blocking.Q.copy())    # the step's intervals, untimed
    block_launches = read_launches()

    opt = make_opt()
    dev = torch.device("cuda")
    t = lambda a: torch.tensor(np.asarray(a, dtype=float),  # noqa: E731
                               dtype=torch.float32, device=dev)
    grid = torch.tensor(opt.inputs, dtype=torch.float64, device=dev)
    ctx = None if contexts[0] is None else np.asarray(contexts)[:, None]
    args = (tuple(g.kern for g in opt.gps), None, grid, t(opt.fmin), BETA,
            t(opt.scaling), t([0.0] * len(opt.gps)))
    loop_kw = dict(objectives=objectives, dtype=torch.float32, chunk=32)
    # one iteration first, on its own states: the loop's one-time costs
    # (the first launch of each PyTorch kernel it adds) stay out of the
    # timed run, as iteration 1 stays out of the blocking loop's median
    run_safeopt_loop(args[0], tuple(g.factor_state() for g in opt.gps),
                     *args[2:], n_iter=1, contexts=ctx if ctx is None
                     else ctx[:1], **loop_kw)
    states = tuple(g.factor_state() for g in opt.gps)
    counts = [int(s.count) for s in states]
    zero_launches()
    res, total = timed_ms(lambda: run_safeopt_loop(
        args[0], states, *args[2:], n_iter=n_iter, contexts=ctx, **loop_kw))
    loop_ms = total / n_iter
    block_ms = float(np.median(block_ms[1:]))
    loop_launches = read_launches()
    check(bool(res.has_safe.all()), f"{label} loop lost certification: "
                                    f"{res.has_safe.tolist()}")
    grown = [int(s.count) for s in res.states]
    check(grown == [c + n_iter for c in counts],
          f"{label} loop counts {counts} -> {grown}")
    check(bool(torch.isfinite(res.ys).all()), f"{label} loop: ys not finite")
    agree = compare_loops(label, stats, qs, res, opt.scaling)
    syncs = res.host_syncs.tolist()
    print(f"{label} run_safeopt_loop: {n_iter} iterations, queries equal to "
          f"the blocking loop's for {agree} of {n_iter} steps; loop "
          f"{loop_ms:.3f} ms per iteration (CUDA events around the call, "
          f"over {n_iter}) against the blocking loop's {block_ms:.3f} ms "
          f"(optimize + add_new_data_point, median of iterations 2-"
          f"{n_iter}); host syncs per iteration {syncs} (blocking "
          f"{[s.host_syncs for s in stats]}); walk chunks "
          f"{res.walk_chunks.tolist()}; launches loop {loop_launches}, "
          f"blocking {block_launches}", flush=True)
    return (agree, loop_ms, block_ms, syncs, [s.host_syncs for s in stats],
            loop_launches, block_launches)


def drive_lagged(grid_np):
    """Phase 15: ``run_lagged_campaign`` on the flagship, pipelined
    against serial, plain and certified (device oracle). Returns {mode:
    {pipelined: ms per iteration}}."""
    from safeopt_torch import SafeOpt, run_lagged_campaign

    def plant_fn(x):
        r2 = float(np.sum(np.asarray(x) ** 2))
        return np.array([2.0 * math.exp(-0.5 * r2), 1.0 - 0.1 * r2])

    out = {}
    for mode, kw in (("plain", {}),
                     ("certified", dict(exact_boundaries=True,
                                        interval_precision="high",
                                        oracle="device"))):
        runs, times = {}, {True: [], False: []}
        for pipelined in (True, False, False, True):
            opt = SafeOpt(build_gps(np.random.default_rng(0), 50, 64,
                                    "cuda", torch.float32), grid_np,
                          fmin=FMIN, beta=BETA, scaling=SCALING,
                          expander_chunk=32, **kw)
            opt.optimize()          # the first step's one-time costs
            torch.cuda.synchronize()
            start = time.perf_counter()
            xs_ys = run_lagged_campaign(opt, plant_fn, 8,
                                        pipelined=pipelined)
            torch.cuda.synchronize()
            times[pipelined].append((time.perf_counter() - start) * 1e3 / 8)
            runs.setdefault(pipelined, xs_ys)
            check(all(np.array_equal(a, b) for a, b in zip(xs_ys,
                                                           runs[pipelined])),
                  f"lagged campaign ({mode}): two runs differ")
        (xs_s, ys_s), (xs_p, ys_p) = runs[False], runs[True]
        check(np.array_equal(xs_s, xs_p) and np.array_equal(ys_s, ys_p),
              f"lagged campaign ({mode}): pipelined and serial differ")
        out[mode] = {p: float(np.mean(v)) for p, v in times.items()}
        print(f"run_lagged_campaign flagship ({mode}): 8 iterations, xs and "
              f"ys bitwise equal pipelined and serial (runs in the order "
              f"P S S P); ms per iteration (host clock) pipelined "
              f"{times[True][0]:.3f} / {times[True][1]:.3f}, serial "
              f"{times[False][0]:.3f} / {times[False][1]:.3f}", flush=True)
    return out


# -- phase 19: the swarm ------------------------------------------------------

SWARM_STEPS = 10
SWARM_F64_TOL = 1e-9     # float64 card queries against the CPU's
SWARM_TIE = 1e-12        # a flipped comparison's largest relative margin


def swarm_classes():
    """``SafeOptSwarm`` subclasses fed injected uniforms: ``Seeded`` from a
    NumPy generator (``feed(seed)``), ``Rows`` one row of a flat
    per-iteration array per ``optimize()`` (``feed(rows)``, the layout
    ``run_swarmopt_loop`` takes)."""
    from safeopt_torch import SafeOptSwarm
    from safeopt_torch.algorithms.swarm_opt_fused import (split_streams,
                                                          stream_layout)

    class Seeded(SafeOptSwarm):
        def feed(self, seed):
            self._rng = np.random.default_rng(seed)
            return self

        def _fused_streams(self, ucb=False):
            return {name: self._rng.uniform(size=shape) for name, shape in
                    stream_layout(self.swarm_size, self.max_iters,
                                  self.gp.input_dim, ucb)}

    class Rows(SafeOptSwarm):
        def feed(self, rows):
            self._rows = iter(rows)
            return self

        def _fused_streams(self, ucb=False):
            return split_streams(next(self._rows), stream_layout(
                self.swarm_size, self.max_iters, self.gp.input_dim, ucb))

    return Seeded, Rows


def swarm_diag_fields(d):
    """(name, start, stop) of each output in ``SwarmIterOut.diag``."""
    spans = [("x_next", d), ("x_maxi", d), ("x_exp", d), ("x_greedy", d),
             ("greedy_point", d), ("best_lower_bound", 1), ("std_maxi", 1),
             ("std_exp", 1), ("num_safe", 3), ("num_pruned", 3),
             ("num_added", 2), ("count", 1)]
    out, at = [], 0
    for name, n in spans:
        out.append((name, at, at + n))
        at += n
    return out


def swarm_margin(opt, X):
    """The least scaled float64 margin ``(mu - beta sigma - fmin) /
    scaling`` over the rows of X and the constrained GPs
    (``predict_f64``; +inf when no GP is constrained)."""
    worst = math.inf
    for gp, fmin, scale in zip(opt.gps, opt.fmin, opt.scaling):
        if fmin == -np.inf:
            continue
        mu, var = gp.predict_f64(np.atleast_2d(X))
        lower = np.ravel(mu) - opt.beta(opt.t) * np.sqrt(np.ravel(var))
        worst = min(worst, float(np.min((lower - fmin) / scale)))
    return worst


def swarm_safety(opt, x, before, certified):
    """Float64 safety of one step of ``opt``, read before its observation
    is added: every row the step added to the safe set has a scaled
    float64 margin (``swarm_margin``) of at least -BAND, and so does the
    query unless it is a safe-set row held from before the step. The
    reference keeps a safe set of fewer than ``swarm_size`` safe rows
    unpruned and seeds each particle's best from its first position
    whatever its safety (gp_opt.py:1051-1062, swarm.py:78-84), so such a
    row, safe when it joined, can be the query though the current model
    calls it unsafe (ROADMAP Queue 3 entry 13). ``before`` is the set of
    the safe set's rows before the step; ``certified`` collects every row
    that passed when it joined. Returns (the query's margin, whether it
    is a held row)."""
    new = np.array([r for r in opt.S if tuple(r) not in before])
    if len(new):
        margin = swarm_margin(opt, new)
        check(margin >= -BAND, f"a row added to the safe set has the "
                               f"float64 margin {margin:.3e}")
        certified.update(map(tuple, new))
    margin = swarm_margin(opt, x)
    held = tuple(x) in before
    check(margin >= -BAND or held,
          f"the query {x} has the float64 margin {margin:.3e} and is no "
          "held safe-set row")
    return margin, held


def swarm_run_safety(label, opt, step, plant_fn, steps=SWARM_STEPS):
    """``steps`` calls of ``step()`` (one ``optimize()`` of ``opt``, its
    query returned) with ``swarm_safety`` after each and the measurement
    added to ``opt`` (and to whatever ``plant_fn`` feeds); every row of
    the device safe set at the end is one that passed when it joined (or
    a seed observation). Returns (each step's result, the least query
    margin, the queries that were held rows below the band)."""
    certified = set(map(tuple, opt.S))
    results, worst, held_unsafe = [], math.inf, 0
    for _ in range(steps):
        before = set(map(tuple, opt.S))
        res = step()
        x = res[0]
        margin, held = swarm_safety(opt, x, before, certified)
        worst = min(worst, margin)
        held_unsafe += held and margin < -BAND
        results.append(res)
        plant_fn(x)
    rows = set(map(tuple, opt.S))
    check(rows <= certified, f"{label}: {len(rows - certified)} rows of the "
                             "device safe set never passed the float64 test")
    unsafe_now = int(np.sum([swarm_margin(opt, np.array(r)[None]) < -BAND
                             for r in rows])) if len(rows) < 600 else None
    print(f"{label}: every query safe by float64 within the band or a held "
          f"safe-set row ({held_unsafe} such held rows queried below it); "
          f"least query margin {worst:.4g}; every one of the {len(rows)} "
          f"safe-set rows passed when it joined"
          + ("" if unsafe_now is None else
             f" ({unsafe_now} below the band under the final model)"),
          flush=True)
    return results, worst, held_unsafe


def swarm_step(opt, sync_free=True):
    """One ``optimize()`` of ``opt``, its dispatch under
    ``set_sync_debug_mode('error')`` (any host sync raises). Returns (x,
    host ms, the host copy of the diagnostics)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        pending = opt.optimize_async()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    x = pending.result()
    ms = (time.perf_counter() - start) * 1e3
    check(opt.stats.last.host_syncs == 1,
          f"a swarm step made {opt.stats.last.host_syncs} host reads, not "
          "the one pull")
    return x, ms, pending._diag.clone()


def swarm_twins(label, make, plant_fn):
    """Phase 19.1/19.3: a graph-replaying ``SafeOptSwarm`` and an eager
    twin fed the same uniforms, ``SWARM_STEPS`` float32 steps on the card
    (the graph's query and its measurement added to both): queries
    identical and diag bitwise equal at every step (or, should cuBLAS
    pick another algorithm under capture, the differing outputs printed
    and held within 1e-6 relative); the graph twin's steps safe as
    ``swarm_run_safety`` holds them. Returns (eager ms, graph ms, the
    graph's captures after each step, the twins, bitwise)."""
    Seeded, _ = swarm_classes()
    twins = {"eager": make(Seeded, False).feed(19),
             "graph": make(Seeded, True).feed(19)}
    d = twins["graph"].gp.input_dim
    state = {"bitwise": True, "t": 0}

    def step():
        xs, diags, ms = {}, {}, {}
        for name, opt in twins.items():
            xs[name], ms[name], diags[name] = swarm_step(opt)
        t = state["t"]
        state["t"] += 1
        check(np.array_equal(xs["eager"], xs["graph"]),
              f"{label} step {t}: graph query {xs['graph']} against eager "
              f"{xs['eager']}")
        if not torch.equal(diags["eager"], diags["graph"]):
            state["bitwise"] = False
            e, g = diags["eager"].double(), diags["graph"].double()
            rel = float(((g - e).abs() / e.abs().clamp(min=1e-30)).max())
            differ = [name for name, a, b in swarm_diag_fields(d)
                      if not torch.equal(e[a:b], g[a:b])]
            print(f"{label} step {t}: the graph's diag differs from eager "
                  f"in {differ}, max relative {rel:.3e}", flush=True)
            check(rel <= 1e-6, f"{label} step {t}: graph diag off by "
                               f"{rel:.3e} relative")
        return xs["graph"], ms, twins["graph"].graph_captures

    def observe(x):
        y = plant_fn(x)
        for opt in twins.values():
            opt.add_new_data_point(x, y)

    results, _, _ = swarm_run_safety(label, twins["graph"], step, observe)
    check(np.array_equal(twins["eager"].S, twins["graph"].S),
          f"{label}: the twins' safe sets differ")
    captures = [r[2] for r in results]
    print(f"{label}: {SWARM_STEPS} float32 steps, graph and eager queries "
          f"identical, diag "
          f"{'bitwise equal' if state['bitwise'] else 'within 1e-6'}; graph "
          f"captures after each step {captures}; |S| "
          f"{twins['graph']._count}", flush=True)
    return ([r[1]["eager"] for r in results],
            [r[1]["graph"] for r in results], captures, twins,
            state["bitwise"])


def swarm_float64(label, num_gps):
    """Phase 19.2: the (a) problem in float64 on the card (graph) and on
    the CPU (eager) with the same uniforms: queries within 1e-9 at every
    step, unless a near-tie flipped the final maximizer-vs-expander
    choice (printed with its margin, below 1e-12 relative, after the
    first 3 steps). Returns the steps that agreed."""
    Seeded, _ = swarm_classes()
    opts = {dev: Seeded(swarm_gps(num_gps, dev, torch.float64, capacity=8),
                        **swarm_problem(num_gps)).feed(64)
            for dev in ("cuda", "cpu")}
    d = opts["cuda"].gp.input_dim
    fields = {name: (a, b) for name, a, b in swarm_diag_fields(d)}
    for t in range(SWARM_STEPS):
        xs, diags = {}, {}
        for dev, opt in opts.items():
            pending = opt.optimize_async()
            xs[dev] = pending.result()
            diags[dev] = pending._diag.numpy()
        err = float(np.max(np.abs(xs["cuda"] - xs["cpu"])))
        if err > SWARM_F64_TOL:
            a, _ = fields["std_maxi"]
            s_maxi, s_exp = diags["cuda"][a], diags["cuda"][a + 1]
            margin = abs(s_maxi - s_exp) / max(abs(s_maxi), abs(s_exp))
            print(f"{label}: the float64 card and CPU queries part at step "
                  f"{t} by {err:.3e}; the final choice's margin is "
                  f"{margin:.3e} relative", flush=True)
            check(t >= 3 and margin < SWARM_TIE,
                  f"{label}: float64 card and CPU queries differ at step {t}"
                  f" by {err:.3e} without a near-tie")
            return t
        for dev, opt in opts.items():
            opt.add_new_data_point(xs[dev], swarm_plant(xs[dev], num_gps))
    print(f"{label}: float64 on the card (graph) and on the CPU agree within "
          f"{SWARM_F64_TOL:g} at all {SWARM_STEPS} steps", flush=True)
    return SWARM_STEPS


def profile_device(fn):
    """(device events, kernels, device ms, host ms) of one ``fn()`` under
    ``torch.profiler`` (the host clock around it, the stream drained), or
    None where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    kernels = [e for e in events
               if not e.name.lower().startswith(("memcpy", "memset"))]
    return (len(events), len(kernels),
            sum(e.time_range.elapsed_us() for e in events) / 1e3, host_ms)


def swarm_profile(opt):
    """``profile_device`` of one ``optimize()`` of ``opt`` (one before it
    takes any capture out of the window)."""
    opt.optimize()
    return profile_device(opt.optimize)


def device_line(label, prof, steps, smi):
    """Print a profiled window's device time per step and busy share."""
    if prof is None:
        print(f"{label}: the profiler saw no device activity; device time "
              "not measured", flush=True)
        return
    _, kernels, dev_ms, host_ms = prof
    print(f"{label} on {smi}: {kernels / steps:.0f} kernels and "
          f"{dev_ms / steps:.3f} device ms per iteration against "
          f"{host_ms / steps:.3f} ms on the host clock (torch.profiler, "
          f"{steps} iterations): busy {dev_ms / host_ms:.1%}", flush=True)


def swarm_loop(smi):
    """Phase 19.6: ``run_swarmopt_loop`` on (a) G=2, 10 iterations, the
    whole call under ``set_sync_debug_mode('error')``, against the
    blocking ``SafeOptSwarm`` loop fed the same uniforms (queries equal up
    to round-off at least for the first 3 steps, and safe where they
    part); counts grown by 10. Returns (ms of a one-iteration loop that
    captures its graph, ms per iteration of the 10-iteration loop that
    replays it, agreeing steps)."""
    from safeopt_torch import SafeOptSwarm
    from safeopt_torch.algorithms.runner import run_swarmopt_loop
    from safeopt_torch.algorithms.swarm_opt_fused import stream_layout
    _, Rows = swarm_classes()
    n = SWARM_STEPS
    problem = swarm_problem(2)
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(
        problem["swarm_size"], 100, 10))
    flat = torch.tensor(np.random.default_rng(6).uniform(size=(n, n_u)),
                        dtype=torch.float32, device="cuda")
    blocking = Rows(swarm_gps(2, "cuda", torch.float32, capacity=16),
                    **problem).feed(flat)
    blocking.reserve(n)
    xs = []
    for _ in range(n):
        x = blocking.optimize()
        xs.append(x)
        blocking.add_new_data_point(x, swarm_plant(x, 2))

    def objectives():
        return (lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x)),
                lambda x: 1.0 - 0.05 * torch.sum(x * x))

    graphs = {}

    def run(n_iter):
        opt = SafeOptSwarm(swarm_gps(2, "cuda", torch.float32, capacity=16),
                           **problem)
        opt.reserve(n)
        states = tuple(g.factor_state() for g in opt.gps)
        torch.cuda.synchronize()
        start = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = run_swarmopt_loop(
                tuple(g.kern for g in opt.gps), states, opt._S_dev,
                opt.optimal_velocities, opt._bounds_arr, opt.fmin,
                opt.scaling, [0.0, 0.0], [BETA] * n_iter, opt.greedy_point,
                -np.inf, flat[:n_iter], objectives=objectives(),
                n_iter=n_iter, swarm_size=opt.swarm_size,
                max_iters=opt.max_iters, graph_cache=graphs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - start) * 1e3

    _, first = run(1)                # the capture, kept in ``graphs``
    res, total = run(n)
    device_line("run_swarmopt_loop (a) G=2", profile_device(lambda: run(3)),
                3, smi)
    check(len(graphs) == 1, f"run_swarmopt_loop captured {len(graphs)} "
                            "graphs")
    check([int(s.count) for s in res.states] == [5 + n, 5 + n],
          f"run_swarmopt_loop counts {[int(s.count) for s in res.states]}")
    check(bool((res.num_safe_min > 0).all()) and res.host_syncs.sum() == 0,
          f"run_swarmopt_loop: safe counts {res.num_safe_min.tolist()}, "
          f"host syncs {res.host_syncs.tolist()}")
    loop_xs = res.xs.cpu().numpy()
    agree = 0
    while agree < n and np.allclose(loop_xs[agree], xs[agree], rtol=0,
                                    atol=1e-5):
        agree += 1
    bitwise = sum(np.array_equal(loop_xs[t].astype(np.float32),
                                 xs[t].astype(np.float32)) for t in range(n))
    check(agree >= 3, f"run_swarmopt_loop parts from the blocking loop at "
                      f"step {agree}")
    print(f"run_swarmopt_loop (a) G=2 on {smi}: {n} iterations under "
          f"set_sync_debug_mode('error'), queries equal to the blocking "
          f"loop's for {agree} of {n} steps ({bitwise} bitwise), counts "
          f"+{n}; {total / n:.3f} ms per iteration replaying the graph "
          f"that a one-iteration loop captured in {first:.3f} ms (host "
          f"clock)", flush=True)
    return first, total / n, agree


def swarm_lagged(smi):
    """Phase 19.7: ``run_lagged_campaign`` on (a) G=2, 8 iterations,
    pipelined against serial (order P S S P): queries and observations
    bitwise equal. Returns {pipelined: mean ms per iteration}."""
    from safeopt_torch import SafeOptSwarm, run_lagged_campaign
    runs, times = {}, {True: [], False: []}
    for pipelined in (True, False, False, True):
        opt = SafeOptSwarm(swarm_gps(2, "cuda", torch.float32, capacity=16),
                           **swarm_problem(2), seed=11)
        opt.reserve(8)
        opt.optimize()              # the capture, outside the timing
        torch.cuda.synchronize()
        start = time.perf_counter()
        xs_ys = run_lagged_campaign(opt, lambda x: swarm_plant(x, 2)[0], 8,
                                    pipelined=pipelined)
        torch.cuda.synchronize()
        times[pipelined].append((time.perf_counter() - start) * 1e3 / 8)
        check(opt.graph_captures == 1, f"the lagged campaign recaptured: "
                                       f"{opt.graph_captures} captures")
        runs.setdefault(pipelined, xs_ys)
        check(all(np.array_equal(a, b) for a, b in zip(xs_ys,
                                                       runs[pipelined])),
              "swarm lagged campaign: two runs differ")
    (xs_s, ys_s), (xs_p, ys_p) = runs[False], runs[True]
    check(np.array_equal(xs_s, xs_p) and np.array_equal(ys_s, ys_p),
          "swarm lagged campaign: pipelined and serial differ")
    for pipelined in (True, False):
        opt = SafeOptSwarm(swarm_gps(2, "cuda", torch.float32, capacity=16),
                           **swarm_problem(2), seed=11)
        opt.reserve(3)
        opt.optimize()
        device_line(f"run_lagged_campaign swarm (a) G=2 "
                    f"{'pipelined' if pipelined else 'serial'}",
                    profile_device(lambda: run_lagged_campaign(
                        opt, lambda x: swarm_plant(x, 2)[0], 3,
                        pipelined=pipelined)), 3, smi)
    print(f"run_lagged_campaign swarm (a) G=2 on {smi}: 8 iterations, xs "
          f"and ys bitwise equal pipelined and serial (P S S P); ms per "
          f"iteration (host clock) pipelined {times[True][0]:.3f} / "
          f"{times[True][1]:.3f}, serial {times[False][0]:.3f} / "
          f"{times[False][1]:.3f}", flush=True)
    return {p: float(np.mean(v)) for p, v in times.items()}


def drive_swarm(smi):
    """Phase 19: SafeOptSwarm on the card at the JAX bench's widths. Every
    grid kernel's launch count is zeroed before it and must read 0 after
    it. Returns the numbers phase 19 prints at the end."""
    from safeopt_torch import SafeOptSwarm
    zero_launches()
    out = {}
    # 19.1 (a): G=1 and G=2 from the bench's 5 observations, GP capacity
    # 8, so that the fourth append grows it (a rebuilt model state)
    for G in (1, 2):
        def make(cls, graph, G=G):
            return cls(swarm_gps(G, "cuda", torch.float32, capacity=8),
                       **swarm_problem(G), graph=graph)

        out[f"a G={G}"] = swarm_twins(
            f"swarm (a) G={G}, d=10, 5 observations",
            make, lambda x, G=G: swarm_plant(x, G))
    # 19.2: float64 on the card against float64 on the CPU
    out["f64"] = {G: swarm_float64(f"swarm (a) G={G} float64", G)
                  for G in (1, 2)}

    # 19.3 (b): the G=2 problem deep in a campaign, 250 observations in
    # [-1.5, 1.5]^10 at capacity 256 (grown to 512 at the sixth append),
    # the safe set those 250 points
    data_b = swarm_data(250, seed=250, spread=1.5)

    def make_b(cls, graph):
        return cls(swarm_gps(2, "cuda", torch.float32, data=data_b,
                             capacity=256), **swarm_problem(2), graph=graph)

    out["b"] = swarm_twins("swarm (b) G=2, d=10, 250 observations", make_b,
                           lambda x: swarm_plant(x, 2))

    # 19.4 (c): the sparse m=64 model of phase 16 (2000 observations, the
    # safe set those 2000 points)
    rng = np.random.default_rng(19)
    opt_c = SafeOptSwarm(sparse_gp(64, "cuda", torch.float32),
                         fmin=SPARSE_FMIN, bounds=[(-4.0, 4.0)] * 2,
                         scaling=SPARSE_SCALING)
    results, _, _ = swarm_run_safety(
        "swarm (c) sparse m=64 (2000 observations)", opt_c,
        lambda: swarm_step(opt_c),
        lambda x: opt_c.add_new_data_point(x, plant(rng, x)[:, :1]))
    out["c"] = [r[1] for r in results]
    print(f"swarm (c): graph captures {opt_c.graph_captures}, |S| "
          f"{opt_c._count}", flush=True)

    # 19.5: kernels per optimize() and the device's busy share, (a) G=2
    twins = out["a G=2"][3]
    out["profile"] = {}
    for name, opt in twins.items():
        opt.reserve(2)
        out["profile"][name] = swarm_profile(opt)
    out["loop"] = swarm_loop(smi)
    out["lagged"] = swarm_lagged(smi)
    launches = read_launches()
    check(not any(launches.values()),
          f"the swarm phase launched grid kernels: {launches}")
    print(f"swarm phase: grid-kernel launches {launches}", flush=True)
    return out


def print_swarm(out, smi):
    """Phase 19's numbers, each beside the card's nvidia-smi line."""
    def med(v):
        return float(np.median(v[1:]))

    def replays(key):
        """The graph's ms at iterations 2-10 that captured nothing."""
        _, g_ms, captures, _, _ = out[key]
        return [ms for t, ms in enumerate(g_ms)
                if t >= 1 and captures[t] == captures[t - 1]]

    for key in ("a G=1", "a G=2", "b"):
        e_ms, g_ms, captures, _, bitwise = out[key]
        replay = replays(key)
        capture = [ms for t, ms in enumerate(g_ms)
                   if captures[t] > (captures[t - 1] if t else 0)]
        print(f"swarm {key} on {smi}: optimize() eager {med(e_ms):.3f} ms, "
              f"graph {float(np.median(replay)):.3f} ms (median of "
              f"iterations 2-10, host clock; the graph's over the "
              f"{len(replay)} steps that replayed without a capture); steps "
              f"with a capture {[round(v, 3) for v in capture]} ms; "
              f"speed-up {med(e_ms) / float(np.median(replay)):.2f}x",
              flush=True)
    print(f"swarm (c) sparse m=64 on {smi}: optimize() graph "
          f"{med(out['c']):.3f} ms (median of iterations 2-10, host clock)",
          flush=True)
    for name, prof in out["profile"].items():
        if prof is None:
            print(f"swarm (a) G=2 {name}: the profiler saw no device "
                  f"activity; kernels per optimize() not measured",
                  flush=True)
            continue
        events, kernels, dev_ms, _ = prof
        step = (med(out["a G=2"][0]) if name == "eager"
                else float(np.median(replays("a G=2"))))
        print(f"swarm (a) G=2 {name} on {smi}: {kernels} kernels ({events} "
              f"device events) per optimize() (torch.profiler), device "
              f"{dev_ms:.3f} ms, busy share {dev_ms / step:.1%} of the "
              f"{step:.3f} ms step", flush=True)
    first, loop_ms, _ = out["loop"]
    print(f"swarm loops on {smi}: run_swarmopt_loop {loop_ms:.3f} ms per "
          f"iteration (the capturing one-iteration loop {first:.3f} ms); "
          f"lagged campaign "
          f"pipelined {out['lagged'][True]:.3f}, serial "
          f"{out['lagged'][False]:.3f} ms per iteration (host clock)",
          flush=True)


# ---------------------------------------------------------------------------
# phase 20: campaign fleets
# ---------------------------------------------------------------------------

FLEET_K = 8           # campaigns of the grid fleets
FLEET_ITERS = 8
FLEET_NOISE = 0.05    # the flagship plant's noise std
SWARM_FLEET_K = 4
SWARM_FLEET_NOISE = 0.01


def fleet_walk_rounds(res):
    """K3 rounds of each fleet step: the longest walk of the step (the
    campaigns walk in lock step)."""
    return res.walk_chunks.amax(dim=0)


def run_fleet_case(label, kernels, per, grid64, fmin, scaling, objectives,
                   chunk, noise_std, smi, profile=False):
    """Phase 20 (a)/(b): ``run_safeopt_campaigns`` over the K campaigns
    ``per`` (float64 factor states) against K solo ``run_safeopt_loop``
    calls on the same states and normals: float32 ``next_idx``
    trajectories equal, float64 ones equal with queries within 1e-9; K1
    once a fleet step, K3 once a walk round, no other kernel. Returns the
    numbers the phase prints and the fleet's launches."""
    from safeopt_torch.algorithms.runner import run_safeopt_loop
    from safeopt_torch.parallel import (run_safeopt_campaigns,
                                        stack_campaign_states)

    K, G, n = len(per), len(kernels), FLEET_ITERS
    dev = grid64.device
    noise = torch.tensor(np.random.default_rng(20).normal(size=(K, n, G)),
                         dtype=torch.float64, device=dev)
    t = functools.partial(torch.tensor, dtype=torch.float64, device=dev)
    args = (t(fmin), BETA, t(scaling), t([0.0] * G))
    batched = stack_campaign_states(per)
    out = {}
    for dtype in (torch.float32, torch.float64):
        kw = dict(objectives=objectives, dtype=dtype, chunk=chunk,
                  noise_std=noise_std)
        # one iteration of each first: the first launch of every PyTorch
        # kernel stays out of the timed runs
        run_safeopt_campaigns(kernels, batched, grid64, *args, noise[:, :1],
                              n_iter=1, **kw)
        run_safeopt_loop(kernels, per[0], grid64, *args, noise[0, :1],
                         n_iter=1, **kw)
        zero_launches()
        fleet, fleet_ms = timed_ms(lambda: run_safeopt_campaigns(
            kernels, batched, grid64, *args, noise, n_iter=n, **kw))
        launches = read_launches()
        solos, solo_ms, solo_syncs = [], 0.0, np.zeros(n, dtype=int)
        for k in range(K):
            res, ms = timed_ms(lambda k=k: run_safeopt_loop(
                kernels, per[k], grid64, *args, noise[k], n_iter=n, **kw))
            solos.append(res)
            solo_ms += ms
            solo_syncs += res.host_syncs.numpy()
        name = "float32" if dtype == torch.float32 else "float64"
        check(bool(fleet.has_safe.all()), f"fleet {label} {name} lost "
                                          "certification")
        check([c.tolist() for c in (s.count for s in fleet.states)]
              == [[int(st.count) + n for st in (p[i] for p in per)]
                  for i in range(G)],
              f"fleet {label} {name}: counts not grown by {n}")
        for k, solo in enumerate(solos):
            check(torch.equal(fleet.next_idx[k].cpu(), solo.next_idx.cpu()),
                  f"fleet {label} {name}: campaign {k} queried "
                  f"{fleet.next_idx[k].tolist()}, its solo loop "
                  f"{solo.next_idx.tolist()}")
            if dtype == torch.float64:
                err = float((fleet.xs[k] - solo.xs).abs().max())
                check(err <= 1e-9, f"fleet {label} float64: campaign {k}'s "
                                   f"queries {err:.3e} from its solo loop's")
        rounds = int(fleet_walk_rounds(fleet).sum())
        check(launches["K1"] == n and launches["K3"] == rounds
              and not any(v for key, v in launches.items()
                          if key not in ("K1", "K3")),
              f"fleet {label} {name}: launches {launches}, want K1 {n} and "
              f"K3 {rounds} (the walk rounds)")
        walked = int(fleet.walk_chunks.sum())
        print(f"fleet {label} {name}: {K} campaigns x {n} iterations, "
              f"next_idx equal to the {K} solo loops'; launches {launches} "
              f"(K1 one a fleet step for all {K * G} GPs, K3 one a walk "
              f"round: {rounds} rounds for {walked} campaign chunks); "
              f"host syncs per fleet step {fleet.host_syncs.tolist()} "
              f"against the solo loops' {solo_syncs.tolist()}; on {smi}: "
              f"{fleet_ms / n:.3f} ms per fleet iteration, "
              f"{fleet_ms / (n * K):.3f} ms per campaign-iteration, against "
              f"the solo loops' {solo_ms / n:.3f} ms per iteration summed "
              f"over the {K} campaigns (CUDA events around each call)",
              flush=True)
        out[name] = dict(fleet_ms=fleet_ms / n, solo_ms=solo_ms / n,
                         syncs=fleet.host_syncs.tolist(),
                         solo_syncs=solo_syncs.tolist(), launches=launches,
                         rounds=rounds, chunks=walked)
        if dtype == torch.float32:
            out["launches"] = launches
    if profile:
        m = min(3, n)
        prof = profile_device(lambda: run_safeopt_campaigns(
            kernels, batched, grid64, *args, noise[:, :m], n_iter=m,
            objectives=objectives, dtype=torch.float32, chunk=chunk,
            noise_std=noise_std))
        device_line(f"fleet {label} float32", prof, m, smi)
        out["profile"] = prof
    return out


def fleet_flagship_states(device=None):
    """Phase 20 (a): FLEET_K campaigns of the flagship, campaign k from
    its own 50 observations (``build_gps`` seeded 200 + k), float64 factor
    states, and the shared kernels."""
    per, kernels = [], None
    for k in range(FLEET_K):
        gps = build_gps(np.random.default_rng(200 + k), 50, 64,
                        device or "cuda", torch.float64)
        per.append(tuple(g.factor_state() for g in gps))
        kernels = tuple(g.kern for g in gps)
    return kernels, per


def fleet_bench_states(device=None):
    """Phase 20 (b): the JAX bench's fleet (``bench.py:1510-1560``): 8
    campaigns of one RBF(2, variance 2, lengthscale 1.2) GP, each from
    one observation in [-0.4, 0.4]^2 (``default_rng(5)``), capacity 16."""
    from safeopt_torch import RBF, GPRegression

    rng = np.random.default_rng(5)
    kern = RBF(2, variance=2.0, lengthscale=1.2)
    per = []
    for _ in range(FLEET_K):
        x0 = rng.uniform(-0.4, 0.4, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        per.append((GPRegression(x0, np.array([[y0]]), kern, noise_var=1e-4,
                                 capacity=16, device=device or "cuda",
                                 dtype=torch.float64).factor_state(),))
    return (kern,), per


def check_k3_fleet(kernels, per, grid64):
    """Phase 20 (c): one K3 launch for FLEET_K campaigns of two GPs, each
    campaign's own mask (its ~S) and its own chunk (``check_k3_gps``'s
    rule: 16 candidates from the head of its visit order, 16 from the
    middle, the last 4 slots padding), campaign 3's mask planted all
    False. At fmin raised by each of ``K3_SHIFTS``: float64 kernel equal
    to its plain version, float32 kernel equal to the float64 plain one
    outside the band, the fleet launch equal to FLEET_K single-mask
    launches bitwise in both dtypes, the planted campaign's rows all
    False while others hit. Returns (the float64 error, the float32
    operands of the launch ``fleet_kernel_times`` times: the same chunks
    with the masks as the walk passes them, ~S, none planted; the unsafe
    points per GP of those masks)."""
    from safeopt_torch.algorithms import fleet_core as fc
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.parallel import stack_campaign_states

    K, G = len(per), len(kernels)
    f64 = torch.tensor(FMIN, dtype=torch.float64, device="cuda")
    s64 = torch.tensor(SCALING, dtype=torch.float64, device="cuda")
    batched = stack_campaign_states(per)
    Q, mu, sigma, _ = fc._fleet_posterior(kernels, batched, grid64, BETA)
    S, _, cand, width, _ = torch.func.vmap(
        core._classify, in_dims=(0, None, None, None, None))(
            Q, f64, s64, torch.zeros_like(f64), BETA)
    masks = ~S
    masks[3] = False                                   # the planted one
    gidx = []
    for k in range(K):
        pool = cand[k] if int(cand[k].sum()) >= 64 else S[k]
        n_cand = int(pool.sum())
        check(n_cand >= 64, f"K3 fleet: campaign {k} has {n_cand} safe "
                            "points")
        order = core._visit_order(torch.where(pool, width[k],
                                              float("-inf")), n_cand)
        gidx.append(torch.cat([order[:16],
                               order[n_cand // 2:n_cand // 2 + 16]]))
    gidx = torch.stack(gidx)                            # (K, 32)
    valid = torch.ones((K, 32), dtype=torch.bool, device="cuda")
    valid[:, -4:] = False
    ucs = torch.stack([Q[k, gidx[k]][:, 1::2].T for k in range(K)])
    ops, solo = {}, {}
    for dt in (torch.float64, torch.float32):
        st = stack_campaign_states([tuple(core_state(s, dt) for s in p)
                                    for p in per])
        cast = (lambda a: a.to(dt))
        ops[dt] = fe.fleet_expander_operands(
            kernels, st, cast(grid64), masks, cast(mu), cast(sigma),
            cast(grid64)[gidx], cast(ucs), valid, BETA, cast(f64))
        solo[dt] = [fe.expander_operands(
            kernels, [core_state(s, dt) for s in per[k]], cast(grid64),
            masks[k], cast(mu[k]), cast(sigma[k]), cast(grid64)[gidx[k]],
            cast(ucs[k]), valid[k], BETA, cast(f64)) for k in range(K)]

    def at(o, delta):
        scal = o[9].clone()
        scal[:, 3] += delta * s64.to(scal.dtype).repeat(
            scal.shape[0] // G)
        return o[:9] + (scal, o[10])

    err64, wrong32, in_band, mixed, planted, unequal = 0.0, 0, 0, 0, 0, 0
    counts, neighbours = [], 0
    for delta in K3_SHIFTS:
        plain = fe.fused_expander_plain(*at(ops[torch.float64], delta))
        got = {dt: fe.fused_expander(*at(ops[dt], delta)) for dt in ops}
        each = {dt: torch.cat([fe.fused_expander(*at(o, delta))
                               for o in solo[dt]]) for dt in ops}
        decided = (fe.fused_expander_plain(*at(ops[torch.float64],
                                               delta + BAND))
                   == fe.fused_expander_plain(*at(ops[torch.float64],
                                                  delta - BAND)))
        torch.cuda.synchronize()
        vmask = valid.repeat_interleave(G, dim=0)
        hits = int(plain[vmask].sum())
        counts.append(hits)
        mixed += 0 < hits < int(vmask.sum())
        unequal += sum(int((got[dt] != each[dt]).sum()) for dt in ops)
        planted += sum(int(got[dt][3 * G:4 * G].sum()) for dt in ops)
        neighbours += int(got[torch.float64][2 * G:3 * G].sum()
                          + got[torch.float64][4 * G:5 * G].sum())
        err64 = max(err64, float((got[torch.float64] != plain).float().max()))
        wrong32 += int(((got[torch.float32] != plain) & decided).sum())
        in_band += int((~decided).sum())
    print(f"K3 fleet launch ({K} campaigns x {G} GPs, each campaign's own "
          f"mask and 32-slot chunk, campaign 3's mask all False) at fmin + "
          f"{list(K3_SHIFTS)} x scaling: plain hits per shift {counts}; "
          f"f64 predicates differing from the plain version {err64:g} "
          f"(limit 0); f32 differing outside the band {wrong32}, inside "
          f"{in_band}; fleet against {K} single-mask launches, predicates "
          f"differing {unequal} (limit 0); hits of the planted campaign "
          f"{planted} (limit 0), of its neighbours {neighbours}",
          flush=True)
    check(mixed > 0, "no K3 fleet launch had a plain predicate holding both "
                     "values")
    check(err64 == 0 and wrong32 == 0 and unequal == 0 and planted == 0,
          "the K3 fleet launch disagrees with its plain version, its "
          "single-mask launches or the planted campaign")
    check(neighbours > 0, "the planted campaign's neighbours never hit")
    st = stack_campaign_states([tuple(core_state(s, torch.float32) for s in p)
                                for p in per])
    timed = fe.fleet_expander_operands(
        kernels, st, grid64.float(), ~S, mu.float(), sigma.float(),
        grid64.float()[gidx], ucs.float(), valid, BETA, f64.float())
    return err64, timed, float((~S).sum()) / K


def core_state(state, dtype):
    """A float64 factor state cast to ``dtype`` (the loops' mirror)."""
    from safeopt_torch.gp.regression import GPState

    return GPState(*(t.to(dtype) if t.is_floating_point() else t
                     for t in state))


def swarm_fleet_inputs(dtype, K=None):
    """Phase 20 (d): K campaigns of phase 19's (a) G=2 state, campaign k
    from its own 5 observations (``swarm_data(5, seed=300 + k)``), GP
    capacity 16; per campaign (float64 factor states, its safe-set buffer
    in ``dtype`` reserved for FLEET_ITERS steps, its greedy point), and
    the optimizer of campaign 0 for the shared constants."""
    from safeopt_torch import SafeOptSwarm

    per, iters, greedy, opt = [], [], [], None
    for k in range(SWARM_FLEET_K if K is None else K):
        gps = swarm_gps(2, "cuda", dtype, data=swarm_data(5, seed=300 + k),
                        capacity=16)
        opt = SafeOptSwarm(gps, **swarm_problem(2))
        opt.reserve(FLEET_ITERS)
        per.append(tuple(g.factor_state() for g in gps))
        iters.append(opt._S_dev)
        greedy.append(torch.as_tensor(opt.greedy_point, dtype=dtype,
                                      device="cuda"))
    return per, iters, torch.stack(greedy), opt


def swarm_fleet_margin(kernels64, states, X, fmin, scaling):
    """The least scaled float64 margin ``(mu - beta sigma - fmin) /
    scaling`` of the rows X (float64, (r, d)) under one campaign's float64
    states (``swarm_margin``'s rule on the fleet's own factors)."""
    from safeopt_torch.gp.regression import gp_predict

    worst = math.inf
    for kern, st, fm, sc in zip(kernels64, states, fmin, scaling):
        if fm == -np.inf:
            continue
        mu, var = gp_predict(kern, st, X)
        lower = mu - BETA * torch.sqrt(var)
        worst = min(worst, float(((lower - fm) / sc).min()))
    return worst


def drive_swarm_fleet(smi):
    """Phase 20 (d): ``run_swarmopt_campaigns`` on SWARM_FLEET_K campaigns
    of phase 19's (a) G=2 state, FLEET_ITERS iterations replaying one CUDA
    graph a fleet step, every call under ``set_sync_debug_mode('error')``:
    step by step with each campaign's float64 safety checked (phase 19's
    rule), then at once (timed), against the batched eager run (bitwise),
    against each campaign's solo ``run_swarmopt_loop`` (float32 timed;
    float64 queries within 1e-9), no grid kernel launched. Returns the
    numbers the phase prints."""
    from safeopt_torch.algorithms.runner import run_swarmopt_loop
    from safeopt_torch.algorithms.swarm_opt import device_kernel
    from safeopt_torch.algorithms.swarm_opt_fused import stream_layout
    from safeopt_torch.parallel import (run_swarmopt_campaigns,
                                        stack_campaign_states)

    K, n = SWARM_FLEET_K, FLEET_ITERS
    zero_launches()

    def objectives():
        return (lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x)),
                lambda x: 1.0 - 0.05 * torch.sum(x * x))

    def fleet(dtype, states, iters, greedy, blb, t0, steps, graphs,
              graph=True):
        opt = consts[dtype]
        torch.cuda.synchronize()
        start = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if graph else 0)
        try:
            res = run_swarmopt_campaigns(
                tuple(g.kern for g in opt.gps), states, iters,
                opt.optimal_velocities, opt._bounds_arr, opt.fmin,
                opt.scaling, [0.0, 0.0], [BETA] * steps, greedy, blb,
                streams[dtype][:, t0:t0 + steps], normals[:, t0:t0 + steps],
                objectives=objectives(), n_iter=steps,
                swarm_size=opt.swarm_size, max_iters=opt.max_iters,
                noise_std=SWARM_FLEET_NOISE, graph=graph, graph_cache=graphs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - start) * 1e3

    inputs, consts, streams = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        inputs[dtype] = swarm_fleet_inputs(dtype)[:3]
        consts[dtype] = opt = swarm_fleet_inputs(dtype, K=1)[3]
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(
        opt.swarm_size, opt.max_iters, opt.gp.input_dim))
    rng = np.random.default_rng(21)
    uniforms = rng.uniform(size=(K, n, n_u))
    normals = torch.tensor(rng.normal(size=(K, n, 2)), dtype=torch.float64,
                           device="cuda")
    for dtype in consts:
        streams[dtype] = torch.tensor(uniforms, dtype=dtype, device="cuda")
    f32, f64 = torch.float32, torch.float64
    per, iters, greedy = inputs[f32]
    kernels64 = tuple(device_kernel(g.kern, f64, "cuda")
                      for g in consts[f32].gps)
    fmin, scaling = consts[f32].fmin, consts[f32].scaling
    ninf = torch.full((K,), -np.inf, dtype=f32, device="cuda")

    # step by step: one replay a call, each campaign's float64 safety
    graphs = {}
    states = stack_campaign_states(per)
    sstate = stack_campaign_states(iters)
    g_pt, blb = greedy, ninf
    certified = [set(map(tuple, it.S[:int(it.count)].double().cpu()
                         .numpy())) for it in iters]
    step_xs, step_ms, worst, held_below = [], [], math.inf, 0
    for t in range(n):
        res, ms = fleet(f32, states, sstate, g_pt, blb, t, 1, graphs)
        step_ms.append(ms)
        S_new = res.iter_state.S.double().cpu().numpy()
        c_new = res.iter_state.count.cpu().numpy()
        x = res.xs[:, 0]
        for k in range(K):
            before = set(map(tuple, sstate.S[k, :int(sstate.count[k])]
                             .double().cpu().numpy()))
            camp = tuple(type(st)(*(f[k] for f in st)) for st in states)
            new = np.array([r for r in S_new[k, :c_new[k]]
                            if tuple(r) not in before])
            if len(new):
                m = swarm_fleet_margin(kernels64, camp, torch.tensor(
                    new, dtype=f64, device="cuda"), fmin, scaling)
                check(m >= -BAND, f"swarm fleet campaign {k} step {t}: a "
                                  f"row added to the safe set has the "
                                  f"float64 margin {m:.3e}")
                certified[k].update(map(tuple, new))
            m = swarm_fleet_margin(kernels64, camp, x[k:k + 1], fmin,
                                   scaling)
            held = tuple(x[k].to(f32).double().cpu().numpy()) in before
            check(m >= -BAND or held, f"swarm fleet campaign {k} step {t}: "
                                      f"the query has the float64 margin "
                                      f"{m:.3e} and is no held row")
            worst = min(worst, m)
            held_below += held and m < -BAND
        step_xs.append(x)
        states, sstate = res.states, res.iter_state
        g_pt, blb = res.iter_state.greedy, res.best_lower_bounds[:, -1]
    for k in range(K):
        rows = set(map(tuple, sstate.S[k, :int(sstate.count[k])].double()
                       .cpu().numpy()))
        check(rows <= certified[k], f"swarm fleet campaign {k}: "
                                    f"{len(rows - certified[k])} safe-set "
                                    "rows never passed the float64 test")
    check(len(graphs) == 1, f"the swarm fleet captured {len(graphs)} graphs")
    stepwise = torch.stack(step_xs, dim=1)

    # at once, replaying the cached graph; then the batched eager run
    whole, whole_ms = fleet(f32, stack_campaign_states(per),
                            stack_campaign_states(iters), greedy, ninf, 0, n,
                            graphs)
    eager, eager_ms = fleet(f32, stack_campaign_states(per),
                            stack_campaign_states(iters), greedy, ninf, 0, n,
                            None, graph=False)
    check(torch.equal(whole.xs, stepwise), "the swarm fleet at once differs "
                                           "from its step-by-step run")
    bitwise = (torch.equal(whole.xs, eager.xs)
               and torch.equal(whole.iter_state.S, eager.iter_state.S)
               and torch.equal(whole.best_lower_bounds,
                               eager.best_lower_bounds))
    check(bitwise, f"the swarm fleet's graph and eager runs differ: queries "
                   f"{float((whole.xs - eager.xs).abs().max()):.3e} apart")
    check(whole.host_syncs.sum() == 0 and bool((whole.num_safe_min > 0)
                                               .all()),
          f"swarm fleet: host syncs {whole.host_syncs.tolist()}, safe "
          f"counts {whole.num_safe_min.tolist()}")
    prof = profile_device(lambda: fleet(f32, stack_campaign_states(per),
                                        stack_campaign_states(iters), greedy,
                                        ninf, 0, 2, graphs))

    # each campaign alone: float32 (timed) and float64 (queries)
    solo_graphs = {f32: {}, f64: {}}

    def solo(dtype, k, steps):
        opt = consts[dtype]
        p, it, gr = inputs[dtype]
        torch.cuda.synchronize()
        start = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = run_swarmopt_loop(
                tuple(g.kern for g in opt.gps), p[k], it[k],
                opt.optimal_velocities, opt._bounds_arr, opt.fmin,
                opt.scaling, [0.0, 0.0], [BETA] * steps, gr[k], -np.inf,
                streams[dtype][k, :steps], normals[k, :steps],
                objectives=objectives(), n_iter=steps,
                swarm_size=opt.swarm_size, max_iters=opt.max_iters,
                noise_std=SWARM_FLEET_NOISE, graph_cache=solo_graphs[dtype])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - start) * 1e3

    solo(f32, 0, 1)                         # the solo graph's capture
    solo_ms = 0.0
    for k in range(K):
        res, ms = solo(f32, k, n)
        solo_ms += ms
    p64, it64, gr64 = inputs[f64]
    fleet64, _ = fleet(f64, stack_campaign_states(p64),
                       stack_campaign_states(it64), gr64,
                       torch.full((K,), -np.inf, dtype=f64, device="cuda"),
                       0, n, {})
    err64 = 0.0
    for k in range(K):
        res, _ = solo(f64, k, n)
        err64 = max(err64, float((fleet64.xs[k] - res.xs).abs().max()))
    check(err64 <= SWARM_F64_TOL, f"swarm fleet float64: queries {err64:.3e}"
                                  " from the solo loops'")
    launches = read_launches()
    check(not any(launches.values()),
          f"the swarm fleet launched grid kernels: {launches}")
    replay = float(np.median(step_ms[1:]))
    print(f"swarm fleet ({K} campaigns of (a) G=2, d=10, {n} iterations): "
          f"every call under set_sync_debug_mode('error'), one graph "
          f"captured; each campaign's queries and added rows safe by "
          f"float64 within the band or held rows ({held_below} held rows "
          f"below it; least query margin {worst:.4g}); graph and batched "
          f"eager bitwise equal; float64 queries within {err64:.3e} of the "
          f"solo loops' (limit {SWARM_F64_TOL:g}); grid-kernel launches "
          f"{launches}", flush=True)
    print(f"swarm fleet on {smi}: {whole_ms / n:.3f} ms per fleet iteration "
          f"replayed ({whole_ms / (n * K):.3f} per campaign-iteration; "
          f"step by step median {replay:.3f}) against the {K} solo loops' "
          f"{solo_ms / n:.3f} ms per iteration summed; batched eager "
          f"{eager_ms / n:.3f} ms per iteration; the capturing first step "
          f"{step_ms[0]:.3f} ms (host clock)", flush=True)
    device_line("swarm fleet replayed", prof, 2, smi)
    return dict(fleet_ms=whole_ms / n, solo_ms=solo_ms / n,
                eager_ms=eager_ms / n, capture_ms=step_ms[0],
                replay_ms=replay, profile=prof, err64=err64)


def check_k1_fleet(kernels, per, grid64):
    """Phase 20: K1's fleet launch (FLEET_K campaigns x 2 GPs, one launch)
    against its plain version, as ``check_k1_gps`` holds one campaign's:
    the float64 kernel within 1e-9 of the float64 plain version, the
    float32 decisions ``l > fmin`` equal outside the band. Returns (the
    float64 error, the float32 operands)."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.parallel import stack_campaign_states

    K = len(per)
    ops, got = {}, {}
    for dt in (torch.float64, torch.float32):
        st = stack_campaign_states([tuple(core_state(s, dt) for s in p)
                                    for p in per])
        ops[dt] = fp.fleet_interval_operands(kernels, st, grid64.to(dt),
                                             BETA)
        got[dt] = fp.fused_intervals(*ops[dt])
    p64 = fp.fused_intervals_plain(*ops[torch.float64])
    torch.cuda.synchronize()
    err64 = (got[torch.float64] - p64).abs().max().item()
    t = functools.partial(torch.tensor, dtype=torch.float64, device="cuda")
    fmin, scale = t(FMIN * K)[:, None], t(SCALING * K)[:, None]
    wrong, in_band = decisions_agree(got[torch.float32][:, 0].double(),
                                     p64[:, 0], fmin, scale)
    print(f"K1 fleet launch ({K} campaigns x {len(kernels)} GPs): f64 "
          f"max|kernel-plain|={err64:.3e} (limit 1e-9); f32 decisions "
          f"differing outside the {BAND:g} band={wrong} (limit 0; rows "
          f"inside the band: {in_band})", flush=True)
    check(err64 <= 1e-9, f"K1 fleet launch f64 error {err64}")
    check(wrong == 0, "K1 fleet launch f32 decisions differ outside the "
                      "band")
    return err64, ops[torch.float32]


def fleet_kernel_times(kernels, per, grid64, k1_ops, k3_ops32, U, smi):
    """Phase 20's kernel times: K1 over the fleet's 16 GPs and the K3 fleet
    launch (the float32 operands that ``check_k1_fleet`` and
    ``check_k3_fleet`` return), each against its plain version and its
    bound at the fleet's shape."""
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp

    K, G = len(per), len(kernels)
    N, d = grid64.shape
    n_obs = int(per[0][0].count)
    C = k3_ops32[6].shape[1]
    out = {}
    for name, kern, plain, (b_ms, b_by) in (
            ("K1 fleet", lambda: fp.fused_intervals(*k1_ops),
             lambda: fp.fused_intervals_plain(*k1_ops),
             interval_bound(torch.float32, K * G, N, d, 64, n_obs)),
            ("K3 fleet", lambda: fe.fused_expander(*k3_ops32),
             lambda: fe.fused_expander_plain(*k3_ops32),
             expander_bound(torch.float32, K * G, N, U, d, 64, n_obs, C,
                            masks=K))):
        out[name] = (cuda_ms(kern), cuda_ms(plain, reps=3, warmup=1), b_ms,
                     b_by)
        print(f"{name} float32 ({K} campaigns x {G} GPs) on {smi}: kernel "
              f"{out[name][0]:.4f} ms, plain {out[name][1]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), share of the bound "
              f"{b_ms / out[name][0]:.1%}", flush=True)
    return out


def drive_fleets(grid_np, smi):
    """Phase 20: the campaign fleets. Returns the numbers the kernels
    line takes."""
    from safeopt_torch import linearly_spaced_combinations

    grid64 = torch.tensor(grid_np, dtype=torch.float64, device="cuda")
    kernels, per = fleet_flagship_states()
    out = {"a": run_fleet_case(
        "(a) flagship", kernels, per, grid64, FMIN, SCALING,
        flag_objectives(), 32, FLEET_NOISE, smi, profile=True)}
    bench_grid = torch.tensor(linearly_spaced_combinations(
        [(-2.0, 2.0), (-2.0, 2.0)], 100), dtype=torch.float64, device="cuda")
    b_kernels, b_per = fleet_bench_states()
    out["b"] = run_fleet_case(
        "(b) the JAX bench's fleet", b_kernels, b_per, bench_grid, [0.5],
        [math.sqrt(2.0)], flag_objectives()[:1], 16, 0.0, smi)
    out["k1_err64"], k1_ops32 = check_k1_fleet(kernels, per, grid64)
    out["k3_err64"], k3_ops32, U = check_k3_fleet(kernels, per, grid64)
    out["times"] = fleet_kernel_times(kernels, per, grid64, k1_ops32,
                                      k3_ops32, U, smi)
    out["d"] = drive_swarm_fleet(smi)
    return out


# ---------------------------------------------------------------------------
# phase 21: the utilities (checkpoint and resume, deployment, sampling,
# profile_trace)
# ---------------------------------------------------------------------------

RESUME_ITERS = 4      # iterations before and after a checkpoint


def count_syncs(fn):
    """``(fn(), host syncs, their sites)``: ``fn()`` under
    ``torch.cuda.set_sync_debug_mode('warn')``, each synchronizing call's
    warning counted, its sites as ``{"file:line": count}``."""
    import collections
    import os
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    return out, sum(sites.values()), dict(sites)


def median_ms(fn, reps=10):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls,
    after one untimed call."""
    fn()
    return float(np.median([timed_ms(fn)[1] for _ in range(reps)]))


def resume_case(label, make, plant_fn, tmp, smi):
    """Phase 21 (a): 2 x RESUME_ITERS iterations of ``make()`` unbroken,
    against RESUME_ITERS, ``checkpoint.save``, ``checkpoint.load`` into a
    fresh object, RESUME_ITERS more: every query (and SafeOpt's
    intervals) bitwise equal. Returns the launches after the load."""
    import os

    from safeopt_torch import SafeOpt
    from safeopt_torch.utils import checkpoint

    def run(opt, steps, out):
        for t in steps:
            x = opt.optimize()
            out.append((np.asarray(x), opt.Q.copy()
                        if isinstance(opt, SafeOpt) else None))
            opt.add_new_data_point(x, plant_fn(t, x))

    n = RESUME_ITERS
    unbroken, resumed = [], []
    run(make(), range(2 * n), unbroken)
    opt = make()
    run(opt, range(n), resumed)
    path = os.path.join(tmp, label.replace(" ", "_") + ".npz")
    _, save_ms = timed_ms(lambda: checkpoint.save(opt, path))
    loaded, load_ms = timed_ms(lambda: checkpoint.load(path, device="cuda"))
    zero_launches()
    run(loaded, range(n, 2 * n), resumed)
    torch.cuda.synchronize()
    launches = read_launches()
    for t, ((x1, q1), (x2, q2)) in enumerate(zip(unbroken, resumed)):
        check(np.array_equal(x1, x2) and (q1 is None or np.array_equal(
            q1, q2)), f"resumed {label}: step {t} differs from the unbroken "
                      "run")
    print(f"resume {label} on {smi}: {n} + {n} iterations bitwise equal to "
          f"{2 * n} unbroken (queries"
          f"{' and intervals' if unbroken[0][1] is not None else ''}); save "
          f"{save_ms:.3f} ms, load {load_ms:.3f} ms (host, CUDA events), "
          f"{os.path.getsize(path)} bytes; launches after the load "
          f"{launches}", flush=True)
    return launches


def resume_fleet(tmp, smi):
    """Phase 21 (a): phase 20 (a)'s flagship fleet, 8 iterations of
    ``run_safeopt_campaigns`` in float32 against 4, ``save_state`` (the
    states and the noise's tail), ``load_state`` and 4 more: queries
    bitwise equal."""
    import os

    from safeopt_torch.parallel import (run_safeopt_campaigns,
                                        stack_campaign_states)
    from safeopt_torch.utils.checkpoint import load_state, save_state

    kernels, per = fleet_flagship_states()
    K, G, n = len(per), len(kernels), 2 * RESUME_ITERS
    t = functools.partial(torch.tensor, dtype=torch.float32, device="cuda")
    grid = t(np.asarray(fleet_grid(), dtype=float))
    noise = torch.tensor(np.random.default_rng(21).normal(size=(K, n, G)),
                         dtype=torch.float64, device="cuda")
    kw = dict(objectives=flag_objectives(), chunk=32, noise_std=0.05)

    def run(states, noise, n_iter):
        return run_safeopt_campaigns(kernels, states, grid, t(FMIN), BETA,
                                     t(SCALING), t([0.0] * G), noise,
                                     n_iter=n_iter, **kw)

    full = run(stack_campaign_states(per), noise, n)
    head = run(stack_campaign_states(per), noise[:, :n // 2], n // 2)
    path = os.path.join(tmp, "fleet.npz")
    _, save_ms = timed_ms(lambda: save_state(
        path, {"states": head.states, "noise": noise[:, n // 2:],
               "t": n // 2}))
    ck, load_ms = timed_ms(lambda: load_state(path, device="cuda"))
    tail = run(tuple(ck["states"]), ck["noise"], n // 2)
    check(torch.equal(torch.cat([head.xs, tail.xs], dim=1), full.xs),
          "the resumed fleet differs from the unbroken one")
    print(f"resume flagship fleet (K={K}) on {smi}: {n // 2} + {n // 2} "
          f"fleet iterations bitwise equal to {n} unbroken; save_state "
          f"{save_ms:.3f} ms, load_state {load_ms:.3f} ms, "
          f"{os.path.getsize(path)} bytes", flush=True)


def fleet_grid():
    """The flagship's grid."""
    from safeopt_torch import linearly_spaced_combinations

    return linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)


def flagship_opt(grid_np, **kw):
    """Phase 9's flagship ``SafeOpt`` on the card (float32)."""
    from safeopt_torch import SafeOpt

    gps = build_gps(np.random.default_rng(0), 50, 64, "cuda", None)
    return SafeOpt(gps, grid_np, fmin=FMIN, beta=BETA, scaling=SCALING,
                   expander_chunk=32, **kw)


def contextual_opt(params_np):
    """Phase 10's contextual ``SafeOpt`` on the card at context 0."""
    from safeopt_torch import SafeOpt

    opt = SafeOpt(context_gps(2, 240, 256, "cuda", None), params_np,
                  fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                  expander_chunk=32)
    opt.context = 0.0
    return opt


def step_args(opt):
    """``export_step``'s arguments for ``opt``'s step: its kernels with
    their hyperparameters on the card, its states, grid and constants,
    beta a 0-d tensor."""
    from safeopt_torch.utils.deployment import device_kernels

    grid = opt._grid()
    c = opt._step_consts()
    return (device_kernels(tuple(g.kern for g in opt.gps), "cuda"),
            tuple(g.state for g in opt.gps), grid, c["fmin"],
            torch.tensor(BETA, dtype=grid.dtype, device="cuda"),
            c["scaling"], c["threshold"])


def campaign_args(grid_np, dtype):
    """``export_campaign``'s arguments and keywords for the flagship, 8
    iterations (float64 factor states, the float64 grid, the noise), and
    the kernels as the live loop takes them (hyperparameters on the
    host)."""
    from safeopt_torch.utils.deployment import device_kernels

    n = 2 * RESUME_ITERS
    gps = build_gps(np.random.default_rng(0), 50, 64, "cuda", torch.float64)
    t = functools.partial(torch.tensor, dtype=dtype, device="cuda")
    noise = torch.tensor(np.random.default_rng(22).normal(size=(n, 2)),
                         dtype=torch.float64, device="cuda")
    kernels = tuple(g.kern for g in gps)
    args = (device_kernels(kernels, "cuda"),
            tuple(g.factor_state() for g in gps),
            torch.tensor(grid_np, dtype=torch.float64, device="cuda"),
            t(FMIN), t(BETA), t(SCALING), t([0.0, 0.0]), noise)
    return args, dict(objectives=flag_objectives(), n_iter=n, dtype=dtype,
                      chunk=32, noise_std=0.05), kernels


def swarm_campaign_args():
    """``export_swarm_campaign``'s arguments and keywords for phase 19's
    (a) G=2 swarm, 4 iterations, float32, on the uniforms of
    ``default_rng(23)``."""
    from safeopt_torch import SafeOptSwarm
    from safeopt_torch.algorithms.swarm_opt_fused import stream_layout
    from safeopt_torch.utils.deployment import device_kernels

    n = RESUME_ITERS
    opt = SafeOptSwarm(swarm_gps(2, "cuda", torch.float32, capacity=16),
                       **swarm_problem(2))
    opt.reserve(n)
    n_u = sum(int(np.prod(s)) for _, s in stream_layout(
        opt.swarm_size, opt.max_iters, 10))
    t = functools.partial(torch.tensor, dtype=torch.float32, device="cuda")
    args = (device_kernels(tuple(g.kern for g in opt.gps), "cuda"),
            tuple(g.factor_state() for g in opt.gps), opt._S_dev,
            t(opt.optimal_velocities), t(opt._bounds_arr), t(opt.fmin),
            t(opt.scaling), t([0.0, 0.0]), t([BETA] * n),
            t(opt.greedy_point), t(-np.inf),
            t(np.random.default_rng(23).uniform(size=(n, n_u))))
    return args, dict(
        objectives=(lambda x: 2.0 * torch.exp(-0.5 * torch.sum(x * x)),
                    lambda x: 1.0 - 0.05 * torch.sum(x * x)),
        n_iter=n, swarm_size=opt.swarm_size, max_iters=opt.max_iters)


def export_artifacts(out_dir, grid_np, params_np):
    """Phase 21 (b)'s five exports, each written to ``out_dir`` as
    ``<name>.pt2``: ``{name: (export seconds, bytes)}``. ``chip_smoke.py
    --export-to DIR`` runs this in a process of its own, started with the
    run, so that the exports' tracing overlaps the build and phases 3-20
    on the host's other cores."""
    import os

    from safeopt_torch.utils.deployment import (export_campaign, export_step,
                                                export_swarm_campaign)

    jobs = {
        "flagship step": lambda: export_step(
            *step_args(flagship_opt(grid_np)), chunk=32),
        "contextual step": lambda: export_step(
            *step_args(contextual_opt(params_np)), chunk=32)}
    for dtype in (torch.float32, torch.float64):
        jobs[f"campaign {str(dtype)[6:]}"] = functools.partial(
            lambda dt: (lambda a, kw, _: export_campaign(*a, **kw))(
                *campaign_args(grid_np, dt)), dtype)
    jobs["swarm campaign"] = lambda: (
        lambda a, kw: export_swarm_campaign(*a, **kw))(*swarm_campaign_args())
    out = {}
    for name, job in jobs.items():
        start = time.perf_counter()
        blob = job()
        out[name] = (time.perf_counter() - start, len(blob))
        with open(os.path.join(out_dir, name.replace(" ", "_") + ".pt2"),
                  "wb") as fh:
            fh.write(blob)
    return out


def export_main(out_dir):
    """``chip_smoke.py --export-to DIR``: phase 21 (b)'s exports, their
    seconds and bytes printed as the last line (JSON)."""
    if not torch.cuda.is_available():
        print("chip_smoke exports: no CUDA device", file=sys.stderr)
        return 1
    from safeopt_torch import linearly_spaced_combinations

    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    params_np = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)
    print(json.dumps(export_artifacts(out_dir, grid_np, params_np)))
    return 0


def start_exports():
    """Start ``export_main`` in a child process writing to a fresh
    directory under the git-ignored ``build/``; both are removed when this
    process exits. Returns (child, directory)."""
    import atexit
    import os
    import shutil
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_exports_", dir=root)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--export-to", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def stop():
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(out_dir, ignore_errors=True)

    atexit.register(stop)
    return child, out_dir


def finish_exports(exports, smi):
    """Wait for the exports' child: ``{name: (seconds, bytes)}``."""
    child, _ = exports
    out, _ = child.communicate(timeout=900)
    check(child.returncode == 0, f"the exports' process failed "
                                 f"({child.returncode}):\n{out[-4000:]}")
    times = json.loads(out.strip().splitlines()[-1])
    for name, (secs, size) in times.items():
        print(f"export {name} on {smi} (its own process, beside phases "
              f"3-20): {secs:.3f} s, {size} bytes", flush=True)
    return times


def loaded_step_case(label, opt, path, smi, context=None):
    """Phase 21 (b): the exported step at ``path`` through ``load_step``
    and a call on the card: S, M, G, next_idx and Q equal to the live
    ``safeopt_step``'s; its host syncs are the walk's ``while_loop``
    condition reads (two more than its rounds); launch counts through the
    operators; the loaded step's ms against the live ``optimize()``'s.
    Returns (launches, rounds)."""
    from safeopt_torch.algorithms.safe_opt_core import safeopt_step
    from safeopt_torch.utils.deployment import load_step

    args = step_args(opt)
    kernels = tuple(g.kern for g in opt.gps)
    c = opt._step_consts()
    served = load_step(path)
    served(*args)                       # the first launch of each kernel
    zero_launches()
    out, syncs, sites = count_syncs(lambda: served(*args))
    torch.cuda.synchronize()
    launches = read_launches()
    live, live_syncs, live_sites = count_syncs(lambda: safeopt_step(
        kernels, args[1], args[2], c["fmin"], BETA, c["scaling"],
        c["threshold"], chunk=opt._expander_chunk))
    for name in ("Q", "S", "M", "G", "next_idx"):
        check(torch.equal(getattr(out, name), getattr(live, name)),
              f"the loaded {label} step's {name} differs from the live one")
    rounds = int(out.walk_chunks)
    # every host read of the loaded step is its while_loop's condition:
    # PyTorch's eager while_loop reads it before the loop, before each
    # round and after the last
    check(rounds == live.walk_chunks and syncs == rounds + 2 and all(
        site.startswith("while_loop.py:") for site in sites),
          f"the loaded {label} step walked {rounds} rounds (live "
          f"{live.walk_chunks}) with host syncs at {sites}")
    kw = {} if context is None else {"context": context}
    loaded_ms = median_ms(lambda: served(*args))
    live_ms = median_ms(lambda: opt.optimize(**kw))
    _, opt_syncs, _ = count_syncs(lambda: opt.optimize(**kw))
    print(f"loaded {label} step on {smi}: equal to the live step (S, M, G, "
          f"next_idx, Q bitwise), {rounds} walk rounds, launches "
          f"{launches}; host syncs: loaded {syncs} (all the while_loop's "
          f"condition reads: {sites}), live safeopt_step {live_syncs} "
          f"({live_sites}), live optimize() {opt_syncs}; median ms (CUDA "
          f"events, 10 calls): loaded {loaded_ms:.3f}, live optimize() "
          f"{live_ms:.3f}", flush=True)
    return launches, rounds


def loaded_campaign_case(grid_np, path, dtype, smi):
    """Phase 21 (b): the exported flagship campaign at ``path`` against
    ``run_safeopt_loop`` on the same noise: next_idx and queries equal; ms
    per iteration of each. Returns its launches."""
    from safeopt_torch.algorithms.runner import run_safeopt_loop
    from safeopt_torch.utils.deployment import load_step

    args, kw, kernels = campaign_args(grid_np, dtype)
    served = load_step(path)
    served(*args)
    zero_launches()
    out, ms = timed_ms(lambda: served(*args))
    launches = read_launches()
    loop_args = (kernels, *args[1:4], BETA, *args[5:])
    run_safeopt_loop(*loop_args, **kw)
    ref, ref_ms = timed_ms(lambda: run_safeopt_loop(*loop_args, **kw))
    check(torch.equal(out.next_idx, ref.next_idx)
          and torch.equal(out.xs, ref.xs),
          f"the exported {dtype} campaign's queries differ from "
          "run_safeopt_loop's")
    n = kw["n_iter"]
    print(f"loaded campaign {str(dtype)[6:]} (flagship, {n} iterations) on "
          f"{smi}: queries equal to run_safeopt_loop's; ms per iteration "
          f"(CUDA events) exported {ms / n:.3f} against run_safeopt_loop's "
          f"{ref_ms / n:.3f}; walk rounds {out.walk_chunks.tolist()}, "
          f"launches {launches}", flush=True)
    return launches


def loaded_swarm_case(path, smi):
    """Phase 21 (b): the exported (a) G=2 swarm campaign at ``path``
    against the eager ``run_swarmopt_loop`` on the same streams: queries
    bitwise equal."""
    from safeopt_torch.algorithms.runner import run_swarmopt_loop
    from safeopt_torch.utils.deployment import load_step

    args, kw = swarm_campaign_args()
    start = time.perf_counter()
    served = load_step(path)
    load_s = time.perf_counter() - start
    zero_launches()
    out, ms = timed_ms(lambda: served(*args))
    check(not any(read_launches().values()),
          "the exported swarm campaign launched a grid kernel")
    ref, ref_ms = timed_ms(lambda: run_swarmopt_loop(*args, graph=False,
                                                     **kw))
    check(torch.equal(out.xs, ref.xs),
          "the exported swarm campaign's queries differ from the eager "
          "loop's")
    n = kw["n_iter"]
    print(f"loaded swarm campaign ((a) G=2, {n} iterations) on {smi}: load "
          f"{load_s:.3f} s; queries bitwise equal to eager "
          f"run_swarmopt_loop's; ms per iteration (CUDA events) exported "
          f"{ms / n:.3f} against eager {ref_ms / n:.3f}", flush=True)


def sampling_case(grid_np, smi):
    """Phase 21 (c): an RBF prior path drawn on ``examples/example_2d.py``'s
    grid (30 points per dimension on [-5, 5]^2), evaluated at the
    flagship's 1e6 points on the card in float64 and on the CPU (in
    chunks): within 1e-9. The draw's host ms and the evaluation's device
    ms."""
    from safeopt_torch import RBF, sample_gp_function

    kern = RBF(2, variance=2.0, lengthscale=1.0, ARD=True)
    bounds = [(-5.0, 5.0), (-5.0, 5.0)]
    start = time.perf_counter()
    f = sample_gp_function(kern, bounds, 0.05 ** 2, 30, seed=0,
                           device="cuda", dtype=torch.float64)
    draw_ms = (time.perf_counter() - start) * 1e3
    x = torch.tensor(grid_np, dtype=torch.float64, device="cuda")
    f(x[:10], noise=False)
    y, eval_ms = timed_ms(lambda: f(x, noise=False))
    fc = sample_gp_function(kern, bounds, 0.05 ** 2, 30, seed=0,
                            device="cpu")
    yc = torch.cat([fc(grid_np[s:s + 100_000], noise=False)
                    for s in range(0, grid_np.shape[0], 100_000)])
    err = float((y.cpu() - yc).abs().max())
    check(y.shape == (grid_np.shape[0], 1) and err <= 1e-9,
          f"the sampled path on the card differs from the CPU's by {err}")
    print(f"sample_gp_function on {smi}: 900-point RBF draw {draw_ms:.3f} "
          f"ms (host), evaluation at 1e6 points {eval_ms:.3f} ms (CUDA "
          f"events), float64 card against CPU max |dy| {err:.3e}",
          flush=True)


def profile_case(opt, tmp, smi):
    """Phase 21 (d): ``profile_trace`` around one flagship ``optimize()``:
    the trace file exists and names K1's CUDA kernel, and K3's when the
    step walked."""
    import os

    from safeopt_torch.utils.observability import profile_trace

    log_dir = os.path.join(tmp, "trace")
    with profile_trace(log_dir):
        opt.optimize()
    path = os.path.join(log_dir, "trace.json")
    check(os.path.exists(path), "profile_trace wrote no trace")
    with open(path) as fh:
        kernels = sorted({e["name"] for e in json.load(fh)["traceEvents"]
                          if e.get("cat") == "kernel"})
    walked = opt.stats.last.walk_chunks
    k1 = any("intervals_kernel" in k for k in kernels)
    k3 = any("expander_kernel" in k for k in kernels)
    check(k1 and (k3 or walked == 0),
          f"the trace names K1's kernel: {k1}, K3's: {k3} (walk chunks "
          f"{walked}); its {len(kernels)} kernels: {kernels}")
    print(f"profile_trace on {smi}: {os.path.getsize(path)} bytes, "
          f"{len(kernels)} kernel names, intervals_kernel (K1) and "
          f"expander_kernel (K3; {walked} walk chunks) among them",
          flush=True)


def drive_utilities(grid_np, params_np, smi, exports):
    """Phase 21; ``exports`` is ``start_exports()``'s (child, directory).
    Returns the launches through K1-K4's operators over the loaded steps
    and the exported campaigns."""
    import os
    import shutil
    import tempfile

    from safeopt_torch import SafeOpt, SafeOptSwarm

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_utilities_", dir=root)
    try:
        def flag_plant(t, x):
            return plant(np.random.default_rng(1000 + t), x)

        def sparse_plant(t, x):
            return flag_plant(t, x)[:, :1]

        # (a) resume -------------------------------------------------------
        flagship = functools.partial(flagship_opt, grid_np)
        resume_case("flagship", flagship, flag_plant, tmp, smi)
        cert = resume_case("certified flagship", functools.partial(
            flagship, interval_precision="high"), flag_plant, tmp, smi)
        check(cert["K1-3p"] > 0, "the resumed certified run launched no "
                                 "K1-3p")
        resume_case("sparse m=64", lambda: SafeOpt(
            sparse_gp(64, "cuda", None), grid_np, fmin=SPARSE_FMIN,
            beta=BETA, scaling=SPARSE_SCALING, expander_chunk=32),
            sparse_plant, tmp, smi)
        resume_case("swarm (a) G=2", lambda: SafeOptSwarm(
            swarm_gps(2, "cuda", torch.float32, capacity=16),
            **swarm_problem(2)), lambda t, x: swarm_plant(x, 2), tmp, smi)
        resume_fleet(tmp, smi)

        # (b) deployment: the artifacts of the exports' process ------------
        finish_exports(exports, smi)
        path = functools.partial(os.path.join, exports[1])
        total = dict.fromkeys(read_launches(), 0)
        flag = flagship()
        launches, rounds = loaded_step_case(
            "flagship", flag, path("flagship_step.pt2"), smi)
        check(launches["K1"] == 1 and launches["K3"] == rounds
              and launches["K2"] == launches["K4"] == 0,
              f"the loaded flagship step launched {launches}, not K1 once "
              f"and K3 once a round ({rounds})")
        for key in total:
            total[key] += launches[key]
        launches, rounds = loaded_step_case(
            "contextual", contextual_opt(params_np),
            path("contextual_step.pt2"), smi, context=0.0)
        check(launches["K2"] == 2 and launches["K4"] == 2 * rounds
              and launches["K1"] == launches["K3"] == 0,
              f"the loaded contextual step launched {launches}, not K2 per "
              f"GP and K4 per GP a round ({rounds})")
        for key in total:
            total[key] += launches[key]
        for dtype in (torch.float32, torch.float64):
            launches = loaded_campaign_case(
                grid_np, path(f"campaign_{str(dtype)[6:]}.pt2"), dtype, smi)
            for key in total:
                total[key] += launches[key]
        loaded_swarm_case(path("swarm_campaign.pt2"), smi)

        # (c) sampling, (d) profile_trace ----------------------------------
        sampling_case(grid_np, smi)
        profile_case(flag, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"utilities: launches through K1-K4's operators (loaded steps "
          f"and exported campaigns) {total}", flush=True)
    return total


def main():
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from safeopt_torch import SafeOpt, linearly_spaced_combinations
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops._build import build_info, library, sass_opcodes
    from safeopt_torch.ops.topk import top_k

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    # phase 21's exports trace on the host beside the build and phases 3-20
    exports = start_exports()

    # 2. build ----------------------------------------------------------------
    start = time.perf_counter()
    library()
    info = build_info()
    print(f"build: {time.perf_counter() - start:.1f} s "
          f"(nvcc {info['seconds']:.1f} s, cached={info['cached']})",
          flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip().replace("ptxas info    : ", ""))
    # the float32 K1-3p and K2-3p (csrc/fused_intervals3.cu: static and
    # wide plans for K2-3p, three consumer warpgroups a block and one)
    # run on Hopper's warpgroup product: their SASS holds HGMMA
    hgmma = {k: v for k, v in sass_opcodes("HGMMA").items()
             if "intervals3_wg_kernel" in k
             or "intervals_plan3_wg_kernel" in k}
    for name, count in sorted(hgmma.items()):
        print(f"  sass: {name}: {count} HGMMA", flush=True)
    check(len(hgmma) == 6 and min(hgmma.values()) > 0,
          f"the wgmma instances of K1-3p/K2-3p hold no HGMMA: {hgmma}")

    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    grid64 = torch.tensor(grid_np, dtype=torch.float64, device="cuda")

    # 3. K1 against its plain version -----------------------------------------
    k1_err64, k1_err32 = check_k1("G=2 cap=64", 50, 64, 2, grid64, seed=0)
    check_k1("G=2 cap=512", 400, 512, 2, grid64, seed=512, spread=4.0)
    check_k1("G=2 cap=512, counts 20 and 300 in one launch", (20, 300), 512,
             2, grid64, seed=512, spread=4.0)
    check_k1("G=1 cap=1024 (600 obs, gram not resident)", 600, 1024, 1,
             grid64, seed=1024, spread=4.0)
    check_k1("G=1 cap=64", 50, 64, 1, grid64, seed=0)

    # 4. K3 against its plain version ------------------------------------------
    k3_err64, ops32 = check_k3("G=2 cap=64", 50, 64, 2, grid64, seed=0)
    err, k3_ops512 = check_k3("G=2 cap=512 (400 obs)", 400, 512, 2, grid64,
                              seed=512, spread=4.0)
    k3_err64 = max(k3_err64, err)
    err, _ = check_k3("G=2 cap=512, counts 20 and 300 in one launch",
                      (20, 300), 512, 2, grid64, seed=512)
    k3_err64 = max(k3_err64, err)
    err, _ = check_k3("G=1 cap=1024 (600 obs, M2 streamed)", 600, 1024, 1,
                      grid64, seed=1024)
    k3_err64 = max(k3_err64, err)
    gps32 = build_gps(np.random.default_rng(0), 50, 64, "cuda",
                      torch.float32)

    # 5. K2 against its plain version on contextual GPs ----------------------
    k2_err, _ = check_k2("1 GP cap=64 (50 obs)", 50, 64, grid64)
    n_k2 = 250          # K2 and K4 are timed at the 250-observation GP
    err, k2_ops32 = check_k2("1 GP cap=256 (250 obs, factor streamed)", n_k2,
                             256, grid64)
    k2_err = max(k2_err, err)
    err, _ = check_k2("1 GP cap=1024 (600 obs, gram not resident)", 600,
                      1024, grid64)
    k2_err = max(k2_err, err)
    err, _ = check_k2("Sum with Bias and Cosine leaves, cap=64", 50, 64,
                      grid64, variant="extra")
    k2_err = max(k2_err, err)
    err, k2_nine_ops32 = check_k2("the contextual kernel as nine leaves "
                                  "(wide plan), cap=256 (250 obs)", n_k2,
                                  256, grid64, variant="nine")
    k2_err = max(k2_err, err)

    # 6. K4 against its plain version on contextual candidates ---------------
    k4_err, k4_ops32 = check_k4(grid64)
    k4_err = max(k4_err, check_k4(grid64, variant="nine")[0])

    # 7. K5: exact top-k on the card ------------------------------------------
    ties = torch.tensor(np.random.default_rng(5).integers(0, 5, 1_000_000),
                        dtype=torch.float32, device="cuda")
    for key, k in ((ties, 32), (ties, 4096),
                   (torch.full((1_000_000,), float("-inf"), device="cuda"),
                    32)):
        v, i = top_k(key, k)
        vs, is_ = torch.sort(key.cpu(), descending=True, stable=True)
        check(torch.equal(v.cpu(), vs[:k]) and torch.equal(i.cpu(), is_[:k]),
              f"top_k(k={k}) differs from a stable sort")
    print("K5 top_k: massive ties (k=32, 4096) and all -inf match a stable "
          "sort", flush=True)

    # 8. the interval-stage experiments B1-B5 ---------------------------------
    from safeopt_torch.ops import interval_experiments as ie
    from tools_torch import bench_interval_experiments as bx

    f32, f64 = torch.float32, torch.float64
    exp_ops = {dt: cap512_operands(dt, grid_np) for dt in (f64, f32)}
    exp_errs = check_experiments("G=2 cap=512 (400 obs)", exp_ops[f64],
                                 exp_ops[f32])
    flag_ops = [fp.interval_operands(
        [g.kern for g in gps], [g.state for g in gps], grid64.to(dt), BETA)
        for dt in (f64, f32)
        for gps in [build_gps(np.random.default_rng(0), 50, 64, "cuda", dt)]]
    for name, err in check_experiments("G=2 cap=64", *flag_ops).items():
        exp_errs[name] = max(exp_errs[name], err)
    zero_launches()
    exp_results = bx.run(exp_ops[f32], EXPERIMENT_REPS)
    torch.cuda.synchronize()
    exp_launches = experiment_launches()
    check(all(n > 0 for n in exp_launches.values()),
          f"an experiment kernel was never launched on its path: "
          f"{exp_launches}")
    check(all(v["bitexact"] for v in exp_results["B1"]["variants"])
          and all(v for k, v in exp_results["B1"].items()
                  if k.endswith("_bitexact"))
          and all(exp_results["B4"][limb]["hoisted_bitexact"]
                  for limb in ie.LIMBS),
          "the experiment path lost K1's bits (B1), K1-3p's (B1-3p) or "
          "B4's limb pair")
    print(f"experiment path (the five harnesses, cap 512, float32, "
          f"{EXPERIMENT_REPS} reps): launches {exp_launches}", flush=True)
    for name, res in exp_results.items():
        print(f"  {name}: {json.dumps(res)}", flush=True)

    # 9. the flagship path ----------------------------------------------------
    def flagship(device, dtype):
        gps = build_gps(np.random.default_rng(0), 50, 64, device, dtype)
        return SafeOpt(gps, grid_np, fmin=FMIN, beta=BETA, scaling=SCALING,
                       expander_chunk=32)

    ref = flagship("cpu", torch.float64)        # plain path, float64
    ref.optimize()
    plant_rng = np.random.default_rng(1)
    opt_f = flagship("cuda", None)              # float32 on the card
    launches, opt_ms, add_ms, walked, maximum = drive(
        opt_f, ref, "flagship", lambda x, c: plant(plant_rng, x),
        [None] * 10, SCALING, opt_f.get_maximum)
    check(launches["K1"] > 0, "K1 was never launched on the flagship path")
    check(launches["K3"] > 0 or walked == 0,
          "the walk ran but K3 was never launched")
    check(not any(experiment_launches().values()),
          "the flagship path launched an experiment kernel")
    print(f"flagship path: 10 iterations, |S| last="
          f"{opt_f.stats.last.safe_count}, walk chunks={walked}, launches "
          f"{launches}, get_maximum x={np.round(maximum[0], 4).tolist()} "
          f"lb={maximum[1]:.4f}", flush=True)

    # 10. the contextual path -------------------------------------------------
    params_np = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)
    contexts = [0.0] * 5 + [0.1] * 5

    def contextual(device, dtype):
        return SafeOpt(context_gps(2, 240, 256, device, dtype), params_np,
                       fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                       expander_chunk=32)

    ctx_ref = contextual("cpu", torch.float64)
    ctx_ref.optimize(context=contexts[0])
    opt_c = contextual("cuda", None)
    check(np.allclose(opt_c.scaling, math.sqrt(2.0)),
          f"scaling='auto' gave {opt_c.scaling}, not the product's prior "
          "std sqrt(2)")
    ctx_rng = np.random.default_rng(2)
    ctx_launches, ctx_opt_ms, ctx_add_ms, ctx_walked, ctx_max = drive(
        opt_c, ctx_ref, "contextual",
        lambda x, c: (context_truth([[float(x[0]), c]])
                      + 0.05 * ctx_rng.normal(size=(1, 2))),
        contexts, opt_c.scaling, lambda: opt_c.get_maximum(context=0.1))
    check(ctx_launches["K2"] > 0,
          "K2 was never launched on the contextual path")
    check(ctx_launches["K4"] > 0 or ctx_walked == 0,
          "the contextual walk ran but K4 was never launched")
    check(ctx_launches["K1"] == ctx_launches["K3"] == 0,
          "the contextual path launched the stationary kernels")
    check(not any(experiment_launches().values()),
          "the contextual path launched an experiment kernel")
    print(f"contextual path: 10 iterations (context 0.0 x5, 0.1 x5), |S| "
          f"last={opt_c.stats.last.safe_count}, walk chunks={ctx_walked}, "
          f"launches {ctx_launches}, get_maximum(context=0.1) x="
          f"{np.round(ctx_max[0], 4).tolist()} lb={ctx_max[1]:.4f}",
          flush=True)

    # 11. K1-3p and K2-3p against their plain versions ---------------------
    k1_3p_ops = {}
    for label, args in (("G=2 cap=64", (50, 64, 2, grid64, 0)),
                        ("G=2 cap=512", (400, 512, 2, grid64, 512, 4.0)),
                        ("G=2 cap=512, counts 20 and 300 in one launch",
                         ((20, 300), 512, 2, grid64, 512, 4.0)),
                        ("G=1 cap=1024 (600 obs, gram not resident)",
                         (600, 1024, 1, grid64, 1024, 4.0))):
        ops = k1_operands(*args)
        G = ops[f32][2].shape[0]
        k1_3p_ops[label] = ops
        err, dq, _ = check_three_pass(label, ops, FMIN[:G], SCALING[:G])
        if label == "G=2 cap=512":
            k1_3p_err, k1_3p_dq = err, dq
    k2_3p_err = 0.0
    for label, n_obs, cap, variant in (
            ("1 GP cap=256 (250 obs)", n_k2, 256, None),
            ("Sum with Bias and Cosine leaves, cap=64", 50, 64, "extra"),
            ("the contextual kernel as nine leaves (wide plan), cap=256",
             n_k2, 256, "nine")):
        ops = {}
        for dt in (f64, f32):
            gp = context_gps(1, n_obs, cap, "cuda", dt, variant=variant)[0]
            ops[dt] = fp.interval_plan_operands(gp.kern, gp.state,
                                                grid64.to(dt), BETA)
        err, dq, _ = check_three_pass(
            label, ops, CTX_FMIN[:1],
            [math.sqrt(float(ops[f64][7][1]))], what="plan")
        k2_3p_err = max(k2_3p_err, err)
        if variant is None:
            k2_3p_ops, k2_3p_dq = ops[f32], dq

    # 12. the certified paths -------------------------------------------------
    cert_rng = np.random.default_rng(5)

    def cap512(device, dtype, **kw):
        gps = build_gps(np.random.default_rng(512), 400, 512, device, dtype,
                        spread=4.0)
        return SafeOpt(gps, grid_np, fmin=FMIN, beta=BETA, scaling=SCALING,
                       expander_chunk=32, **kw)

    def contextual_cert(device, dtype, n_obs=240, spread=3.0, **kw):
        return SafeOpt(context_gps(2, n_obs, 256, device, dtype,
                                   spread=spread), params_np,
                       fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                       expander_chunk=32, **kw)

    def ctx_plant(x, c):
        return (context_truth([[float(x[0]), c]])
                + 0.05 * cert_rng.normal(size=(1, 2)))

    # the budget is 0.55 of the grid (REFINE_BAND_SHARE, the wgmma
    # K1-3p's break-even against K1). The contextual state's safe rows
    # have nearly equal widths: its refine band holds 640,000 rows of the
    # 1e6 at context 0, past the budget (those steps take the full float32
    # pass), and 220,000-550,000 at context 0.1, mostly within it; early
    # in a contextual run (20 observations near the seed, context 0) the
    # band (110,000-310,000 rows) fits on every step, and K2-3p's rows go
    # through the refinement
    certified = {
        "cap 512": drive_certified(
            "cap 512", cap512, lambda x, c: plant(cert_rng, x), [None] * 10,
            min_refined=10),
        "contextual": drive_certified(
            "contextual", contextual_cert, ctx_plant, contexts,
            min_refined=2),
        "contextual, 20 obs": drive_certified(
            "contextual, 20 observations in [-0.5, 0.5]",
            functools.partial(contextual_cert, n_obs=20, spread=0.5),
            ctx_plant, [0.0] * 10, min_refined=10)}
    for name, kern3, kern1, per_step in (
            ("cap 512", "K1-3p", "K1", 1), ("contextual", "K2-3p", "K2", 2),
            ("contextual, 20 obs", "K2-3p", "K2", 2)):
        for oracle, (n, c_ms, p_ms, _, _) in certified[name].items():
            check(n[kern3] == 10 * per_step and n[kern1] == 10 * per_step,
                  f"{name} certified ({oracle}): {kern3} launched "
                  f"{n[kern3]} times and {kern1} {n[kern1]}, not "
                  f"{10 * per_step} each")
            other = ("K2", "K2-3p") if kern1 == "K1" else ("K1", "K1-3p")
            check(n[other[0]] == n[other[1]] == 0,
                  f"{name} certified ({oracle}) launched {other}")
            print(f"{name} certified path ({oracle} oracle) times (CUDA "
                  f"events, iterations 2-10): median optimize() "
                  f"{float(np.median(c_ms[1:])):.3f} ms against the float32 "
                  f"plain twin's {float(np.median(p_ms[1:])):.3f} ms",
                  flush=True)

    # 13. mixed routes: GP 1 on the eager route ------------------------------
    mixed_ms, mixed_eager_ms = drive_mixed(grid_np)

    # 14. run_safeopt_loop against the blocking loop --------------------------
    runner = {
        "flagship": drive_runner("flagship", lambda: flagship("cuda", None),
                                 flag_objectives(), grid_np, [None] * 10),
        "contextual": drive_runner("contextual",
                                   lambda: contextual("cuda", None),
                                   ctx_objectives(), params_np, contexts)}
    check(runner["flagship"][5]["K1"] == 10
          and runner["contextual"][5]["K2"] == 20,
          "run_safeopt_loop did not launch K1 (flagship) or K2 "
          "(contextual) once a step per group")

    # 15. run_lagged_campaign, pipelined against serial -----------------------
    lagged = drive_lagged(grid_np)

    # 16. the sparse path -----------------------------------------------------
    sparse_errs = check_sparse_kernels(grid64)
    sparse_paths, sparse_cert = drive_sparse(grid_np, grid64)

    # 17. hyperparameter fits on the card -------------------------------------
    fit_s = drive_fits()

    # 18. times ---------------------------------------------------------------
    for label, o_ms, a_ms, n in (("flagship", opt_ms, add_ms,
                                  grid_np.shape[0]),
                                 ("contextual", ctx_opt_ms, ctx_add_ms,
                                  params_np.shape[0])):
        med_opt = float(np.median(o_ms[1:]))
        print(f"{label} path times (CUDA events, iterations 2-10): median "
              f"optimize() {med_opt:.3f} ms, median add_new_data_point() "
              f"{float(np.median(a_ms[1:])):.3f} ms; grid points/s "
              f"{n / (med_opt / 1e3):.4g}", flush=True)
    ops32_k1 = fp.interval_operands(
        [g.kern for g in gps32], [g.state for g in gps32],
        grid64.float(), BETA)
    N, d = grid_np.shape
    C = 32
    n_flag = int(gps32[0].state.count)
    leaves = plan_leaves(k2_ops32[4], k2_ops32[6])
    timed = {
        "K1": (lambda: fp.fused_intervals(*ops32_k1),
               lambda: fp.fused_intervals_plain(*ops32_k1),
               interval_bound(f32, 2, N, d, 64, n_flag)),
        "K3": (lambda: fe.fused_expander(*ops32),
               lambda: fe.fused_expander_plain(*ops32),
               expander_bound(f32, 2, N, int(ops32[1].sum()), d, 64, n_flag,
                              C)),
        "K3 cap=512": (lambda: fe.fused_expander(*k3_ops512),
                       lambda: fe.fused_expander_plain(*k3_ops512),
                       expander_bound(f32, 2, N, int(k3_ops512[1].sum()), d,
                                      512, 400, C)),
        "K2": (lambda: fp.fused_intervals_plan(*k2_ops32),
               lambda: fp.fused_intervals_plan_plain(*k2_ops32),
               interval_bound(f32, 1, N, d, 256, n_k2, leaves)),
        "K2 nine leaves (wide)": (
            lambda: fp.fused_intervals_plan(*k2_nine_ops32),
            lambda: fp.fused_intervals_plan_plain(*k2_nine_ops32),
            interval_bound(f32, 1, N, d, 256, n_k2,
                           plan_leaves(k2_nine_ops32[4], k2_nine_ops32[6]))),
        "K4": (lambda: fe.fused_expander_plan(*k4_ops32),
               lambda: fe.fused_expander_plan_plain(*k4_ops32),
               expander_bound(f32, 1, N, int(k4_ops32[1].sum()), d, 256,
                              n_k2, C, leaves)),
        "K1-3p": (lambda: fp.fused_intervals3(*k1_3p_ops["G=2 cap=512"][f32]),
                  lambda: fp.fused_intervals3_plain(
                      *k1_3p_ops["G=2 cap=512"][f32]),
                  split_bound("bf16", N, d, 512, 400, G=2)),
        "K1 cap=512": (lambda: fp.fused_intervals(
                           *k1_3p_ops["G=2 cap=512"][f32]),
                       lambda: fp.fused_intervals_plain(
                           *k1_3p_ops["G=2 cap=512"][f32]),
                       interval_bound(f32, 2, N, d, 512, 400)),
        "K2-3p": (lambda: fp.fused_intervals_plan3(*k2_3p_ops),
                  lambda: fp.fused_intervals_plan3_plain(*k2_3p_ops),
                  split_bound("bf16", N, d, 256, n_k2,
                              leaves=plan_leaves(k2_3p_ops[4],
                                                 k2_3p_ops[6]))),
    }
    times = {}

    def time_kernel(name, kernel, plain, bound_ms, bound_by, reps=10):
        times[name] = (cuda_ms(kernel, reps), cuda_ms(plain, reps), bound_ms,
                       bound_by)
        print(f"{name} float32: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), share of the bound "
              f"{bound_ms / times[name][0]:.1%}", flush=True)

    for name, (kernel, plain, (bound_ms, bound_by)) in timed.items():
        time_kernel(name, kernel, plain, bound_ms, bound_by)
    # K1 at phase 16's exact GP: G=1, 2000 observations, capacity 2048
    # (past the resident gram); its host factorization runs after the
    # other kernels' timings, which a busy host would lengthen
    exact = sparse_exact_gp("cuda", f32)
    ops2048 = fp.interval_operands([exact.kern], [exact.state],
                                   grid64.float(), BETA)
    time_kernel("K1 cap=2048 (exact GP, 2000 observations)",
                lambda: fp.fused_intervals(*ops2048),
                lambda: fp.fused_intervals_plain(*ops2048),
                *interval_bound(f32, 1, N, d, 2048, 2000), reps=3)

    # K1, K3 and K1-3p count their main paths' launches: the flagship's
    # (K1-3p: the cap-512 certified runs') and the sparse path's
    sparse_n = sparse_paths["sparse c=0"][0]
    sparse_3p = sum(r[0]["K1-3p"] for r in sparse_cert.values())
    k1_err64 = max([k1_err64] + [e[0] for e in sparse_errs.values()])
    k3_err64 = max([k3_err64] + [e[1] for e in sparse_errs.values()])
    print(f"main-path launches: K1 flagship {launches['K1']} + sparse "
          f"{sparse_n['K1']}; K3 flagship {launches['K3']} + sparse "
          f"{sparse_n['K3']}; K1-3p cap 512 certified "
          f"{sum(r[0]['K1-3p'] for r in certified['cap 512'].values())} + "
          f"sparse certified {sparse_3p}", flush=True)
    meta = {
        "K1": ("K1 fused_intervals", "fused_intervals.cu",
               "safeopt_tpu/ops/fused_posterior.py:454",
               launches["K1"] + sparse_n["K1"], k1_err64),
        "K3": ("K3 fused_expander", "fused_expander.cu",
               "safeopt_tpu/ops/fused_expander.py:233",
               launches["K3"] + sparse_n["K3"], k3_err64),
        "K2": ("K2 fused_intervals_plan", "fused_intervals_plan.cu",
               "safeopt_tpu/ops/fused_posterior.py:294", ctx_launches["K2"],
               k2_err),
        "K4": ("K4 fused_expander_plan", "fused_expander_plan.cu",
               "safeopt_tpu/ops/fused_expander.py:44", ctx_launches["K4"],
               k4_err),
    }
    meta["K1-3p"] = ("K1-3p fused_intervals3", "fused_intervals3.cu",
                     "safeopt_tpu/ops/fused_posterior.py:513",
                     sum(r[0]["K1-3p"] for r in certified["cap 512"].values())
                     + sparse_3p, k1_3p_err)
    meta["K2-3p"] = ("K2-3p fused_intervals_plan3", "fused_intervals3.cu",
                     "safeopt_tpu/ops/fused_posterior.py:313",
                     sum(r[0]["K2-3p"] for name in ("contextual",
                                                    "contextual, 20 obs")
                         for r in certified[name].values()),
                     k2_3p_err)
    kernels = []
    for key in ("K1", "K3", "K2", "K4", "K1-3p", "K2-3p"):
        name, src, replaces, n_launch, err = meta[key]
        k_ms, p_ms, b_ms, b_by = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"safeopt_torch/ops/csrc/{src}", "replaces": replaces,
            "launches": n_launch, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes these fused functions
            "library_ms": None})
    kernels[0]["max_abs_err_f32"] = k1_err32
    # K1 past the resident gram: the exact GP at capacity 2048
    kernels[0]["cap2048_ms"], kernels[0]["cap2048_plain_ms"], \
        kernels[0]["cap2048_bound_ms"], _ = times[
            "K1 cap=2048 (exact GP, 2000 observations)"]
    kernels[4]["max_scaled_err_f32_vs_f64"] = k1_3p_dq
    kernels[5]["max_scaled_err_f32_vs_f64"] = k2_3p_dq

    o32 = exp_ops[f32]
    n512 = int(o32[5][0, 3])
    one0, first = one_gp(o32), first_gp(o32)
    res = exp_results

    def ablation(ops, mode):
        return (lambda: ie.interval_ablation_plain(*ops, mode),
                ablation_bound(mode, f32, ops[2].shape[0], N, d, 512, n512))

    def split(limb):
        return (lambda: ie.intervals_split_plain(*one0, limb=limb),
                split_bound(limb, N, d, 512, n512))

    b_runs = {
        "B1": (res["B1"]["variants"][0]["ms"],
               lambda: fp.fused_intervals_plain(*o32),
               interval_bound(f32, 2, N, d, 512, n512)),
        "B2 gram_sums": (res["B2"]["gram_sums_ms"],
                         *ablation(o32, "gram_sums")),
        "B2 solve_rank1": (res["B2"]["solve_rank1_ms"],
                           *ablation(o32, "solve_rank1")),
        "B3": (res["B3"]["mu_from_gram_ms"],
               lambda: ie.intervals_mu_from_gram_plain(*o32),
               interval_bound(f32, 2, N, d, 512, n512)),
        "B4 bf16": (res["B4"]["bf16"]["inkernel_ms"], *split("bf16")),
        "B4 tf32": (res["B4"]["tf32"]["inkernel_ms"], *split("tf32")),
        "B5 no_product": (res["B5"]["no_product_ms"],
                          *ablation(first, "no_product")),
        "B5 epilogue": (res["B5"]["epilogue_ms"],
                        *ablation(first, "epilogue")),
        "B1-3p": (res["B1"][
                      f"3pass_mma_sync_{bx.layout_tag(0, 0, -1)}_ms"],
                  lambda: fp.fused_intervals3_plain(*o32),
                  split_bound("bf16", N, d, 512, n512, G=2)),
        "B2-3p solve_rank1": (res["B2"]["3pass_solve_only_ms"],
                              lambda: ie.interval_ablation_plain(
                                  *o32, "solve_rank1", three_pass=True),
                              split_bound("bf16", N, d, 512, n512, G=2,
                                          gram=False)),
        "B3-3p": (res["B3"]["3pass_mxu_emit_ms"],
                  lambda: ie.intervals_mu_from_gram_plain(*o32,
                                                          three_pass=True),
                  split_bound("bf16", N, d, 512, n512, G=2)),
    }
    b_meta = {    # the wrapper (and its mode) and the TPU kernel
        "B1": ("intervals_launch", "bench_interval_mosaic.py:73"),
        "B2 gram_sums": ("interval_ablation", "bench_interval_mosaic3.py:96"),
        "B2 solve_rank1": ("interval_ablation",
                           "bench_interval_mosaic3.py:104"),
        "B3": ("intervals_mu_from_gram", "bench_interval_mosaic4.py:95"),
        "B4 bf16": ("intervals_split", "bench_interval_variants.py:92"),
        "B4 tf32": ("intervals_split", "bench_interval_variants.py:92"),
        "B5 no_product": ("interval_ablation",
                          "bench_interval_ablation.py:49"),
        "B5 epilogue": ("interval_ablation", "bench_interval_ablation.py:49"),
        "B1-3p": ("intervals_launch", "bench_interval_mosaic.py:76"),
        "B2-3p solve_rank1": ("interval_ablation",
                              "bench_interval_mosaic3.py:114"),
        "B3-3p": ("intervals_mu_from_gram", "bench_interval_mosaic4.py:107"),
    }
    for name, (k_ms, plain, (b_ms, b_by)) in b_runs.items():
        p_ms = cuda_ms(plain, reps=3, warmup=1)
        print(f"{name} float32 (experiment path): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
              f"of the bound {b_ms / k_ms:.1%}", flush=True)
        wrapper, tpu = b_meta[name]
        key, _, mode = name.partition(" ")
        if key in ("B2", "B5") and mode in ("solve_rank1", "epilogue"):
            ops = o32 if mode == "solve_rank1" else first
            t_ms, t_by = ablation_bound(mode, f32, ops[2].shape[0], N, d,
                                        512, n512, prescribed=True)
            print(f"  {name}: the work the kernel is told to do (every row "
                  f"of V) bounds at {t_ms:.4f} ms ({t_by}), "
                  f"{t_ms / k_ms:.1%} of it", flush=True)
        kernels.append({
            "name": f"{key} {wrapper} {mode}".strip(), "route": "cuda",
            "source": "safeopt_torch/ops/csrc/interval_experiments.cu",
            "replaces": f"benchmarks/{tpu}", "launches": exp_launches[name],
            "max_abs_err": exp_errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    print(f"new paths on {smi} (CUDA events unless noted): mixed-route "
          f"optimize() median {float(np.median(mixed_ms[1:])):.3f} ms, "
          f"eager share {mixed_eager_ms / float(np.median(mixed_ms[1:])):.1%}"
          f"; run_safeopt_loop flagship {runner['flagship'][1]:.3f} ms/it "
          f"against blocking {runner['flagship'][2]:.3f}, contextual "
          f"{runner['contextual'][1]:.3f} against "
          f"{runner['contextual'][2]:.3f}; lagged campaign (host clock) "
          f"plain {lagged['plain'][True]:.3f} pipelined / "
          f"{lagged['plain'][False]:.3f} serial, certified "
          f"{lagged['certified'][True]:.3f} / "
          f"{lagged['certified'][False]:.3f} ms/it", flush=True)
    print(f"sparse paths and fits on {smi}: sparse m=64 optimize() median "
          + ", ".join(f"{name} {float(np.median(v[1][1:])):.3f} ms"
                      for name, v in sparse_paths.items())
          + "; add_new_data_point() median "
          + ", ".join(f"{name} {float(np.median(v[2][1:])):.3f} ms"
                      for name, v in sparse_paths.items())
          + f"; fits (host clock): card {fit_s['accel']:.3f} s, CPU "
          f"{fit_s['cpu']:.3f} s, sparse with moving inducing points "
          f"{fit_s['sparse']:.3f} s", flush=True)
    # 19. the swarm ---------------------------------------------------------
    swarm = drive_swarm(smi)
    print_swarm(swarm, smi)
    # 20. campaign fleets -----------------------------------------------------
    fleet = drive_fleets(grid_np, smi)
    for entry, key in ((kernels[0], "K1"), (kernels[1], "K3")):
        entry["launches"] += sum(fleet[case][dt]["launches"][key]
                                 for case in ("a", "b")
                                 for dt in ("float32", "float64"))
        k_ms, p_ms, b_ms, b_by = fleet["times"][f"{key} fleet"]
        entry.update(fleet_ms=k_ms, fleet_plain_ms=p_ms, fleet_bound_ms=b_ms,
                     fleet_bound_by=b_by)
    for entry, key in ((kernels[0], "k1_err64"), (kernels[1], "k3_err64")):
        entry["max_abs_err"] = max(entry["max_abs_err"], fleet[key])
    # 21. the utilities -------------------------------------------------------
    via_ops = drive_utilities(grid_np, params_np, smi, exports)
    for entry, key in zip(kernels[:4], ("K1", "K3", "K2", "K4")):
        entry["launches"] += via_ops[key]
        entry["op_launches"] = via_ops[key]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--export-to":
        sys.exit(export_main(sys.argv[2]))
    sys.exit(main())

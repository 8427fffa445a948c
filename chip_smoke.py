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
   and of the experiment kernels on their bodies
   (``csrc/interval_experiments3.cu``: B1-3p and B4, each limb format
   and cut, and B2-3p and B3-3p, resident with one and three warpgroups,
   tiled) holds HGMMA,
   Hopper's warpgroup tensor-core product;
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
   64 with 50 observations, capacity 256 with 250, capacity 512 with 400
   (float64 past its resident rows: the tiled body), capacity 1024 with
   600 (gram not resident: the tiled body), GP 0 of
   ``tools_torch/measure.py``'s ``context1024`` and ``context2048`` (600
   and 2000 observations over contexts in [-1, 1], capacity 1024 and
   2048: the tiled body), a Sum with a Bias leaf and a Cosine leaf on
   one column, and the contextual kernel written as a product of nine
   leaves at capacity 256 and at capacity 1024 with 600 observations
   (one leaf past the plan K2/K4 stage in static shared memory: their
   wide instances, resident and tiled); tolerances as K1's, and at
   ``context1024`` and ``context2048`` the float32 kernel also within
   ``float32_bound_plan(..., limb=None)`` of its function in float64 on
   the kernel's own gram (``plan_rows_on_kernel_gram``), a planted fault
   (the first 32 active rows of Lm dropped) past that bound;
6. K4 (expander predicate of one GP with a kernel algebra) as K3's
   check, on the contextual kernel's two GPs at capacity 256, and on the
   same GPs with the nine-leaf kernel (K4's wide instances);
7. K5 (exact top-k) on CUDA tensors with massive ties and all -inf;
8. the interval-stage experiments B1-B5
   (``safeopt_torch/ops/interval_experiments.py``) against their plain
   versions at the cap-512 state (G=2, 400 observations, N=1e6) and the
   flagship's cap 64, in float64 and float32: B1 (K1 at other launch
   layouts) bit-identical to K1 (in float64 at cap 512, where K1 runs
   its tiled body, to B1's automatic layout, within 1e-9 of K1); B2/B5 (ablations) and B3 (mu from the
   gram) to 1e-9 in float64 and in float32 within ``float32_bound``, the
   worst case of their float32 arithmetic, against the plain version in
   float64 on the same operands; B4 (the split-limb product on K1-3p's
   wgmma bodies, bf16 and tf32 limbs) in all four variants, also at
   ``measure.py``'s ``cap1024`` and ``cap2048`` (G=1, the tiled body):
   the limbs cut in the kernel and hoisted give the same bits (in bf16
   hoisted K1-3p's for the GP alone), within ``float32_bound`` of its
   plain version, both planted faults past it, the body each variant
   ran by kernel name, and its scaled error against the float64 plain
   rows printed beside K1's; beside each float32 bound its median and the
   rows' median |.|, and how far past it the rows of a kernel that drops
   each GP's first or last 32 active rows land (``drop_band``: B4's
   both, the others' first, past the bound); the harnesses' three-pass columns: B1-3p
   (K1-3p's own bodies at the caller's layout: float32 on its wgmma
   bodies, ``tools_torch/states.py`` ``LAYOUTS3``; float64 on
   ThreePassProduct, ``LAYOUTS``) bit-identical to K1-3p at every layout
   that keeps K1-3p's summation order, within the split bound of its
   plain version at the layouts with another count of consumer
   warpgroups (both planted faults past it), the body each float32
   layout ran by kernel name; B1-3p at its automatic layout (K1-3p's
   plain version), B2-3p (the rank-1 solve) and B3-3p (mu from the
   gram), in float32 on K1-3p's wgmma bodies, at cap 512 and 64 (the
   resident body) and at ``cap1024`` and ``cap2048`` (G=1, the tiled
   body), to 1e-9 in float64 and in float32 within their float32 bound
   of the plain version on the same operands, both planted faults past
   it (B2-3p's last one printed at ``cap2048``, where no worst-case
   bound of the rows sees it), the same bits twice, the body each ran by
   kernel name (B3-3p also with resident gram rows short of the
   capacity), and the max scaled |dQ| against the float64 rows and the
   decisions that differ from float64's outside the band (B1-3p's and
   B3-3p's |dQ| below ``refine_band - boundary_band`` and B3-3p's
   decisions equal to its plain version's outside the band, where the
   plain rows are under that slack; B2-3p's rank-1 rows are no SafeOpt
   intervals, and theirs is printed beside the plain version's own);
   B2's gram sums and B5's two modes (the gram-only body,
   ``csrc/gram_rows.cuh``) in float32 bit for bit the in-order sums of
   ``kernel_gram``'s entries (``ablation_in_order``) at cap 512, 64,
   ``cap1024`` and ``cap2048`` (there also float64 to 1e-9 and float32
   within ``float32_bound`` of the plain version); their launch counts
   show the body ran (no profiler window here: more windows in one
   process lose phase 11's kernel records);
   then the experiment path,
   ``tools_torch/bench_interval_experiments.py``'s five harnesses on the
   cap-512 state in float32 (B1-B3 with their ``3pass`` columns, B2's
   and B3's, B4 and B5 also at ``cap1024`` and ``cap2048``), with every
   count zeroed before it and read after it, and B1-3p's time at its
   automatic layout beside K1-3p's, B2-3p's and B3-3p's beside B1-3p's,
   B4's beside K1's, B2's gram sums and B5's modes at the three states
   beside their bounds (the largest of the FP32 pipe's, the MUFU's and
   the bytes' time) and B5's product and gram shares;
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
    wgmma kernels of ``csrc/fused_intervals3.cu``: the resident body up
    to capacity 576, the tiled body past it) against their
    plain versions: K1-3p at capacity 64 (the flagship's GPs), 512 (400
    observations), 512 with counts 20 and 300 in one launch, 1024 (600
    observations), the exact GP at 2048 (phase 16's, 2000 observations)
    and 2048 with counts 50 and 1500 in one launch; K2-3p on the
    contextual kernel at capacity 256, on the Sum with Bias and Cosine
    leaves, on the nine-leaf kernel (the wide instance) at 256 and 1024
    and at phase 5's ``context1024`` and ``context2048``: float64 to
    1e-9, float32 within ``float32_bound(..., "split", "bf16")``
    (``float32_bound_plan`` for K2-3p) of the plain version on the same
    operands, and that bound below a planted fault (the plain rows with
    each GP's first, then last, 32 active rows dropped, ``drop_band``,
    must land past it); beside each the max scaled |dQ| against the
    float64 plain rows of K1/K2 (which must stay below ``refine_band -
    boundary_band`` at the defaults wherever the plain three-pass rows
    themselves do; past it they are printed, ROADMAP Queue 3) and the
    decisions outside the 1e-3 band; the body each float32 launch ran
    (torch.profiler) at capacities 256-2048 against the launchers' rule
    (``fused_posterior.three_pass_body``), and in the same profiler
    window the body each K1 launch ran on the flagship, cap 512, cap
    1024 and cap 2048 and each K2 launch on phase 5's states (capacities
    256, 512, 1024, 2048 and the nine-leaf plan at 256 and 1024), both
    dtypes, against their launchers' rule (the tiled body past the
    resident rows); each tiled state's time against its bound and the
    factor's bytes from L2 a launch;
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
    Then three steps each, float32 ``'high'`` with the device oracle
    alone, of the exact GP at capacity 2048 (phase 16's, 2000
    observations) and of ``context2048`` (phase 5's two GPs, 2000
    observations over contexts in [-1, 1], at context 0, with a triage
    budget of 8,192 rows that covers its band): the tiled K1-3p / K2-3p
    body on a certified path, the same lockstep checks, the refined and
    full-pass steps printed. Launch counts are zeroed
    just before each
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
    observations, capacity 2048, past the resident gram: the tiled
    body), held first as phase 3 holds K1 (float64 within 1e-9, float32
    within ``float32_bound`` with the dropped band past it, decisions
    equal outside the band), then timed after the others; K2 at phase
    5's ``context1024`` and ``context2048`` states against its plain
    version and its bound; three steps of the
    contextual path at ``context2048`` (two GPs, 2000 observations over
    contexts in [-1, 1], capacity 2048, the 1e6-point parameter grid at
    context 0), ``optimize()`` and ``add_new_data_point()`` timed, K2
    twice a step and K4 twice a walk chunk (counted from zero around the
    run);
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
    ``optimize()``: the trace names K1's and K3's CUDA kernels (in a
    child process, ``chip_smoke.py --profile-to DIR``, whose profiler
    windows are the only ones it opens: in a process that has opened
    the earlier phases' windows the profiler lost K1's record in every
    trace of the step);
22. sharding, in a child process with an NCCL group of world size 1
    (``chip_smoke.py --shard-to FILE 1 0 PORT``; its failure fails the
    run): on a ``make_mesh(device_type='cuda')`` of (1, 1), the flagship
    step (two RBF GPs, the 1000 x 1000 grid, 50 observations, capacity
    64, chunk 32) on ``shard_grid``'s ``DTensor`` in float64 and float32,
    Q, S, M, G, next_idx and the walk bit for bit the unsharded step's,
    K1 once and K3 once a walk chunk on the sharded path (counted from
    zero around it), ms of a sharded and an unsharded step in turns (CUDA
    events, medians); ``num_valid`` on the card: the flagship grid with 3
    copies of its last row appended gives the unpadded step's S, M, G and
    next_idx; phase 20 (a)'s fleet with ``mesh=`` bit for bit the fleet
    without one; the certified path on the same mesh at phase 12's
    widths (``shard_certified``): the cap-512 state in float32 at
    ``interval_precision='high'`` with ``SafeOpt``'s own refinement
    budget, in float64 on the plain certified path, and the contextual
    state (cap 256) in float32 at ``'high'``, each through the
    host-oracle pair (``certified_scan`` -> ``safeopt_step_from_Q``) and
    the device-oracle triple (``interval_scan`` -> ``device_oracle`` on
    the float64 grid sharded alike -> ``certified_finish``; the
    contextual state the host pair only), with one verdict planted
    inverted so that the last pass writes a bit and walks: Q, S, M, G,
    next_idx, ``packed``/``packed_t``/``diag9`` and the oracle's tensors
    bit for bit the unsharded calls', K1-3p, K1, K3, K2-3p, K2 and K4
    each launched on the sharded certified calls (counted from zero
    around them), ms of the float32 device-oracle step sharded and
    unsharded in turns (CUDA events, medians of SHARD_REPS) and each
    protocol's host syncs, the sharded no more than the unsharded.
    With two cards or more a world of 2 (a data axis of 2, one process a
    card) runs the same, with four a world of 4 too; with one card it
    prints that they did not run;
23. the native host engine (``safeopt_torch.native``): built on the
    card's host; the cap-512 state's two GPs (phase 3's, 400
    observations) factored natively and by SciPy give posterior means and
    variances on the grid within 1e-9; ms to append one observation to
    both GPs with each engine (host clock, median of 20);
24. the ten scripts of ``examples_torch/`` in this process on the card at
    ``tests/test_examples.py``'s iteration counts, each script's own
    asserts the checks; each one's wall seconds and last line.

After each phase a line ``phase N: <s> s (host clock)`` gives its
seconds, so that a later slice sees where its 1200 s go. Any failed
check exits non-zero. The last lines are one JSON object of the kernels,
the nvidia-smi line, and the result line.
"""

import functools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from tools_torch.states import (BETA, LAYOUTS, LAYOUTS3, b1_3p_groups,
                                 build_gps, cap512_operands, cuda_ms,
                                 first_gp, fit_data, fit_kernel,
                                 long_operands, one_gp, sparse_data,
                                 sparse_exact_gp,
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
# The MUFU (the special-function unit: ex2, rsq, ...) gives 16 results a
# clock on each SM against 128 FP32 lanes (the CUDA C++ Programming
# Guide's arithmetic-throughput table, compute capability 9.0), at the
# 1.98 GHz that PEAK_FLOPS[float32] implies (132 x 128 x 2 x 1.98e9).
PEAK_MUFU = 132 * 16 * 1.98e9
# MUFU operations of one gram entry by kind (csrc/common.cuh Kind: RBF,
# Matern32, Matern52, Exponential, Cosine, Bias), from the SASS of one
# entry of each kind (tools_torch/tune_gram_rows.py --mufu, on the H100):
# float32's expf is one MUFU.EX2 and its sqrtf one MUFU.RSQ (a second
# MUFU.RSQ sits in the square root's slow path for special inputs, not
# counted), the accurate cosf a polynomial on the FP32 pipe; float64's
# exp is a polynomial on the FP64 pipe and its sqrt one MUFU.RSQ64H
GRAM_MUFU = {torch.float32: {0: 1, 1: 2, 2: 2, 3: 2, 4: 1, 5: 0},
             torch.float64: {0: 0, 1: 1, 2: 1, 3: 1, 4: 1, 5: 0}}
# the epilogue's square root a point and GP (a predicate's a candidate)
EPILOGUE_MUFU = 1
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
                spread=3.0, spread_contexts=False):
    """``n_gps`` contextual GPs (``context_kernel(variant)``) with
    ``n_obs`` shared observations in [-spread, spread] at context 0
    (``bench.py`` ``_context_config``; for ``"extra"``, or with
    ``spread_contexts``, contexts uniform in [-1, 1]: a long campaign
    that has visited several contexts)."""
    from safeopt_torch import GPRegression

    rng = np.random.default_rng(3)
    ctx = (rng.uniform(-1.0, 1.0, size=(n_obs, 1))
           if variant == "extra" or spread_contexts
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


def phase_clock():
    """``clock(name)`` prints the host seconds of the phase begun at the
    call before (``phase <its name>: <s> s``) and begins the phase
    ``name``; ``clock(None)`` ends the last."""
    state = {"name": None, "start": time.perf_counter()}

    def clock(name):
        now = time.perf_counter()
        if state["name"] is not None:
            print(f"phase {state['name']}: {now - state['start']:.1f} s "
                  "(host clock)", flush=True)
        state.update(name=name, start=now)
    return clock


def bound(dtype, flops, nbytes, mufu=0):
    """(least ms, what bounds it): the largest of ``flops`` over the
    card's peak rate for ``dtype`` on its FP32/FP64 pipe ("operations"),
    ``mufu`` operations over the MUFU's rate ("mufu") and ``nbytes`` over
    its memory rate ("bytes")."""
    t, by = max((flops / PEAK_FLOPS[dtype], "operations"),
                (mufu / PEAK_MUFU, "mufu"), (nbytes / PEAK_BYTES, "bytes"))
    return t * 1e3, by


def json_bound_by(by):
    """The kernels line's ``bound_by`` of a bound's term: the MUFU's
    operations are operations."""
    return "operations" if by == "mufu" else by


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


def gram_mufu(dtype, leaves=None):
    """MUFU operations of one gram entry in ``dtype``: the sum of
    ``GRAM_MUFU`` over a plan's ``leaves``, or for ``leaves`` None that of
    RBF, the stationary family of every state these bounds are taken on
    (as ``gram_flops`` counts its operations)."""
    if leaves is None:
        return GRAM_MUFU[dtype][0]
    return sum(GRAM_MUFU[dtype][k] for k, _ in leaves)


def interval_bound(dtype, G, N, d, cap, n, leaves=None):
    """Least time of K1/K2 on these inputs: per point and GP the gram of
    the n active rows (its transcendentals on the MUFU), the n(n+1)/2
    FMAs of the triangular product, mu and the sum of squares, and the
    epilogue's square root; inputs read once, the (G, 2, N) rows written
    once."""
    flops = G * N * (n * gram_flops(d, leaves) + n * (n + 1) + 4 * n + 8)
    mufu = G * N * (n * gram_mufu(dtype, leaves) + EPILOGUE_MUFU)
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (d * N + G * (cap * d + cap * cap + cap + 4 + 2 * N))
    return bound(dtype, flops, nbytes, mufu)


def ablation_bound(mode, dtype, G, N, d, cap, n, prescribed=False):
    """Least time of B2/B5's ``mode`` on these inputs: the least work its
    output needs, the inputs it depends on read once, the (G, 2, N) rows
    written once. ``gram_sums``: per point and GP the gram of the n
    active rows, an add and an FMA an entry; ``no_product``: the gram,
    two FMAs an entry (mu and the sum of squares) and the epilogue. The
    gram's transcendentals and the epilogue's square root count on the
    MUFU. Under ``solve_rank1`` and ``epilogue`` V is one column v times
    z[0] (v = Lm xs[:, 0], or 0.01 in every row), so mu = z[0] (w . v)
    and sum V^2 = z[0]^2 (v . v): one pass over Lm a GP (over w for
    ``epilogue``), then per point three operations and the epilogue on
    grid column 0 alone. ``prescribed`` counts for these two the work the
    kernel is told to do instead: every row of V, the rank-1 gram and the
    triangular product."""
    size = torch.finfo(dtype).bits // 8
    gram_ops = G * N * n * gram_mufu(dtype)
    if mode == "gram_sums":
        return bound(dtype, G * N * n * (gram_flops(d) + 3),
                     size * (d * N + G * (cap * d + d + 4 + 2 * N)), gram_ops)
    if mode == "no_product":
        return bound(dtype, G * N * (n * (gram_flops(d) + 4) + 8),
                     size * (d * N + G * (cap * d + d + cap + 4 + 2 * N)),
                     gram_ops + G * N * EPILOGUE_MUFU)
    solve = mode == "solve_rank1"
    nbytes = size * (N + G * (2 * N + cap + 4
                              + (cap * cap + cap if solve else 0)))
    mufu = G * N * EPILOGUE_MUFU
    if prescribed:
        return bound(dtype, G * N * (n * (5 if solve else 4)
                                     + (n * (n + 1) if solve else 0) + 8),
                     nbytes, mufu)
    return bound(dtype, G * ((n * (n + 1) + 4 * n if solve else 2 * n)
                             + 11 * N), nbytes, mufu)


def split_bound(limb, N, d, cap, n, G=1, leaves=None, gram=True):
    """Least time of B4, K1-3p, K2-3p, B1-3p and B3-3p on these inputs (G
    GPs; a plan's ``leaves`` for K2-3p): the three limb products' 3
    n(n+1) flops a point on the tensor cores at the limb format's peak;
    on the FP32 pipe the gram, its split (two roundings and a difference
    an entry) and the epilogue; on the MUFU the gram's transcendentals
    and the epilogue's square root; inputs read once, the (G, 2, N) rows
    written once. The largest of the four. ``gram`` False (B2-3p): no
    gram term, and grid and inputs read in column 0 only (the rank-1
    gram; its limbs are no rank-1 product, so the product stays)."""
    f32 = torch.float32
    dg = d if gram else 1
    t_tc = 3 * G * N * n * (n + 1) / PEAK_TENSOR[limb]
    t_fp = (G * N * (n * ((gram_flops(d, leaves) if gram else 0) + 3)
                     + 4 * n + 8) / PEAK_FLOPS[f32])
    t_mufu = G * N * (n * (gram_mufu(f32, leaves) if gram else 0)
                      + EPILOGUE_MUFU) / PEAK_MUFU
    t_mem = 4 * (dg * N + G * (cap * dg + cap * cap + cap + 4 + 2 * N)
                 ) / PEAK_BYTES
    t, by = max((t_tc, "operations"), (t_fp, "operations"),
                (t_mufu, "mufu"), (t_mem, "bytes"))
    return t * 1e3, by


def three_pass_l2_bytes(N, n, body, G=1):
    """Bytes of the factor's limb chunks that one launch of the float32
    K1-3p/K2-3p streams from L2 at count n over N points (G GPs): each
    work item (64 points in the resident body, 128 in the tiled one,
    ``fused_posterior.three_pass_body``) reads the executed triangle
    once, ceil(min(64 (m + 1), n) / 32) chunks of 8 KB for row tile m."""
    points = 128 if body == "tiled" else 64
    chunks = sum(-(-min(64 * (m + 1), n) // 32) for m in range(-(-n // 64)))
    return G * -(-N // points) * chunks * 8192


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
    and of the C candidates (their transcendentals on the MUFU), the C n
    FMAs of the cross term and the epilogue, a square root a candidate;
    inputs read once, the (G, C) predicate written once."""
    g = gram_flops(d, leaves)
    flops = G * U * (n * g + C * g + 2 * C * n + 12 * C)
    mufu = G * U * ((n + C) * gram_mufu(dtype, leaves)
                    + C * EPILOGUE_MUFU)
    size = torch.finfo(dtype).bits // 8
    nbytes = (size * (d * N + G * (2 * N + cap * d + C * d + C * cap
                                   + 3 * C + 4)) + masks * N + 4 * G * C)
    return bound(dtype, flops, nbytes, mufu)


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


# the float32 K1-3p and K2-3p kernels (csrc/fused_intervals3.cu): the
# resident body's and the tiled body's, by three_pass_body's name
THREE_PASS_KERNELS = ("intervals3_wg_kernel", "intervals_plan3_wg_kernel",
                      "intervals3_tiled_kernel",
                      "intervals_plan3_tiled_kernel")
THREE_PASS_BODY = {
    "K1-3p": {"resident": "intervals3_wg_kernel",
              "tiled": "intervals3_tiled_kernel"},
    "K2-3p": {"resident": "intervals_plan3_wg_kernel",
              "tiled": "intervals_plan3_tiled_kernel"}}


# the float32 B2-3p and B3-3p kernels (csrc/interval_experiments3.cu), by
# the body K1-3p's rule gives the capacity (three_pass_body)
EXPERIMENT3_BODY = {
    "solve_rank1": {"resident": "rank1_wg3_kernel<",
                    "tiled": "rank1_tiled3_kernel"},
    "mu_from_gram": {"resident": "mu_wg3_kernel<",
                     "tiled": "mu_tiled3_kernel"}}


# rows K1's and K2's resident body keeps in shared memory at most (the
# launchers take the tiled body past them: csrc/fused_intervals.cu,
# csrc/fused_intervals_plan.cu)
K1_RESIDENT_ROWS = {torch.float32: 512, torch.float64: 256}
K2_RESIDENT_ROWS = {torch.float32: 512, torch.float64: 256}


def kernel_names(calls, attempts=8):
    """The names of the CUDA kernels of ``safeopt::`` that one call of
    each ``(launch, ops)`` of ``calls`` (the wrapper of a kernel,
    launching one kernel a call; a module function or a
    ``functools.partial`` of one) ran, from torch.profiler: one list a
    call.

    The calls run in one profiler window, each drained before the next,
    so the i-th kernel in start order is the i-th call's. The profiler
    now and then records no kernel for a launch (CUPTI drops the record,
    the more often the longer the process and the more windows it has
    opened; a fresh process keeps them): a window that recorded other
    than one kernel a call says nothing of the bodies, so then the calls
    are profiled again in a fresh child process (``kernel_names_main``),
    up to ``attempts`` windows there, and past them each call's list is
    empty (the caller holds each list to exactly one kernel of the
    rule's body)."""
    for launch, ops in calls:
        launch(*ops)            # loaded before the profiler starts
    torch.cuda.synchronize()
    names, recorded = profile_calls(calls)
    if names is not None:
        return names
    print(f"kernel_names: this process's window recorded {recorded} "
          f"kernels for {len(calls)} calls; profiling them in a fresh "
          "process", flush=True)
    return kernel_names_in_child(calls, attempts)


def profile_calls(calls):
    """(one list of a kernel name a call, or None, and the count of
    ``safeopt::`` kernels recorded) of one profiler window around
    ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)        # the window opens well before the launches
        for launch, ops in calls:
            launch(*ops)
            torch.cuda.synchronize()
        time.sleep(0.05)        # and closes well after their end
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "safeopt::" in e.name),
                    key=lambda e: e.time_range.start)
    if len(events) == len(calls):
        return [[e.name] for e in events], len(events)
    return None, len(events)


def kernel_names_in_child(calls, attempts):
    """``kernel_names`` of ``calls`` in a child process
    (``chip_smoke.py --kernel-names IN OUT ATTEMPTS``): the calls saved
    with ``torch.save`` under ``build/``, their tensors on the card; the
    child's output is printed and its failure fails the run."""
    import os
    import shutil
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kernel_names_", dir=root)
    try:
        path_in = os.path.join(tmp, "calls.pt")
        path_out = os.path.join(tmp, "names.json")
        torch.save(list(calls), path_in)
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--kernel-names",
             path_in, path_out, str(attempts)],
            capture_output=True, text=True, timeout=600)
        print(child.stdout, end="", flush=True)
        check(child.returncode == 0,
              f"the kernel_names process failed ({child.returncode}):\n"
              f"{child.stderr[-4000:]}")
        with open(path_out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernel_names_main(path_in, path_out, attempts):
    """``chip_smoke.py --kernel-names IN OUT ATTEMPTS``: the calls saved
    at ``path_in`` profiled in this fresh process, up to ``attempts``
    windows, their names (or an empty list a call) written to
    ``path_out`` as JSON; returns the exit code."""
    calls = torch.load(path_in, weights_only=False)
    for launch, ops in calls:
        launch(*ops)
    torch.cuda.synchronize()
    names = [[] for _ in calls]
    for attempt in range(1, attempts + 1):
        got, recorded = profile_calls(calls)
        print(f"kernel_names (fresh process): window {attempt} of "
              f"{attempts} recorded {recorded} kernels for {len(calls)} "
              "calls", flush=True)
        if got is not None:
            names = got
            break
    with open(path_out, "w") as f:
        json.dump(names, f)
    return 0


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


def check_three_pass(label, ops, fmin, scale, what="split", hold_last=True):
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
    The |dQ| check holds where the plain version's own float32 rows stay
    under the slack; a state whose three-pass product is past it by
    itself (a long campaign's factor, ROADMAP Queue 3) is printed, and
    the kernel there is held by its float32 bound alone. The float32
    decisions that differ from float64's outside the band are printed:
    the three-pass product itself moves rows by several times the band
    (its plain version's float32 rows flip some too). Where the plain
    rows are under the slack, B3-3p's decisions must equal its plain
    version's on the same float32 operands outside the band (past it,
    the float32 sums of a long campaign's factor move the rows by more
    than the band). The float32 B2-3p and B3-3p must give the same bits
    on a second launch and run K1-3p's body for the capacity
    (``EXPERIMENT3_BODY``, by the profiler's kernel name); B3-3p also
    with resident gram rows short of the capacity (``res``, the resident
    body), within the same bound. ``hold_last`` False prints the last
    band's fault without holding it (see the caller).
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
    held = what != "solve_rank1" and dq_plain < slack
    # against the plain version's float32 rows: the same function
    wrong_plain, _ = decisions_agree(
        k32[:, 0], p32.view(-1, 2, N)[:, 0].double(),
        torch.tensor(fmin, dtype=torch.float64, device="cuda")[:, None], sc)
    body = None
    if what in EXPERIMENT3_BODY:
        check(torch.equal(kernel(*o32).view(-1, 2, N).double(), k32),
              f"{name} {label}: a second launch gave other bits")
        cap = o32[2].shape[1]
        body = EXPERIMENT3_BODY[what][fp.three_pass_body(cap)]
        ran = kernel_names([(kernel, o32)])[0]
        check(len(ran) == 1 and f"safeopt::{body}" in ran[0],
              f"{name} {label} ran {ran}, not {body}")
        if what == "mu_from_gram" and fp.three_pass_body(cap) == "resident":
            res = min(256, -(-cap // 64) * 32)
            part = kernel(*o32, res=res)
            share = ((part.double() - p32.double()).abs()
                     / bound_).max().item()
            print(f"{name} {label}: with {res} resident gram rows at most "
                  f"{share:.3f} of its float32 bound (limit 1)", flush=True)
            check(share <= 1.0, f"{name} {label} res={res} past its bound")
            check(torch.equal(part, kernel(*o32, res=res)),
                  f"{name} {label} res={res}: a second launch gave other "
                  f"bits")
    torch.cuda.synchronize()
    print(f"{name} {label}: f64 max|kernel-plain|={err64:.3e} (limit 1e-9); "
          f"f32 at most {ratio:.3f} of its float32 bound (limit 1), a "
          f"kernel dropping the first / last 32 active rows "
          f"{faults[0]:.4g} / {faults[1]:.4g} of it (limit: "
          + ("past 1" if hold_last else "the first past 1, the last "
             "printed") + "); f32 "
          f"max scaled |dQ| against the float64 rows {dq:.3e} (the plain "
          f"version's own {dq_plain:.3e}; "
          + (f"limit {slack:g}" if held else
             "not held" if what == "solve_rank1" else
             f"not held: the plain three-pass rows are past the slack "
             f"{slack:g} themselves") +
          f"); f32 decisions differing outside the {BAND:g} band={wrong} "
          f"(rows inside the band: {in_band}), from its plain version's "
          f"float32 decisions {wrong_plain}"
          + (" (limit 0)" if what == "mu_from_gram" and held else "")
          + (f"; ran {body}, the same bits twice" if body else ""),
          flush=True)
    check(err64 <= 1e-9, f"{name} {label} f64 error {err64}")
    check(ratio <= 1.0, f"{name} {label} f32 error past its bound")
    check(faults[0] > 1.0 and (faults[1] > 1.0 or not hold_last),
          f"{name} {label}: a kernel dropping a band of rows stays within "
          f"the float32 bound {faults}")
    check(not held or dq < slack, f"{name} {label}: the three-pass error "
                                  f"{dq} is past refine_band - boundary_band")
    check(what != "mu_from_gram" or not held or wrong_plain == 0,
          f"{name} {label}: {wrong_plain} float32 decisions differ from its "
          f"plain version's outside the band")
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


def check_k2(label, n_obs, cap, grid64, variant=None, spread_contexts=False,
             bounded=False):
    """K2 vs its plain version in f64 and f32 on one contextual GP
    (``context_kernel(variant)``, ``context_gps``' GP 0): float64 to
    1e-9, float32 decisions equal outside the band. ``bounded``: the
    float32 kernel also within ``float32_bound_plan(..., limb=None)`` of
    ``plan_rows_on_kernel_gram`` on its own operands, and a planted fault
    (the GP's first, then last, 32 active rows of Lm dropped) past that
    bound. Returns the f64 error and the operands by dtype."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    out = {}
    for dtype in (torch.float64, torch.float32):
        gp = context_gps(1, n_obs, cap, "cuda", dtype, variant=variant,
                         spread_contexts=spread_contexts)[0]
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
    if bounded:
        want = ie.plan_rows_on_kernel_gram(*ops32)
        bound_ = ie.float32_bound_plan(*ops32, limb=None)
        share = ((k32.double() - want).abs() / bound_).max().item()
        faults = fault_readings(ie.plan_rows_on_kernel_gram, ops32, "split",
                                bound_)
        print(f"K2 {label} float32 against its function in float64 on the "
              f"kernel's gram: at most {share:.3g} of float32_bound_plan "
              f"(limb=None; limit 1); the bound's median "
              f"{bound_.median().item():.3e}; the first 32-row band dropped "
              f"reads {faults[0]:.3g} x the bound (must be past 1), the "
              f"last {faults[1]:.3g} x", flush=True)
        check(share <= 1.0, f"K2 {label} f32 past its float32 bound")
        check(faults[0] > 1.0, f"K2 {label}: the float32 bound cannot see "
                               "a dropped band")
    return err64, {torch.float64: ops64, torch.float32: ops32}


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


def check_gram_rows(label, ops64, ops32, plain_too=False):
    """B2's gram sums (every GP) and B5's two modes (GP 0, as their
    harnesses take them) on the gram-only body (``csrc/gram_rows.cuh``,
    the only body of these modes: their launch counts show it ran): in
    float32 bit for bit the in-order sums of ``ablation_in_order`` on the
    same operands. ``plain_too``: also float64
    within 1e-9 of the plain version and float32 within ``float32_bound``
    of it in float64 (``check_experiments`` holds those at cap 512 and
    64). Returns {kernels-line name: max float64 error}."""
    from safeopt_torch.ops import interval_experiments as ie

    start = time.perf_counter()
    errs, runs = {}, (("B2 gram_sums", "gram_sums", ops64, ops32),
                      ("B5 no_product", "no_product", first_gp(ops64),
                       first_gp(ops32)),
                      ("B5 epilogue", "epilogue", first_gp(ops64),
                       first_gp(ops32)))
    for name, mode, o64, o32 in runs:
        got = ie.interval_ablation(*o32, mode)
        same = bool(torch.equal(got, ie.ablation_in_order(*o32, mode)))
        print(f"{name} {label}: float32 {'==' if same else '!='} the "
              f"in-order sums of kernel_gram's entries, bit for bit",
              flush=True)
        check(same, f"{name} {label}: float32 rows differ from the "
                    "in-order sums")
        if not plain_too:
            continue
        up = tuple(o.double() if torch.is_tensor(o) else o for o in o32)
        err64 = (ie.interval_ablation(*o64, mode)
                 - ie.interval_ablation_plain(*o64, mode)).abs().max().item()
        ratio = ((got.double() - ie.interval_ablation_plain(*up, mode)).abs()
                 / ie.float32_bound(*o32, mode)).max().item()
        print(f"{name} {label}: f64 max|kernel-plain|={err64:.3e} (limit "
              f"1e-9); f32 at most {ratio:.3f} of float32_bound (limit 1)",
              flush=True)
        check(err64 <= 1e-9, f"{name} {label} f64 error {err64}")
        check(ratio <= 1.0, f"{name} {label} f32 error past its bound")
        errs[name] = err64
    print(f"B2/B5 gram-only body {label}: checked in "
          f"{time.perf_counter() - start:.1f} s (host clock)", flush=True)
    return errs


def check_launch3(label, ops64, ops32):
    """B1-3p at every launch layout of ``LAYOUTS`` (float64: the float64
    K1-3p's ThreePassProduct body) and ``LAYOUTS3`` (float32: K1-3p's
    wgmma bodies): K1-3p's bits (``fused_intervals3``) at every layout
    that keeps its order, and at the layouts with another count of
    consumer warpgroups within ``float32_bound(..., "split", "bf16")`` of
    K1-3p's plain version, both planted faults past that bound; the body
    each float32 layout ran, by kernel name. A layout of these lists that
    raises fails."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    f32, f64 = torch.float32, torch.float64
    cap = ops64[2].shape[1]
    layouts = {f64: [dict(slices=s, res=r, carveout=c)
                     for s, r, c in LAYOUTS[cap][f64]],
               f32: [dict(groups=g, stages=st, res=r, carveout=c)
                     for g, st, r, c in LAYOUTS3[cap]]}
    bound_ = ie.float32_bound(*ops32, "split", limb="bf16")
    faults = fault_readings(fp.fused_intervals3_plain, ops32, "split",
                            bound_)
    plain32 = fp.fused_intervals3_plain(*ops32).double()
    kept, other = 0, []
    for ops in (ops64, ops32):
        dt = ops[0].dtype
        k13 = fp.fused_intervals3(*ops)
        for kw in layouts[dt]:
            where = f"B1-3p {label} {dt} {kw}"
            try:
                got = ie.intervals_launch(*ops, three_pass=True, **kw)
            except RuntimeError as err:
                fail(f"{where} raised: {err}")
            if kw.get("groups", 0) in (0, b1_3p_groups(cap)):
                check(torch.equal(got, k13), f"{where} differs from K1-3p")
                kept += 1
            else:
                share = ((got.double() - plain32).abs() / bound_).max().item()
                other.append(share)
                check(share <= 1.0, f"{where}: past the float32 bound")
    torch.cuda.synchronize()
    check(min(faults) > 1.0, f"B1-3p {label}: a dropped band stays within "
                             f"the float32 bound {faults}")
    print(f"B1-3p {label}: K1-3p's bits at {kept} layouts that keep its "
          f"order ({len(layouts[f64])} float64, "
          f"{len(layouts[f32]) - len(other)} float32); {len(other)} float32 "
          f"layouts with another count of consumer warpgroups at most "
          f"{max(other, default=0.0):.3f} of the float32 bound (limit 1), "
          f"the first / last 32 active rows dropped {faults[0]:.4g} / "
          f"{faults[1]:.4g} of it (limit: past 1)", flush=True)
    # the body each float32 layout ran
    ran = kernel_names([(functools.partial(ie.intervals_launch,
                                           three_pass=True, **kw), ops32)
                        for kw in layouts[f32]])
    want = ("safeopt::tiled3_kernel<" if fp.three_pass_body(cap) == "tiled"
            else "safeopt::wg3_kernel<")
    for kw, names in zip(layouts[f32], ran):
        check(len(names) == 1 and want in names[0]
              and "Limbs3<false, false>" in names[0],
              f"B1-3p {label} {kw} ran {names}, not {want}bf16 limbs")
    print(f"B1-3p {label}: every float32 layout ran {want}Limbs3<false, "
          f"false>, ...>", flush=True)


def check_split(label, ops64, ops32, scaling):
    """B4 in both limb formats on each GP of K1's operands ``ops32``
    (float32; ``ops64`` the same state in float64): the limbs cut in the
    kernel and hoisted give the same bits, in bf16 hoisted K1-3p's for the
    GP alone; the rows within ``float32_bound(..., "split", limb)`` of
    ``intervals_split_plain``, both planted faults past it; the scaled
    error against the float64 rows beside K1's float32 one; the body
    each variant ran, by kernel name. Returns {kernels-line name: max abs
    error against the plain version}, and {"B4 bf16", "B4 tf32", "K1":
    max scaled |dQ| against the float64 rows}."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    errs, dqs = {}, {}
    ref = fp.fused_intervals_plain(*ops64)
    scale = torch.tensor(scaling, dtype=torch.float64, device="cuda")
    k1_dq = ((fp.fused_intervals(*ops32).double() - ref).abs()
             / scale[:, None, None]).max().item()
    cap = ops32[2].shape[1]
    body = fp.three_pass_body(cap)
    for limb in ie.LIMBS:
        err, ratio, dq, lo_fault = 0.0, 0.0, 0.0, 0.0
        first, last, lims, rows = math.inf, math.inf, [], []
        for g in range(ops32[2].shape[0]):
            one = one_gp(ops32, g)
            limbs = ie.split_factor(one[3], limb)
            got = ie.intervals_split(*one, limb=limb)
            hoisted = ie.intervals_split(*one, limb=limb, limbs=limbs)
            check(torch.equal(got, hoisted),
                  f"B4 {limb} {label}: in-kernel and hoisted limbs differ")
            if limb == "bf16":
                alone = tuple(t[g:g + 1] if i in (1, 2, 3, 4, 5) else t
                              for i, t in enumerate(ops32))
                check(torch.equal(hoisted, fp.fused_intervals3(*alone)[0]),
                      f"B4 bf16 {label} GP {g}: hoisted, not K1-3p's bits")
            plain = functools.partial(ie.intervals_split_plain, limb=limb)
            want = plain(*one)
            lim = ie.float32_bound(*one, "split", limb=limb)
            lims.append(lim)
            rows.append(want.double().abs())
            diff = (got.double() - want.double()).abs()
            err = max(err, diff.max().item())
            ratio = max(ratio, (diff / lim).max().item())
            dq = max(dq, (got.double() - ref[g]).abs().max().item()
                     / scaling[g])
            readings = fault_readings(plain, one, "split", lim)
            first, last = min(first, readings[0]), min(last, readings[1])
            unrounded = plain(*one, round_lo=False)
            lo_fault = max(lo_fault, ((unrounded.double() - want.double())
                                      .abs() / lim).max().item())
        torch.cuda.synchronize()
        print(f"B4 {limb} {label} ({body} body): in-kernel == hoisted "
              f"bitwise{' == K1-3p' if limb == 'bf16' else ''}; max abs "
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
        check(min(first, last) > 1.0, f"B4 {limb} {label}: float32_bound "
                                      "hides a dropped band")
        errs[f"B4 {limb}"] = err
        dqs[f"B4 {limb}"] = dq
    dqs["K1"] = k1_dq
    # the body each variant ran
    one = one_gp(ops32)
    calls = [(functools.partial(ie.intervals_split, limb=limb, limbs=h), one)
             for limb in ie.LIMBS
             for h in (None, ie.split_factor(one[3], limb))]
    ran = kernel_names(calls)
    name = "tiled3_kernel" if body == "tiled" else "wg3_kernel"
    for (call, _), names in zip(calls, ran):
        tf32 = str(call.keywords["limb"] == "tf32").lower()
        cut = str(call.keywords["limbs"] is None).lower()
        want = f"Limbs3<{tf32}, {cut}>"
        check(len(names) == 1 and f"safeopt::{name}<" in names[0]
              and want in names[0],
              f"B4 {label} {call.keywords['limb']} ran {names}, not "
              f"{name}<{want}>")
    print(f"B4 {label}: the four variants ran {name}<Limbs3<tf32, cut>> "
          f"by their limbs", flush=True)
    return errs, dqs


def check_experiments(label, ops64, ops32):
    """B1-B5 and B1-3p-B3-3p against their plain versions on K1's
    operands of one state in float64 and float32, and how each float32
    bound compares with the rows and with a planted fault. Returns
    {kernels-line name: max abs error} (float64; B4's float32 against its
    plain version) and B4's and K1's max scaled |dQ| (``check_split``)."""
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops import interval_experiments as ie

    f32, f64 = torch.float32, torch.float64
    cap = ops64[2].shape[1]
    for ops in (ops64, ops32):
        k1, ref = fp.fused_intervals(*ops), "K1"
        if cap > K1_RESIDENT_ROWS[ops[0].dtype]:
            # K1 runs its tiled body: B1 (the resident body at other
            # layouts) gives its automatic layout's bits, near K1's
            auto, ref = ie.intervals_launch(*ops), "its automatic layout"
            err = (auto - k1).abs().max().item()
            print(f"B1 {label} {ops[0].dtype}: K1 runs its tiled body; "
                  f"B1's automatic layout within {err:.3e} of it",
                  flush=True)
            check(ops[0].dtype != f64 or err <= 1e-9,
                  f"B1 {label} float64 automatic layout {err} from K1")
            k1 = auto
        for slices, res, carveout in LAYOUTS[cap][ops[0].dtype]:
            got = ie.intervals_launch(*ops, slices=slices, res=res,
                                      carveout=carveout)
            check(torch.equal(got, k1),
                  f"B1 {label} {ops[0].dtype} slices={slices} res={res} "
                  f"carveout={carveout} differs from {ref}")
    print(f"B1 {label}: K1's bits at every launch layout, float64 and "
          f"float32", flush=True)
    check_launch3(label, ops64, ops32)
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
    check_gram_rows(label, ops64, ops32)
    split_errs, dqs = check_split(label, ops64, ops32, SCALING)
    errs.update(split_errs)
    for name, what in (("B1-3p", "launch"),
                       ("B2-3p solve_rank1", "solve_rank1"),
                       ("B3-3p", "mu_from_gram")):
        errs[name] = check_three_pass(label, {f64: ops64, f32: ops32}, FMIN,
                                      SCALING, what=what)[0]
    return errs, dqs


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
                    min_refined=0, oracles=("host", "device")):
    """The certified path of ``make(device, dtype, **kw)`` in float32
    with each of ``oracles``, each for ``iters`` iterations in
    lockstep with float64 and float32 plain twins on the card (the
    certified query and measurement are added to all three); at least
    ``min_refined`` of the steps must refine their band within the
    budget (the others take the full float32 pass). Returns {oracle: (summed launches of the
    certified optimize() calls, its optimize() ms, the float32 plain
    twin's ms, rows below the 1e-9 margin, queries that differed)}."""
    out = {}
    for oracle in oracles:
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
# phase 18: the contextual path past K2's resident rows
LONG_CTX_STEPS = 3
# certified steps of phase 12's long campaigns (cap 2048, context2048),
# and context2048's triage budget (its band holds about 3,800 rows)
LONG_CERT_STEPS = 3
LONG_CERT_TRIAGE = 8192


def drive_long_context(params_np):
    """Three steps of the contextual path at ``tools_torch/measure.py``'s
    ``context2048`` state: two GPs of the contextual kernel, 2000
    observations over contexts in [-1, 1], capacity 2048 (K2 on its tiled
    body), the 1e6-point parameter grid at context 0, float32.
    ``optimize()`` and ``add_new_data_point()`` timed with CUDA events;
    K2 twice a step and K4 twice a walk chunk (the counts zeroed before
    the run and read after it), finite intervals and a safe set at every
    step. Returns (launches, optimize ms, add ms)."""
    from safeopt_torch import SafeOpt

    opt = SafeOpt(context_gps(2, 2000, 2048, "cuda", None,
                              spread_contexts=True), params_np,
                  fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                  expander_chunk=32)
    rng = np.random.default_rng(2)
    opt_ms, add_ms, chunks = [], [], 0
    zero_launches()
    for _ in range(LONG_CTX_STEPS):
        x, ms = timed_ms(lambda: opt.optimize(context=0.0))
        opt_ms.append(ms)
        chunks += opt.stats.last.walk_chunks
        y = (context_truth([[float(x[0]), 0.0]])
             + 0.05 * rng.normal(size=(1, 2)))
        add_ms.append(timed_ms(
            lambda: opt.add_new_data_point(x, y, context=0.0))[1])
        check(bool(np.isfinite(opt.Q).all())
              and opt.stats.last.safe_count > 0,
              "the contextual path at capacity 2048 gave a non-finite "
              "interval or no safe point")
    torch.cuda.synchronize()
    n = read_launches()
    print(f"contextual path at capacity 2048 (2000 obs, contexts in [-1, "
          f"1], {LONG_CTX_STEPS} steps at context 0): optimize() ms "
          f"{[round(t, 3) for t in opt_ms]}, add_new_data_point() ms "
          f"{[round(t, 3) for t in add_ms]}, walk chunks {chunks}, "
          f"launches {n}", flush=True)
    check(n["K2"] == 2 * LONG_CTX_STEPS and n["K4"] == 2 * chunks,
          f"the contextual path at capacity 2048 launched K2 {n['K2']} "
          f"times (not {2 * LONG_CTX_STEPS}) or K4 {n['K4']} (not "
          f"{2 * chunks})")
    check(n["K1"] == n["K3"] == n["K1-3p"] == n["K2-3p"] == 0
          and not any(experiment_launches().values()),
          "the contextual path at capacity 2048 launched another kernel")
    return n, opt_ms, add_ms


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


def profile_case(opt, tmp, smi, attempts=4):
    """Phase 21 (d): ``profile_trace`` around one flagship ``optimize()``:
    the trace file exists and names K1's CUDA kernel, and K3's when the
    step walked. The profiler now and then drops a kernel's record
    (``kernel_names``), so a trace that misses one is taken again, up to
    ``attempts`` traces of the same step."""
    import os

    from safeopt_torch.utils.observability import profile_trace

    for attempt in range(1, attempts + 1):
        log_dir = os.path.join(tmp, f"trace{attempt}")
        with profile_trace(log_dir):
            opt.optimize()
        path = os.path.join(log_dir, "trace.json")
        check(os.path.exists(path), "profile_trace wrote no trace")
        with open(path) as fh:
            kernels = sorted({e["name"]
                              for e in json.load(fh)["traceEvents"]
                              if e.get("cat") == "kernel"})
        walked = opt.stats.last.walk_chunks
        k1 = any("intervals_kernel" in k for k in kernels)
        k3 = any("expander_kernel" in k for k in kernels)
        if k1 and (k3 or walked == 0):
            break
        print(f"profile_trace: trace {attempt} of {attempts} names K1's "
              f"kernel: {k1}, K3's: {k3}", flush=True)
    check(k1 and (k3 or walked == 0),
          f"the trace names K1's kernel: {k1}, K3's: {k3} (walk chunks "
          f"{walked}); its {len(kernels)} kernels: {kernels}")
    print(f"profile_trace on {smi}: {os.path.getsize(path)} bytes, "
          f"{len(kernels)} kernel names, intervals_kernel (K1) and "
          f"expander_kernel (K3; {walked} walk chunks) among them",
          flush=True)


def profile_main(out_dir):
    """``chip_smoke.py --profile-to DIR``: phase 21 (d) in a process of its
    own, on a fresh flagship ``SafeOpt`` after one ``optimize()`` that
    loads its kernels; the traces go under ``out_dir``."""
    if not torch.cuda.is_available():
        print("chip_smoke profile: no CUDA device", file=sys.stderr)
        return 1
    from safeopt_torch import linearly_spaced_combinations

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    opt = flagship_opt(grid_np)
    opt.optimize()
    torch.cuda.synchronize()
    profile_case(opt, out_dir, smi)
    return 0


def profile_in_child(tmp):
    """Phase 21 (d): ``profile_main`` in a child process writing under
    ``tmp``; its output is printed and its failure fails the run."""
    import os

    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-to", tmp],
        capture_output=True, text=True, timeout=600)
    print(child.stdout, end="", flush=True)
    check(child.returncode == 0,
          f"the profile_trace process failed ({child.returncode}):\n"
          f"{child.stderr[-4000:]}")


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
        profile_in_child(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"utilities: launches through K1-K4's operators (loaded steps "
          f"and exported campaigns) {total}", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 22: sharding over torch.distributed
# ---------------------------------------------------------------------------

SHARD_REPS = 10


def shard_case(mesh, dtype, rank, smi):
    """Phase 22 on one mesh: the flagship step (two RBF GPs, the 1000 x
    1000 grid, 50 observations, capacity 64, chunk 32) on ``shard_grid``'s
    ``DTensor`` against the unsharded step, the K1 and K3 launches of the
    sharded step, its ms and the unsharded step's (CUDA events, median of
    SHARD_REPS), and ``num_valid`` on the padded grid."""
    from safeopt_torch import linearly_spaced_combinations
    from safeopt_torch.algorithms.safe_opt_core import safeopt_step
    from safeopt_torch.parallel import (replicate, shard_grid,
                                        shard_state)
    from safeopt_torch.parallel.sharded_step import _Shards

    dev = torch.device("cuda", torch.cuda.current_device())
    grid = torch.tensor(linearly_spaced_combinations(
        [(-5.0, 5.0), (-5.0, 5.0)], 1000), dtype=dtype, device=dev)
    N = grid.shape[0]
    gps = build_gps(np.random.default_rng(0), 50, 64, dev, dtype)
    kernels = tuple(g.kern for g in gps)
    states = tuple(g.state for g in gps)
    t = functools.partial(torch.tensor, dtype=dtype, device=dev)
    a = (t(FMIN), BETA, t(SCALING), t([0.0, 0.0]))
    what = f"sharded flagship step {str(dtype)[6:]} on mesh " \
        f"{tuple(mesh.mesh.shape)}"
    ref = safeopt_step(kernels, states, grid, *a, chunk=32)
    sgrid, pad = shard_grid(grid, mesh)
    sstates = tuple(shard_state(st, mesh) for st in states)
    sargs = replicate(a, mesh)

    def sharded():
        return safeopt_step(kernels, sstates, sgrid, *sargs, num_valid=N,
                            chunk=32)

    sharded()                                      # warm-up
    zero_launches()
    res = sharded()
    torch.cuda.synchronize()
    launches = read_launches()
    sh = _Shards(sgrid)
    lo, hi = sh.offset, min(sh.offset + sh.n, N)
    for name in ("Q", "S", "M", "G"):
        mine = getattr(res, name).to_local()[:hi - lo]
        check(torch.equal(mine, getattr(ref, name)[lo:hi]),
              f"{what}: {name} differs from the unsharded step")
    check(int(res.next_idx) == int(ref.next_idx)
          and res.walk_chunks == ref.walk_chunks,
          f"{what}: next_idx or walk differs from the unsharded step")
    check(launches["K1"] == 1 and launches["K3"] == ref.walk_chunks >= 1,
          f"{what} launched {launches} in {ref.walk_chunks} walk chunks")
    # the two steps in turns, so that a drift of the card shows in both
    ms = {"sharded": [], "unsharded": []}
    for _ in range(SHARD_REPS):
        ms["sharded"].append(timed_ms(sharded)[1])
        ms["unsharded"].append(timed_ms(lambda: safeopt_step(
            kernels, states, grid, *a, chunk=32))[1])
    ms = {k: float(np.median(v)) for k, v in ms.items()}
    # num_valid on the card: 3 copies of the last row appended
    padded = torch.cat([grid, grid[-1:].expand(3, -1)])
    pres = safeopt_step(kernels, states, padded, *a, None, N, chunk=32)
    for name in ("S", "M", "G"):
        check(torch.equal(getattr(pres, name)[:N], getattr(ref, name))
              and not bool(getattr(pres, name)[N:].any()),
              f"num_valid flagship step {str(dtype)[6:]}: {name} differs "
              "from the unpadded step")
    check(int(pres.next_idx) == int(ref.next_idx),
          "num_valid flagship step: next_idx differs")
    if rank == 0:
        print(f"{what} ({smi}): equal to the unsharded step bit for bit, "
              f"{ref.walk_chunks} walk chunks, launches K1 "
              f"{launches['K1']} K3 {launches['K3']}; "
              f"{ms['sharded']:.3f} ms a sharded step, "
              f"{ms['unsharded']:.3f} ms unsharded (medians of "
              f"{SHARD_REPS}, in turns); num_valid on the padded grid "
              f"gives the unpadded step", flush=True)
    return {"launches": {k: launches[k] for k in ("K1", "K3")},
            "walk_chunks": ref.walk_chunks, "pad": pad,
            "sharded_ms": ms["sharded"], "unsharded_ms": ms["unsharded"]}


def shard_fleet(mesh):
    """Phase 22: fleet (a) of phase 20 (8 flagship campaigns, 8 float32
    iterations) with ``mesh=`` against the fleet without one: every field
    the mesh wraps (the states, queries, observations, next_idx, safe
    counts, has_safe, walk chunks) gathered whole and equal bit for
    bit."""
    from safeopt_torch.parallel import (run_safeopt_campaigns,
                                        stack_campaign_states)

    dev = torch.device("cuda", torch.cuda.current_device())
    kernels, per = fleet_flagship_states(dev)
    grid64 = torch.tensor(fleet_grid(), dtype=torch.float64, device=dev)
    K, G, n = len(per), len(kernels), FLEET_ITERS
    noise = torch.tensor(np.random.default_rng(20).normal(size=(K, n, G)),
                         dtype=torch.float64, device=dev)
    t = functools.partial(torch.tensor, dtype=torch.float64, device=dev)
    args = (t(FMIN), BETA, t(SCALING), t([0.0] * G))
    kw = dict(objectives=flag_objectives(), dtype=torch.float32, chunk=32,
              noise_std=FLEET_NOISE, n_iter=n)
    batched = stack_campaign_states(per)
    plain = run_safeopt_campaigns(kernels, batched, grid64, *args, noise,
                                  **kw)
    zero_launches()
    sharded = run_safeopt_campaigns(kernels, batched, grid64, *args, noise,
                                    mesh=mesh, **kw)
    launches = read_launches()
    for name in ("next_idx", "xs", "ys", "safe_counts", "has_safe",
                 "walk_chunks"):
        check(torch.equal(getattr(sharded, name).full_tensor().cpu(),
                          getattr(plain, name).cpu()),
              f"fleet (a) with mesh=: {name} differs from the fleet "
              "without a mesh")
    for g, (st, ref) in enumerate(zip(sharded.states, plain.states)):
        for field, a, b in zip(ref._fields, st, ref):
            check(torch.equal(a.full_tensor(), b),
                  f"fleet (a) with mesh=: GP {g}'s {field} differs from "
                  "the fleet without a mesh")
    return {k: launches[k] for k in ("K1", "K3")}


def shard_certified_case(label, opt, mesh, tally, timed=False):
    """Phase 22's certified case on ``opt``'s state (its own settings):
    the host-oracle pair and, unless ``opt`` has contexts, the
    device-oracle triple, each on ``shard_grid``'s ``DTensor`` and on the
    whole grid, with the row nearest a threshold given the inverse of its
    float32 verdict before the last pass; every result bit for bit. The
    sharded calls' launches are added to ``tally``. Returns ``({protocol:
    (sharded, unsharded) host syncs}, ms)``: with ``timed`` the
    device-oracle step's ms each way (medians of SHARD_REPS in turns),
    else None."""
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.parallel import replicate, shard_grid, shard_state
    from safeopt_torch.parallel.sharded_step import _Shards
    from safeopt_torch.utils.observability import host_syncs

    dev = opt.device
    kernels, states = opt._model_args()
    c = opt._step_consts()
    beta = float(opt.beta(opt.t))
    consts = (c["fmin"], beta, c["scaling"], c["threshold"])
    N, k, chunk = opt.inputs.shape[0], opt._boundary_k, opt._expander_chunk
    band = opt._boundary_band
    grid, _ = shard_grid(opt._grid(), mesh)
    grid64, _ = shard_grid(torch.tensor(opt.inputs, dtype=torch.float64,
                                        device=dev), mesh)
    sh = _Shards(grid)
    sides = {"unsharded": dict(states=states, grid=grid.full_tensor(),
                               consts=consts, grid64=grid64.full_tensor()),
             "sharded": dict(states=tuple(shard_state(st, mesh)
                                          for st in states),
                             grid=grid, consts=replicate(consts, mesh),
                             grid64=grid64)}
    scan_kw = dict(
        refine_band=opt._refine_band, k=k, refine_k=opt._refine_k,
        refine_band_k=(opt._refine_band_k if opt._interval_precision
                       else 0), interval_precision=opt._interval_precision)
    fmin = np.atleast_1d(np.asarray(opt.fmin, dtype=np.float64))
    ostates, kinds = zip(*(g.device_oracle_state() for g in opt.gps))
    oracle_kw = dict(constrained=tuple(bool(np.isfinite(f)) for f in fmin),
                     k=k, kinds=kinds)
    fmin64 = torch.tensor(fmin, device=dev)

    def both(fn):
        """``fn(name, side)`` unsharded, then sharded with its launches
        counted into ``tally``: the two results and the host syncs
        (sharded, unsharded)."""
        out, syncs = {}, {}
        for name, side in sides.items():
            if name == "sharded":
                zero_launches()
            before = host_syncs.count
            out[name] = fn(name, side)
            torch.cuda.synchronize()
            syncs[name] = host_syncs.count - before
        for key, v in read_launches().items():
            tally[key] += v
        return out["unsharded"], out["sharded"], (syncs["sharded"],
                                                 syncs["unsharded"])

    def rows(whole, mine, what):
        check(torch.equal(mine.to_local(),
                          whole[sh.offset:sh.offset + sh.n]),
              f"{label} {what} differs from the unsharded call")

    def same_step(ref, res, what):
        for name in ("Q", "S", "M", "G"):
            rows(getattr(ref, name), getattr(res, name), f"{what}: {name}")
        check(torch.equal(res.next_idx, ref.next_idx)
              and torch.equal(res.diag, ref.diag)
              and res.walk_chunks == ref.walk_chunks,
              f"{label} {what}: next_idx, diag or the walk differs from the "
              "unsharded call")

    def planted(fix_idx, fix_bits, row, S):
        """The fixes with slot 0 moved to ``row`` and its bit the inverse
        of ``S[row]``, the pass-1 float32 verdict."""
        fix_idx, fix_bits = fix_idx.clone(), fix_bits.clone()
        fix_idx[0], fix_bits[0] = row, not bool(S[row])
        return fix_idx, fix_bits

    def pass2_wrote(res, row, S, what):
        check(bool(res.S[row]) != bool(S[row]),
              f"{label} {what}: the planted bit was not written")

    syncs = {}
    # the host-oracle pair --------------------------------------------------
    ref, res, n1 = both(lambda _, a: core.certified_scan(
        kernels, a["states"], a["grid"], *a["consts"], band, None, N,
        chunk=chunk, **scan_kw))
    same_step(ref[0], res[0], "certified_scan")
    check(torch.equal(res[1], ref[1]),
          f"{label} certified_scan: packed differs from the unsharded call")
    host = ref[1].cpu().numpy()
    idx, within = host[7:7 + k], host[7 + k:7 + 2 * k].astype(bool)
    safe64 = np.ones(k, dtype=bool)
    for i, g in enumerate(opt.gps):
        if np.isfinite(fmin[i]):
            mu, var = g.predict_f64(opt.inputs[idx])
            safe64 &= mu - beta * np.sqrt(var) > fmin[i]
    S1 = ref[0].S
    fixes = planted(torch.tensor(np.where(within, idx, -1), dtype=torch.int32,
                                 device=dev),
                    torch.tensor(within & safe64, device=dev), int(idx[0]),
                    S1)
    Q1 = {"unsharded": ref[0].Q, "sharded": res[0].Q}
    ref, res, n2 = both(lambda name, a: core.safeopt_step_from_Q(
        kernels, a["states"], a["grid"], Q1[name], *fixes, *a["consts"],
        None, N, chunk=chunk))
    same_step(ref, res, "safeopt_step_from_Q")
    pass2_wrote(ref, int(idx[0]), S1, "safeopt_step_from_Q")
    syncs["host oracle"] = (n1[0] + n2[0], n1[1] + n2[1])
    if opt.num_contexts:
        return syncs, None

    # the device-oracle triple ----------------------------------------------
    def scan_and_oracle(_, a):
        Q, packed_t = core.interval_scan(kernels, a["states"], a["grid"],
                                         *a["consts"][:3], band, N, **scan_kw)
        return Q, packed_t, core.device_oracle(
            kernels, ostates, a["grid64"], Q, packed_t, fmin64, beta,
            **oracle_kw)

    def finish(a, Q, packed_t, fix):
        return core.certified_finish(kernels, a["states"], a["grid"], Q,
                                     packed_t, *fix, *a["consts"], None, N,
                                     chunk=chunk)

    ref, res, n1 = both(scan_and_oracle)
    rows(ref[0], res[0], "interval_scan: Q")
    check(torch.equal(res[1], ref[1]),
          f"{label} interval_scan: packed_t differs from the unsharded call")
    for name, a, b in zip(("fix_idx", "fix_bits", "flips", "n_within"),
                          ref[2], res[2]):
        check(torch.equal(a, b), f"{label} device_oracle: {name} differs "
                                 "from the unsharded call")
    row = int(ref[1][2])
    S1 = torch.all(ref[0][:, 0::2] > c["fmin"], dim=1)
    fix = (*planted(*ref[2][:2], row, S1), *ref[2][2:])
    scans = {"unsharded": ref, "sharded": res}
    ref, res, n2 = both(lambda name, a: finish(a, *scans[name][:2], fix))
    same_step(ref[0], res[0], "certified_finish")
    check(torch.equal(ref[1], res[1]),
          f"{label} certified_finish: diag9 differs from the unsharded call")
    pass2_wrote(ref[0], row, S1, "certified_finish")
    syncs["device oracle"] = (n1[0] + n2[0], n1[1] + n2[1])
    if not timed:
        return syncs, None

    def step(a):
        Q, packed_t, fix = scan_and_oracle(None, a)
        return finish(a, Q, packed_t, fix)[1].cpu()

    ms = {"sharded": [], "unsharded": []}
    for _ in range(SHARD_REPS):
        for name, a in sides.items():
            ms[name].append(timed_ms(lambda: step(a))[1])
    return syncs, {name: float(np.median(v)) for name, v in ms.items()}


def shard_certified(mesh, rank, smi):
    """Phase 22's certified path: phase 12's cap-512 state (phase 3's
    GPs, 400 observations, the 1000 x 1000 grid) in float32 at
    ``interval_precision='high'`` with ``SafeOpt``'s own refinement
    budget and in float64 on the plain certified path, and the contextual
    state (cap 256, 240 observations, context 0) in float32 at
    ``'high'`` (``shard_certified_case``). Returns the sharded calls'
    launches of K1-3p, K1, K3, K2-3p, K2 and K4, each at least 1, the
    host syncs and the float32 step's ms."""
    from safeopt_torch import SafeOpt, linearly_spaced_combinations

    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    params_np = linearly_spaced_combinations([(-3.0, 3.0)], 1_000_000)
    tally = dict.fromkeys(("K1", "K3", "K2", "K4", "K1-3p", "K2-3p"), 0)

    def cap512(dtype, **kw):
        gps = build_gps(np.random.default_rng(512), 400, 512, "cuda", dtype,
                        spread=4.0)
        return SafeOpt(gps, grid_np, fmin=FMIN, beta=BETA, scaling=SCALING,
                       expander_chunk=32, exact_boundaries=True, **kw)

    syncs, ms = {}, None
    for label, opt in (
            ("cap 512 float32 'high'",
             cap512(torch.float32, interval_precision="high")),
            ("cap 512 float64", cap512(torch.float64))):
        syncs[label], got = shard_certified_case(
            label, opt, mesh, tally, timed=opt.dtype == torch.float32)
        ms = ms or got
    ctx = SafeOpt(context_gps(2, 240, 256, "cuda", torch.float32), params_np,
                  fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                  expander_chunk=32, exact_boundaries=True,
                  interval_precision="high")
    ctx.context = 0.0
    label = "contextual float32 'high'"
    syncs[label], _ = shard_certified_case(label, ctx, mesh, tally)
    missing = [key for key, n in tally.items() if n < 1]
    check(not missing, f"the sharded certified path launched {tally}: "
                       f"{missing} never")
    for label, per in syncs.items():
        for protocol, (n_sharded, n_whole) in per.items():
            check(n_sharded <= n_whole,
                  f"{label} {protocol}: {n_sharded} host syncs sharded, "
                  f"{n_whole} unsharded")
    if rank == 0:
        print(f"sharded certified path on mesh {tuple(mesh.mesh.shape)} "
              f"({smi}): cap 512 float32 'high' and float64, contextual "
              f"float32 'high', host and device oracles with a planted "
              f"flip, bit for bit the unsharded calls; launches {tally}; "
              f"the float32 device-oracle step {ms['sharded']:.3f} ms "
              f"sharded, {ms['unsharded']:.3f} ms unsharded (medians of "
              f"{SHARD_REPS}, in turns); host syncs (sharded, unsharded) "
              f"{syncs}", flush=True)
    return {"launches": tally, "syncs": {label: {p: list(v) for p, v in
                                                 per.items()}
                                         for label, per in syncs.items()},
            "sharded_ms": ms["sharded"], "unsharded_ms": ms["unsharded"]}


def shard_main(world, rank, port, out_path):
    """``chip_smoke.py --shard-to FILE [WORLD RANK PORT]``: phase 22 in a
    process of its own with an NCCL group (world size 1 by default), its
    numbers written to FILE as JSON."""
    import torch.distributed as dist

    from safeopt_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        print("chip_smoke sharding: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        mesh = make_mesh(device_type="cuda")
        out = {str(dt)[6:]: shard_case(mesh, dt, rank, smi)
               for dt in (torch.float64, torch.float32)}
        out["fleet"] = shard_fleet(mesh)
        out["certified"] = shard_certified(mesh, rank, smi)
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def run_shard_child(world, out_path, timeout=600):
    """Start ``shard_main`` in ``world`` child processes (one card each)
    and wait for them; the run fails if any fails."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-to", out_path,
         str(world), str(rank), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs = []
    try:
        for child in children:
            logs.append(child.communicate(timeout=timeout)[0])
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for child, log in zip(children, logs):
        check(child.returncode == 0, f"phase 22's process failed "
                                     f"({child.returncode}):\n{log[-4000:]}")
    print(logs[0].rstrip(), flush=True)
    with open(out_path) as fh:
        return json.load(fh)


def drive_sharding(smi):
    """Phase 22: the sharded step, fleet and certified path on a (1, 1)
    NCCL mesh in a child process, and on data axes of 2 and 4 where the
    host has as many cards. Returns the sharded paths' launches of K1-K4,
    K1-3p and K2-3p."""
    import os
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    launches = dict.fromkeys(("K1", "K3", "K2", "K4", "K1-3p", "K2-3p"), 0)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        worlds = [1] + [w for w in (2, 4) if torch.cuda.device_count() >= w]
        for world in worlds:
            out = run_shard_child(world, os.path.join(tmp, f"{world}.json"))
            for k in ("K1", "K3"):
                launches[k] += sum(out[dt]["launches"][k]
                                   for dt in ("float64", "float32"))
                launches[k] += out["fleet"][k]
            for k, n in out["certified"]["launches"].items():
                launches[k] += n
            print(f"sharding, {world} card(s) ({smi}): fleet (a) with "
                  f"mesh= equal to the fleet without one, launches K1 "
                  f"{out['fleet']['K1']} K3 {out['fleet']['K3']}",
                  flush=True)
    cards = torch.cuda.device_count()
    missing = [w for w in (2, 4) if cards < w]
    if missing:
        print(f"sharding: the meshes with a data axis of {missing} did "
              f"not run ({cards} card(s))", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 23: the native host factor engine
# ---------------------------------------------------------------------------

NATIVE_SWEEP = (16, 32, 64, 128, 256)        # observations, cap 512
ENGINES = ("native", "scipy", "default")


def _turns(items, i):
    """``items`` rotated by ``i``: each takes every place in turn, so
    that a drift of the host shows in all alike."""
    i %= len(items)
    return items[i:] + items[:i]


def _engine(gps, engine):
    """``gps`` refactored by ``engine``: 'native' (the engine at every
    size), 'scipy' (SciPy alone, gram included) or 'default' (the engine
    up to ``NATIVE_MAX_ROWS`` observations). Returns the refit's ms for
    all of them (host clock, the device mirrors rebuilt with each)."""
    from safeopt_torch.gp.host_math import NATIVE_MAX_ROWS

    for g in gps:
        g._host._use_native = engine != "scipy"
        g._host._native_max_rows = (10 ** 9 if engine == "native"
                                    else NATIVE_MAX_ROWS)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for g in gps:
        g.refit()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def _append_ms(gps, x):
    """ms of one append of ``x`` to every GP of ``gps`` (``append_data``,
    add_new_data_point's update, host clock), undone by a pop outside
    the clock."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for g in gps:
        g.append_data(x, float(np.exp(-0.5 * x @ x)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    for g in gps:
        g.pop_data()
    return ms


def _engine_times(sets, pts, refits):
    """{engine: (median ms of a refit, median ms of an append)} of the
    GP sets ``sets`` {engine: GPs}, the engines in turns: ``refits``
    {engine: count} refits, then one append per point of ``pts``."""
    ref = {e: [] for e in sets}
    app = {e: [] for e in sets}
    for i in range(max(refits.values())):
        for e in _turns(list(sets), i):
            if i < refits[e]:
                ref[e].append(_engine(sets[e], e))
    for i, x in enumerate(pts):
        for e in _turns(list(sets), i):
            app[e].append(_append_ms(sets[e], x))
    return {e: (float(np.median(ref[e])), float(np.median(app[e])))
            for e in sets}


def _host_sweep():
    """The host factor alone (RBF, two inputs, cap 512) at each row count
    of ``NATIVE_SWEEP``: median ms of ``set_data`` (6) and of an append
    (20) with the engine and with SciPy, in turns."""
    from safeopt_torch import RBF
    from safeopt_torch.gp.host_math import HostFactor

    rng = np.random.default_rng(231)
    out = {}
    for n in NATIVE_SWEEP:
        X = rng.uniform(-4.0, 4.0, size=(n, 2))
        Y = rng.normal(size=(n, 1))
        pts = rng.uniform(-4.0, 4.0, size=(20, 2))
        hfs, sets, apps = {}, {}, {}
        for engine in ("native", "scipy"):
            hfs[engine] = HostFactor(RBF(2, variance=2.0, lengthscale=0.5),
                                     512, 2, 0.01)
            hfs[engine]._use_native = engine == "native"
            hfs[engine]._native_max_rows = 10 ** 9
            sets[engine], apps[engine] = [], []
        for i in range(6):
            for engine in _turns(["native", "scipy"], i):
                start = time.perf_counter()
                hfs[engine].set_data(X, Y)
                sets[engine].append((time.perf_counter() - start) * 1e3)
        for i, x in enumerate(pts):
            for engine in _turns(["native", "scipy"], i):
                start = time.perf_counter()
                hfs[engine].append(x, 0.1)
                apps[engine].append((time.perf_counter() - start) * 1e3)
                hfs[engine].pop()
        out[n] = {e: (float(np.median(sets[e])), float(np.median(apps[e])))
                  for e in hfs}
    return out


def drive_native(grid64, smi):
    """Phase 23: ``safeopt_torch.native`` built, and the cap-512 state's
    GPs (phase 3's, 400 observations) factored by the engine against the
    same GPs factored by SciPy: posterior mean and variance on the grid
    within 1e-9. Then the engines' times on the host's clock, in turns:
    ms per refit and per append of one observation to every GP, with the
    engine, with SciPy and with the default (the engine up to
    ``NATIVE_MAX_ROWS`` observations), on the flagship (cap 64, 50
    observations), the cap-512 state and phase 18's exact GP (cap 2048,
    2000 observations; one native refit, as it takes seconds); and the
    host factor alone across ``NATIVE_SWEEP``'s row counts, which places
    ``NATIVE_MAX_ROWS``."""
    from safeopt_torch import native
    from safeopt_torch.gp.host_math import NATIVE_MAX_ROWS

    check(native.available(), "the native host engine did not build")
    states = {"cap 64": (50, 64, 2, 64, 1.5), "cap 512": (400, 512, 2, 512,
                                                          4.0),
              "cap 2048": (2000, 2048, 1, 2048, 4.0)}
    sets = {label: {e: flagship_gps(n, cap, g, seed=seed, spread=spread,
                                    dtype=torch.float64) for e in ENGINES}
            for label, (n, cap, g, seed, spread) in states.items()}
    for label in ("cap 64", "cap 512"):
        for e in ENGINES:
            _engine(sets[label][e], e)
    err = 0.0
    for gn, gs in zip(sets["cap 512"]["native"], sets["cap 512"]["scipy"]):
        for a, b in zip(gn.predict_noiseless(grid64),
                        gs.predict_noiseless(grid64)):
            err = max(err, float((a - b).abs().max()))
    check(err <= 1e-9, f"native and SciPy factors part by {err:.3e} on the "
                       "grid")
    pts = np.random.default_rng(23).uniform(-4.0, 4.0, size=(20, 2))
    ms = {label: _engine_times(sets[label], pts, dict.fromkeys(ENGINES, 5))
          for label in ("cap 64", "cap 512")}
    ms["cap 2048"] = _engine_times(sets["cap 2048"], pts[:6],
                                   {"native": 1, "scipy": 3, "default": 3})
    sweep = _host_sweep()
    print(f"native host engine ({smi}): cap-512 posterior on the grid "
          f"within {err:.3e} of the SciPy factor's; NATIVE_MAX_ROWS "
          f"{NATIVE_MAX_ROWS}; ms per refit / per append of one "
          f"observation to every GP (add_new_data_point's update; host "
          f"clock, engines in turns, medians of 5 refits and 20 appends; "
          f"at cap 2048 of 3 refits, one native, and 6 appends):",
          flush=True)
    for label, row in ms.items():
        print(f"  {label}: " + "; ".join(
            f"{e} {row[e][0]:.3f} / {row[e][1]:.3f}" for e in ENGINES),
            flush=True)
    print("  host factor alone, cap 512, ms of set_data / of an append, "
          "native against SciPy (in turns, medians of 6 and 20): "
          + "; ".join(f"{n} rows {r['native'][0]:.3f} / "
                      f"{r['native'][1]:.3f} vs {r['scipy'][0]:.3f} / "
                      f"{r['scipy'][1]:.3f}" for n, r in sweep.items()),
          flush=True)
    return err, ms


# ---------------------------------------------------------------------------
# phase 24: the examples
# ---------------------------------------------------------------------------

EXAMPLE_RUNS = [    # tests/test_examples.py's cases and iteration counts
    ("example_1d.py", ("--algo", "grid", "--iters", "4")),
    ("example_1d.py", ("--algo", "swarm", "--iters", "3")),
    ("example_2d.py", ("--iters", "3")),
    ("example_multiple_constraints.py", ("--iters", "4")),
    ("example_context.py", ("--iters", "2")),
    ("example_on_device_loop.py", ("--iters", "4")),
    ("example_pendulum_tuning.py", ("--iters", "8")),
    ("example_pendulum_tuning.py", ("--iters", "3", "--fleet", "8")),
    ("example_campaign_fleet.py", ("--iters", "3")),
    ("example_long_campaign.py", ("--n-pre", "60", "--iters", "6",
                                  "--inducing", "9")),
    ("example_quasi_periodic.py", ("--iters", "8", "--refit-every", "4")),
    ("example_pipelined_campaign.py", ("--iters", "5", "--dim", "3")),
]


def drive_examples(smi):
    """Phase 24: every script of ``examples_torch/`` in this process on
    the card (``--device cuda``), its own asserts the checks; prints each
    one's wall seconds. Returns the launches of K1-K4 over the phase."""
    import contextlib
    import io
    import os
    import runpy

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples_torch")
    zero_launches()
    for script, argv in EXAMPLE_RUNS:
        old = sys.argv
        sys.argv = [script, *argv, "--device", "cuda"]
        buf = io.StringIO()
        start = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(root, script),
                               run_name="__main__")
        except SystemExit as e:
            check(not e.code, f"{script} exited with {e.code}")
        except Exception as e:              # the script's own checks
            fail(f"{script} {' '.join(argv)} failed: {e!r}\n"
                 f"{buf.getvalue()[-2000:]}")
        finally:
            sys.argv = old
        text = buf.getvalue()
        check("best" in text or "fleet" in text,
              f"{script} printed no best or fleet line")
        last = [ln for ln in text.splitlines() if ln.strip()][-1]
        print(f"example {script} {' '.join(argv)} on {smi}: "
              f"{time.perf_counter() - start:.2f} s wall; {last.strip()}",
              flush=True)
    return read_launches()


def main():
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    clock = phase_clock()

    from safeopt_torch import SafeOpt, linearly_spaced_combinations
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops._build import build_info, library, sass_opcodes
    from safeopt_torch.ops.topk import top_k

    clock("1")
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

    clock("2")
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
    # the float32 K1-3p and K2-3p (csrc/fused_intervals3.cu: the resident
    # body's static and wide plans for K2-3p, three consumer warpgroups a
    # block and one, and the tiled body's three instances) run on
    # Hopper's warpgroup product: their SASS holds HGMMA
    sass = sass_opcodes("HGMMA")
    hgmma = {k: v for k, v in sass.items()
             if any(name in k for name in THREE_PASS_KERNELS)}
    for name, count in sorted(hgmma.items()):
        print(f"  sass: {name}: {count} HGMMA", flush=True)
    check(len(hgmma) == 9 and min(hgmma.values()) > 0,
          f"the wgmma instances of K1-3p/K2-3p hold no HGMMA: {hgmma}")
    # B1-3p's and B4's: four limb policies (bf16 or tf32, cut by the
    # wrapper or in the kernel) on the resident body with one and three
    # consumer warpgroups and on the tiled body; B2-3p's and B3-3p's
    # (rank1_*, mu_*) on the same three
    hgmma3 = {k: v for k, v in sass.items()
              if "wg3_kernel" in k or "tiled3_kernel" in k}
    for name, count in sorted(hgmma3.items()):
        print(f"  sass: {name}: {count} HGMMA", flush=True)
    check(len(hgmma3) == 18 and min(hgmma3.values()) > 0,
          f"the wgmma instances of B1-3p-B3-3p/B4 hold no HGMMA: {hgmma3}")

    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    grid64 = torch.tensor(grid_np, dtype=torch.float64, device="cuda")

    clock("3")
    # 3. K1 against its plain version -----------------------------------------
    k1_err64, k1_err32 = check_k1("G=2 cap=64", 50, 64, 2, grid64, seed=0)
    check_k1("G=2 cap=512", 400, 512, 2, grid64, seed=512, spread=4.0)
    check_k1("G=2 cap=512, counts 20 and 300 in one launch", (20, 300), 512,
             2, grid64, seed=512, spread=4.0)
    check_k1("G=1 cap=1024 (600 obs, gram not resident)", 600, 1024, 1,
             grid64, seed=1024, spread=4.0)
    check_k1("G=1 cap=64", 50, 64, 1, grid64, seed=0)

    clock("4")
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

    clock("5")
    # 5. K2 against its plain version on contextual GPs ----------------------
    k2_err, _ = check_k2("1 GP cap=64 (50 obs)", 50, 64, grid64)
    n_k2 = 250          # K2 and K4 are timed at the 250-observation GP
    err, k2_ops = check_k2("1 GP cap=256 (250 obs, factor streamed)", n_k2,
                           256, grid64)
    k2_ops32 = k2_ops[torch.float32]
    k2_err = max(k2_err, err)
    err, k2_512_ops = check_k2("1 GP cap=512 (400 obs; float64 on the tiled "
                               "body)", 400, 512, grid64)
    k2_err = max(k2_err, err)
    err, _ = check_k2("1 GP cap=1024 (600 obs, gram not resident)", 600,
                      1024, grid64)
    k2_err = max(k2_err, err)
    # measure.py's context1024 and context2048 GP 0: a long campaign over
    # contexts in [-1, 1], past the resident rows (the tiled body)
    err, k2_1024_ops = check_k2(
        "1 GP cap=1024 (600 obs, contexts in [-1, 1], tiled body)", 600,
        1024, grid64, spread_contexts=True, bounded=True)
    k2_err = max(k2_err, err)
    err, k2_2048_ops = check_k2(
        "1 GP cap=2048 (2000 obs, contexts in [-1, 1], tiled body)", 2000,
        2048, grid64, spread_contexts=True, bounded=True)
    k2_err = max(k2_err, err)
    err, _ = check_k2("Sum with Bias and Cosine leaves, cap=64", 50, 64,
                      grid64, variant="extra")
    k2_err = max(k2_err, err)
    err, k2_nine = check_k2("the contextual kernel as nine leaves (wide "
                            "plan), cap=256 (250 obs)", n_k2, 256, grid64,
                            variant="nine")
    k2_nine_ops32 = k2_nine[torch.float32]
    k2_err = max(k2_err, err)
    err, k2_nine_1024 = check_k2(
        "the contextual kernel as nine leaves (wide tiled plan), cap=1024 "
        "(600 obs)", 600, 1024, grid64, variant="nine")
    k2_err = max(k2_err, err)

    clock("6")
    # 6. K4 against its plain version on contextual candidates ---------------
    k4_err, k4_ops32 = check_k4(grid64)
    k4_err = max(k4_err, check_k4(grid64, variant="nine")[0])

    clock("7")
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

    clock("8")
    # 8. the interval-stage experiments B1-B5 ---------------------------------
    from safeopt_torch.ops import interval_experiments as ie
    from tools_torch import bench_interval_experiments as bx

    f32, f64 = torch.float32, torch.float64
    exp_ops = {dt: cap512_operands(dt, grid_np) for dt in (f64, f32)}
    exp_errs, b4_dq = check_experiments("G=2 cap=512 (400 obs)",
                                        exp_ops[f64], exp_ops[f32])
    b4_dq = {"cap512": b4_dq}
    flag_ops = [fp.interval_operands(
        [g.kern for g in gps], [g.state for g in gps], grid64.to(dt), BETA)
        for dt in (f64, f32)
        for gps in [build_gps(np.random.default_rng(0), 50, 64, "cuda", dt)]]
    for name, err in check_experiments("G=2 cap=64", *flag_ops)[0].items():
        exp_errs[name] = max(exp_errs[name], err)
    # B4 through the tiled body: measure.py's long-campaign states
    long_ops = {name: {dt: long_operands(name, dt, grid_np)
                       for dt in (f64, f32)}
                for name in ("cap1024", "cap2048")}
    for name, ops in long_ops.items():
        # B2's gram sums and B5's modes: the gram-only body past cap 512
        for key, err in check_gram_rows(f"{name} (G=1)", ops[f64], ops[f32],
                                        plain_too=True).items():
            exp_errs[key] = max(exp_errs[key], err)
        errs, b4_dq[name] = check_split(f"{name} (G=1)", ops[f64], ops[f32],
                                        SPARSE_SCALING)
        for key, err in errs.items():
            exp_errs[key] = max(exp_errs[key], err)
        # B2-3p and B3-3p through the tiled body. At the exact GP
        # (cap2048) the rank-1 stand-in's last 32 rows of V = Lm x[:, 0]
        # z[0] are the innovations of a linear function after 1968 rows,
        # near zero: dropping them moves the rows by about 0.08 of any
        # worst-case bound of the rows (PERF.md section 7), so that fault
        # is printed there, not held
        for key, what in (("B2-3p solve_rank1", "solve_rank1"),
                          ("B3-3p", "mu_from_gram")):
            err = check_three_pass(
                f"{name} (G=1)", ops, SPARSE_FMIN, SPARSE_SCALING, what=what,
                hold_last=not (name == "cap2048" and what == "solve_rank1"))[0]
            exp_errs[key] = max(exp_errs[key], err)
    zero_launches()
    start = time.perf_counter()
    exp_results = bx.run(exp_ops[f32], EXPERIMENT_REPS,
                         {name: ops[f32] for name, ops in long_ops.items()})
    torch.cuda.synchronize()
    exp_s = time.perf_counter() - start
    exp_launches = experiment_launches()
    check(all(n > 0 for n in exp_launches.values()),
          f"an experiment kernel was never launched on its path: "
          f"{exp_launches}")
    check(all(v["bitexact"] for v in exp_results["B1"]["variants"])
          and all(v for k, v in exp_results["B1"].items()
                  if k.endswith("_bitexact"))
          and all(res[limb]["hoisted_bitexact"] for limb in ie.LIMBS
                  for res in (exp_results["B4"], *(
                      exp_results["B4"][name] for name in long_ops))),
          "the experiment path lost K1's bits (B1), K1-3p's (B1-3p) or "
          "B4's limb pair")
    print(f"experiment path (the five harnesses, cap 512, float32, and B4 "
          f"at {', '.join(long_ops)}; {EXPERIMENT_REPS} reps): launches "
          f"{exp_launches}; {exp_s:.1f} s (host clock)", flush=True)
    for name, res in exp_results.items():
        print(f"  {name}: {json.dumps(res)}", flush=True)
    b1 = exp_results["B1"]
    print(f"B1-3p float32 at its automatic layout: "
          f"{b1[f'3pass_wgmma_{bx.layout_tag(0, 0, 0, -1)}_ms']:.4f} ms "
          f"against K1-3p {b1['K1-3p_ms']:.4f} / {b1['K1-3p_ms_after']:.4f} "
          f"ms before / after it ({b1['3pass_auto_vs_K1-3p']:.4f} x) on "
          f"{smi}", flush=True)
    for name in ("cap512", *long_ops):
        r2, r3 = ((exp_results[h] if name == "cap512" else exp_results[h][
            name]) for h in ("B2", "B3"))
        body = "resident" if name == "cap512" else "tiled"
        print(f"B2-3p / B3-3p {name} on {smi} (the wgmma {body} body): "
              f"B2-3p {r2['3pass_solve_only_ms']:.4f} ms, gram sums "
              f"{r2['gram_sums_ms']:.4f}, (gram + solve) / B1-3p "
              f"{r2['3pass_wgmma_total_ms']:.4f} = "
              f"{r2['3pass_sum_vs_wgmma_total']:.4f}; B3-3p "
              f"{r3['3pass_mxu_emit_ms']:.4f} ms against B1-3p "
              f"{r3['3pass_wgmma_base_ms']:.4f} "
              f"({r3['3pass_mxu_emit_vs_wgmma_base']:.4f} x); K1-3p "
              f"{r2['K1-3p_ms']:.4f} / {r3['K1-3p_ms']:.4f}", flush=True)
    for name in ("cap512", *long_ops):
        r5 = exp_results["B5"] if name == "cap512" else exp_results["B5"][
            name]
        print(f"B5 {name} GP 0 on {smi} (B2's gram sums and B5's modes on "
              f"the gram-only body): full (K1) {r5['full_ms']:.4f} ms, "
              f"no product {r5['no_product_ms']:.4f}, epilogue "
              f"{r5['epilogue_ms']:.4f}: product share "
              f"{r5['product_share']:.4f}, gram share "
              f"{r5['gram_share']:.4f} (3-pass full "
              f"{r5['full_3pass_ms']:.4f} ms: {r5['product_share_3pass']:.4f}"
              f" / {r5['gram_share_3pass']:.4f})", flush=True)
    for name in ("cap512", *long_ops):
        res = exp_results["B4"] if name == "cap512" else exp_results["B4"][
            name]
        print(f"B4 {name} on {smi}: " + "; ".join(
            f"{limb} in-kernel {res[limb]['inkernel_ms']:.4f} ms, hoisted "
            f"{res[limb]['hoisted_ms']:.4f} ms, max scaled |dQ| against "
            f"float64 {b4_dq[name][f'B4 {limb}']:.3e}" for limb in ie.LIMBS)
            + f"; K1 (float32 FMAs) {res['K1_ms']:.4f} ms, max scaled |dQ| "
            f"{b4_dq[name]['K1']:.3e}; tf32 / K1 {res['tf32_vs_K1']:.4f}",
            flush=True)

    clock("9")
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

    clock("10")
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

    clock("11")
    # 11. K1-3p and K2-3p against their plain versions ---------------------
    # the exact GP at capacity 2048 (phase 16's data; phase 18 holds K1 on
    # it too)
    exact = {dt: [sparse_exact_gp("cuda", dt)] for dt in (f64, f32)}
    exact_ops = {dt: fp.interval_operands([g.kern for g in gps],
                                          [g.state for g in gps],
                                          grid64.to(dt), BETA)
                 for dt, gps in exact.items()}
    k1_3p_ops = {}
    k1_3p_err = 0.0
    for label, args in (("G=2 cap=64", (50, 64, 2, grid64, 0)),
                        ("G=2 cap=512", (400, 512, 2, grid64, 512, 4.0)),
                        ("G=2 cap=512, counts 20 and 300 in one launch",
                         ((20, 300), 512, 2, grid64, 512, 4.0)),
                        ("G=1 cap=1024 (600 obs, gram not resident)",
                         (600, 1024, 1, grid64, 1024, 4.0)),
                        ("G=1 cap=2048 (exact GP, 2000 obs)", None),
                        ("G=2 cap=2048, counts 50 and 1500 in one launch",
                         ((50, 1500), 2048, 2, grid64, 2048, 4.0))):
        ops = exact_ops if args is None else k1_operands(*args)
        G = ops[f32][2].shape[0]
        k1_3p_ops[label] = ops
        err, dq, _ = check_three_pass(
            f"{label}, {fp.three_pass_body(ops[f32][2].shape[1])} body", ops,
            *((SPARSE_FMIN, SPARSE_SCALING) if args is None
              else (FMIN[:G], SCALING[:G])))
        k1_3p_err = max(k1_3p_err, err)
        if label == "G=2 cap=512":
            k1_3p_dq = dq
    k2_3p_err = 0.0
    k2_3p_by_label = {}
    for label, n_obs, cap, variant in (
            ("1 GP cap=256 (250 obs)", n_k2, 256, None),
            ("Sum with Bias and Cosine leaves, cap=64", 50, 64, "extra"),
            ("the contextual kernel as nine leaves (wide plan), cap=256",
             n_k2, 256, "nine"),
            ("context1024 (600 obs, contexts in [-1, 1])", 600, 1024, None),
            ("context2048 (2000 obs, contexts in [-1, 1])", 2000, 2048,
             None),
            ("the contextual kernel as nine leaves (wide plan), cap=1024 "
             "(600 obs)", 600, 1024, "nine")):
        # phase 5's operands where it built the state
        ops = {(600, 1024, None): k2_1024_ops, (2000, 2048, None): k2_2048_ops,
               (600, 1024, "nine"): k2_nine_1024}.get((n_obs, cap, variant))
        if ops is None:
            ops = {}
            for dt in (f64, f32):
                gp = context_gps(1, n_obs, cap, "cuda", dt,
                                 variant=variant)[0]
                ops[dt] = fp.interval_plan_operands(gp.kern, gp.state,
                                                    grid64.to(dt), BETA)
        k2_3p_by_label[label] = ops
        err, dq, _ = check_three_pass(
            f"{label}, {fp.three_pass_body(cap)} body", ops, CTX_FMIN[:1],
            [math.sqrt(float(ops[f64][7][1]))], what="plan")
        k2_3p_err = max(k2_3p_err, err)
        if label == "1 GP cap=256 (250 obs)":
            k2_3p_ops, k2_3p_dq = ops[f32], dq
    # the body each float32 launch ran, by the launchers' rule
    # (fused_posterior.three_pass_body: the resident body up to capacity
    # 576, the tiled body past it)
    bodies = [
        ("K1-3p", fp.fused_intervals3, "cap 512",
         k1_3p_ops["G=2 cap=512"][f32]),
        ("K1-3p", fp.fused_intervals3, "cap 1024",
         k1_3p_ops["G=1 cap=1024 (600 obs, gram not resident)"][f32]),
        ("K1-3p", fp.fused_intervals3, "cap 2048", exact_ops[f32]),
        ("K2-3p", fp.fused_intervals_plan3, "cap 256", k2_3p_ops),
        ("K2-3p", fp.fused_intervals_plan3, "cap 1024", k2_1024_ops[f32]),
        ("K2-3p", fp.fused_intervals_plan3, "cap 2048", k2_2048_ops[f32]),
        ("K2-3p", fp.fused_intervals_plan3, "nine leaves, cap 1024",
         k2_nine_1024[f32])]
    # the body each K1 launch ran, by the launcher's rule: the tiled one
    # past the resident rows (float32 past cap 512, float64 past 256)
    k1_bodies = [(label, dt, by_dtype[dt])
                 for label, by_dtype in (
                     ("flagship cap 64", k1_3p_ops["G=2 cap=64"]),
                     ("cap 512", k1_3p_ops["G=2 cap=512"]),
                     ("cap 1024", k1_3p_ops[
                         "G=1 cap=1024 (600 obs, gram not resident)"]),
                     ("cap 2048", exact_ops))
                 for dt in (f32, f64)]
    # and each K2 launch, by the same rule (a plan past the static
    # leaves: the wide instances)
    k2_bodies = [(label, dt, by_dtype[dt])
                 for label, by_dtype in (
                     ("cap 256", k2_ops), ("cap 512", k2_512_ops),
                     ("cap 1024", k2_1024_ops), ("cap 2048", k2_2048_ops),
                     ("nine leaves, cap 256", k2_nine),
                     ("nine leaves, cap 1024", k2_nine_1024))
                 for dt in (f32, f64)]
    # one kernel_names call for all three: where this long process's
    # profiler loses a record, one fresh child names them all
    ran = kernel_names(
        [(launch, ops) for _, launch, _, ops in bodies]
        + [(fp.fused_intervals, ops) for _, _, ops in k1_bodies]
        + [(fp.fused_intervals_plan, ops) for _, _, ops in k2_bodies])
    for (key, launch, label, ops), names in zip(bodies, ran):
        cap = ops[2].shape[1] if key == "K1-3p" else ops[1].shape[0]
        want = THREE_PASS_BODY[key][fp.three_pass_body(cap)]
        print(f"{key} body, {label}, float32: {names} (the rule: {want})",
              flush=True)
        check(len(names) == 1 and f"safeopt::{want}" in names[0],
              f"{key} {label} ran {names}, not {want}")
    ran = ran[len(bodies):]
    for (label, dt, ops), names in zip(k1_bodies, ran):
        cap = ops[2].shape[1]
        want = ("intervals_tiled_kernel" if cap > K1_RESIDENT_ROWS[dt]
                else "intervals_kernel")
        print(f"K1 body, {label}, {str(dt)[6:]}: {names} (the rule: "
              f"{want})", flush=True)
        check(len(names) == 1 and f"safeopt::{want}<" in names[0],
              f"K1 {label} {dt} ran {names}, not {want}")
    for (label, dt, ops), names in zip(k2_bodies, ran[len(k1_bodies):]):
        cap = ops[1].shape[0]
        wide = "wide_" if ops[5].shape[0] > fp.MAX_LEAVES else ""
        want = (f"intervals_plan_{wide}tiled_kernel"
                if cap > K2_RESIDENT_ROWS[dt]
                else f"intervals_plan_{wide}kernel")
        print(f"K2 body, {label}, {str(dt)[6:]}: {names} (the rule: "
              f"{want})", flush=True)
        check(len(names) == 1 and f"safeopt::{want}<" in names[0],
              f"K2 {label} {dt} ran {names}, not {want}")
    # the float64 K1-3p keeps intervals.cuh's resident ThreePassProduct
    # body at every capacity (a check of the bands, no route of the card's
    # float32 path): its time once at capacities 512, 1024 and 2048
    for label, ops in (("cap 512 (G=2, 400 obs)",
                        k1_3p_ops["G=2 cap=512"][f64]),
                       ("cap 1024 (600 obs)", k1_3p_ops[
                           "G=1 cap=1024 (600 obs, gram not resident)"][f64]),
                       ("cap 2048 (exact GP, 2000 obs)", exact_ops[f64])):
        _, ms = timed_ms(lambda: fp.fused_intervals3(*ops))
        print(f"K1-3p float64 {label} (resident ThreePassProduct body): "
              f"{ms:.3f} ms, one launch", flush=True)
    # the tiled body's time at the long campaigns' states, beside its
    # bound and the factor's bytes it streams from L2 a launch
    N, d = grid_np.shape
    tiled_times = {}
    for key, label, launch, plain, ops, n, leaves in (
            ("K1-3p", "cap1024", fp.fused_intervals3,
             fp.fused_intervals3_plain,
             k1_3p_ops["G=1 cap=1024 (600 obs, gram not resident)"][f32],
             600, None),
            ("K1-3p", "cap2048", fp.fused_intervals3,
             fp.fused_intervals3_plain, exact_ops[f32], 2000, None),
            ("K2-3p", "context1024", fp.fused_intervals_plan3,
             fp.fused_intervals_plan3_plain, k2_1024_ops[f32], 600,
             plan_leaves(k2_1024_ops[f32][4], k2_1024_ops[f32][6])),
            ("K2-3p", "context2048", fp.fused_intervals_plan3,
             fp.fused_intervals_plan3_plain, k2_2048_ops[f32], 2000,
             plan_leaves(k2_2048_ops[f32][4], k2_2048_ops[f32][6]))):
        cap = ops[2].shape[1] if key == "K1-3p" else ops[1].shape[0]
        body = fp.three_pass_body(cap)
        b_ms, b_by = split_bound("bf16", N, d, cap, n, leaves=leaves)
        k_ms = cuda_ms(lambda: launch(*ops), reps=3)
        p_ms = cuda_ms(lambda: plain(*ops), reps=1, warmup=0)
        l2 = three_pass_l2_bytes(N, n, body)
        tiled_times[(key, label)] = (k_ms, p_ms, b_ms)
        print(f"{key} {label} float32 ({body} body): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share of "
              f"the bound {b_ms / k_ms:.1%}; the factor's limb chunks from "
              f"L2 {l2 / 1e9:.2f} GB a launch ({l2 / k_ms / 1e9:.3f} TB/s)",
              flush=True)

    clock("12")
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
    # the tiled K1-3p / K2-3p body on a certified path: three steps each
    # of the exact GP at capacity 2048 and of context2048 (device oracle)

    def exact2048(device, dtype, **kw):
        return SafeOpt([sparse_exact_gp(device, dtype)], grid_np,
                       fmin=SPARSE_FMIN, beta=BETA, scaling=SPARSE_SCALING,
                       expander_chunk=32, **kw)

    # its band holds about 3,800 rows at context 0, past the default
    # triage budget (1,024), where the uncertified rows rest on their
    # float32 error and two of the first step's safe bits differed from
    # float64 on the card (ROADMAP Queue 3 entry 19): the budget covers
    # the band here
    def context2048(device, dtype, **kw):
        return SafeOpt(context_gps(2, 2000, 2048, device, dtype,
                                   spread_contexts=True), params_np,
                       fmin=CTX_FMIN, beta=BETA, num_contexts=1,
                       expander_chunk=32, boundary_k=LONG_CERT_TRIAGE,
                       **kw)

    certified["cap 2048"] = drive_certified(
        "cap 2048 (exact GP, 2000 obs, tiled K1-3p)", exact2048,
        lambda x, c: plant(cert_rng, x)[:, :1], [None] * LONG_CERT_STEPS,
        iters=LONG_CERT_STEPS, oracles=("device",))
    certified["context2048"] = drive_certified(
        "context2048 (2000 obs over contexts in [-1, 1], tiled K2-3p)",
        context2048, ctx_plant, [0.0] * LONG_CERT_STEPS,
        iters=LONG_CERT_STEPS, oracles=("device",))
    torch.cuda.empty_cache()    # the long campaigns' float64 twins' memory
    for name, kern3, kern1, per_step, iters in (
            ("cap 512", "K1-3p", "K1", 1, 10),
            ("contextual", "K2-3p", "K2", 2, 10),
            ("contextual, 20 obs", "K2-3p", "K2", 2, 10),
            ("cap 2048", "K1-3p", "K1", 1, LONG_CERT_STEPS),
            ("context2048", "K2-3p", "K2", 2, LONG_CERT_STEPS)):
        for oracle, (n, c_ms, p_ms, _, _) in certified[name].items():
            check(n[kern3] == iters * per_step
                  and n[kern1] == iters * per_step,
                  f"{name} certified ({oracle}): {kern3} launched "
                  f"{n[kern3]} times and {kern1} {n[kern1]}, not "
                  f"{iters * per_step} each")
            other = ("K2", "K2-3p") if kern1 == "K1" else ("K1", "K1-3p")
            check(n[other[0]] == n[other[1]] == 0,
                  f"{name} certified ({oracle}) launched {other}")
            print(f"{name} certified path ({oracle} oracle) times (CUDA "
                  f"events, iterations 2-{iters}): median optimize() "
                  f"{float(np.median(c_ms[1:])):.3f} ms against the float32 "
                  f"plain twin's {float(np.median(p_ms[1:])):.3f} ms",
                  flush=True)

    clock("13")
    # 13. mixed routes: GP 1 on the eager route ------------------------------
    mixed_ms, mixed_eager_ms = drive_mixed(grid_np)

    clock("14")
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

    clock("15")
    # 15. run_lagged_campaign, pipelined against serial -----------------------
    lagged = drive_lagged(grid_np)

    clock("16")
    # 16. the sparse path -----------------------------------------------------
    sparse_errs = check_sparse_kernels(grid64)
    sparse_paths, sparse_cert = drive_sparse(grid_np, grid64)

    clock("17")
    # 17. hyperparameter fits on the card -------------------------------------
    fit_s = drive_fits()

    clock("18")
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
    # (past the resident gram: the tiled body); its host factorization
    # runs after the other kernels' timings, which a busy host would
    # lengthen. Held against its plain version in both dtypes, then timed.
    k1_2048_err64, _ = check_k1_gps(
        "G=1 cap=2048 (exact GP, 2000 obs, tiled body)", exact, grid64,
        SPARSE_FMIN, SPARSE_SCALING, bounded=True)
    ops2048 = exact_ops
    time_kernel("K1 cap=2048 (exact GP, 2000 observations)",
                lambda: fp.fused_intervals(*ops2048[f32]),
                lambda: fp.fused_intervals_plain(*ops2048[f32]),
                *interval_bound(f32, 1, N, d, 2048, 2000), reps=3)
    # K2 past its resident rows: phase 5's context1024 and context2048
    # states, timed after the others (phase 11 names the bodies)
    for label, ops, reps in (
            ("K2 cap=1024 (600 obs, contexts in [-1, 1])",
             k2_1024_ops[f32], 10),
            ("K2 cap=2048 (2000 obs, contexts in [-1, 1])",
             k2_2048_ops[f32], 3)):
        time_kernel(label, lambda o=ops: fp.fused_intervals_plan(*o),
                    lambda o=ops: fp.fused_intervals_plan_plain(*o),
                    *interval_bound(f32, 1, N, d, ops[1].shape[0],
                                    int(ops[7][3]),
                                    plan_leaves(ops[4], ops[6])), reps=reps)
    long_ctx, long_opt_ms, long_add_ms = drive_long_context(params_np)

    # K1, K3 and K1-3p count their main paths' launches: the flagship's
    # (K1-3p: the cap-512 certified runs') and the sparse path's
    sparse_n = sparse_paths["sparse c=0"][0]
    sparse_3p = sum(r[0]["K1-3p"] for r in sparse_cert.values())
    k1_err64 = max([k1_err64, k1_2048_err64]
                   + [e[0] for e in sparse_errs.values()])
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
                     sum(r[0]["K1-3p"] for name in ("cap 512", "cap 2048")
                         for r in certified[name].values())
                     + sparse_3p, k1_3p_err)
    meta["K2-3p"] = ("K2-3p fused_intervals_plan3", "fused_intervals3.cu",
                     "safeopt_tpu/ops/fused_posterior.py:313",
                     sum(r[0]["K2-3p"] for name in ("contextual",
                                                    "contextual, 20 obs",
                                                    "context2048")
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
            "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": json_bound_by(b_by),
            # no single PyTorch call computes these fused functions
            "library_ms": None})
    kernels[0]["max_abs_err_f32"] = k1_err32
    # K1 past the resident gram: the exact GP at capacity 2048
    kernels[0]["cap2048_ms"], kernels[0]["cap2048_plain_ms"], \
        kernels[0]["cap2048_bound_ms"], _ = times[
            "K1 cap=2048 (exact GP, 2000 observations)"]
    # K2 past its resident rows (the tiled body), and the contextual
    # path at capacity 2048
    for cap, key in ((1024, "K2 cap=1024 (600 obs, contexts in [-1, 1])"),
                     (2048, "K2 cap=2048 (2000 obs, contexts in [-1, 1])")):
        kernels[2][f"cap{cap}_ms"], kernels[2][f"cap{cap}_plain_ms"], \
            kernels[2][f"cap{cap}_bound_ms"], _ = times[key]
    for entry, key in ((kernels[2], "K2"), (kernels[3], "K4")):
        entry["launches"] += long_ctx[key]
        entry["cap2048_path_launches"] = long_ctx[key]
    kernels[2]["cap2048_path_optimize_ms"] = long_opt_ms
    kernels[4]["max_scaled_err_f32_vs_f64"] = k1_3p_dq
    kernels[5]["max_scaled_err_f32_vs_f64"] = k2_3p_dq
    # past the resident rows: the tiled body at the long campaigns' states
    for (key, label), (k_ms, p_ms, b_ms) in tiled_times.items():
        entry = kernels[4 if key == "K1-3p" else 5]
        entry[f"{label}_ms"], entry[f"{label}_plain_ms"], \
            entry[f"{label}_bound_ms"] = k_ms, p_ms, b_ms
    kernels[4]["cap2048_path_launches"] = sum(
        r[0]["K1-3p"] for r in certified["cap 2048"].values())
    kernels[5]["context2048_path_launches"] = sum(
        r[0]["K2-3p"] for r in certified["context2048"].values())

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
                      f"3pass_wgmma_{bx.layout_tag(0, 0, 0, -1)}_ms"],
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
        src = ("interval_experiments3.cu"
               if key in ("B1-3p", "B2-3p", "B3-3p", "B4")
               else "interval_experiments.cu")
        if key in ("B2", "B5") and mode in ("solve_rank1", "epilogue"):
            ops = o32 if mode == "solve_rank1" else first
            t_ms, t_by = ablation_bound(mode, f32, ops[2].shape[0], N, d,
                                        512, n512, prescribed=True)
            print(f"  {name}: the work the kernel is told to do (every row "
                  f"of V) bounds at {t_ms:.4f} ms ({t_by}), "
                  f"{t_ms / k_ms:.1%} of it", flush=True)
        kernels.append({
            "name": f"{key} {wrapper} {mode}".strip(), "route": "cuda",
            "source": f"safeopt_torch/ops/csrc/{src}",
            "replaces": f"benchmarks/{tpu}", "launches": exp_launches[name],
            "max_abs_err": exp_errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": json_bound_by(b_by),
            "library_ms": None})
        if name in ("B2 gram_sums", "B5 no_product", "B5 epilogue"):
            # the gram-only body at the long-campaign states (G=1)
            entry, start = kernels[-1], time.perf_counter()
            for state, ops in long_ops.items():
                o_long = ops[f32]
                r = res[key][state]
                l_ms = r[f"{mode}_ms"]
                lb_ms, lb_by = ablation_bound(
                    mode, f32, 1, N, d, o_long[2].shape[1],
                    int(o_long[5][0, 3]))
                entry.update({
                    f"{state}_ms": l_ms, f"{state}_bound_ms": lb_ms,
                    f"{state}_plain_ms": cuda_ms(
                        lambda: ie.interval_ablation_plain(*o_long, mode),
                        reps=1, warmup=0)})
                print(f"  {name} {state}: kernel {l_ms:.4f} ms, bound "
                      f"{lb_ms:.4f} ms ({lb_by}), share of the bound "
                      f"{lb_ms / l_ms:.1%}", flush=True)
            print(f"  {name}: the long states' bounds and plain times in "
                  f"{time.perf_counter() - start:.1f} s (host clock)",
                  flush=True)
        if key in ("B2-3p", "B3-3p"):
            # B1-3p in the same call, and the tiled body at the
            # long-campaign states
            entry = kernels[-1]
            harness, k_key, b1_key, plain_long = (
                ("B2", "3pass_solve_only_ms", "3pass_wgmma_total_ms",
                 functools.partial(ie.interval_ablation_plain,
                                   mode="solve_rank1", three_pass=True))
                if key == "B2-3p" else
                ("B3", "3pass_mxu_emit_ms", "3pass_wgmma_base_ms",
                 functools.partial(ie.intervals_mu_from_gram_plain,
                                   three_pass=True)))
            entry["B1-3p_ms"] = res[harness][b1_key]
            for state, ops in long_ops.items():
                o_long, r = ops[f32], res[harness][state]
                lb_ms, _ = split_bound("bf16", N, d, o_long[2].shape[1],
                                       int(o_long[5][0, 3]),
                                       gram=key == "B3-3p")
                entry.update({
                    f"{state}_ms": r[k_key], f"{state}_bound_ms": lb_ms,
                    f"{state}_plain_ms": cuda_ms(
                        lambda: plain_long(*o_long), reps=1, warmup=0),
                    f"{state}_B1-3p_ms": r[b1_key]})
                print(f"  {name} {state} (tiled body): kernel "
                      f"{r[k_key]:.4f} ms, bound {lb_ms:.4f} ms, share of "
                      f"the bound {lb_ms / r[k_key]:.1%}; B1-3p "
                      f"{r[b1_key]:.4f} ms", flush=True)
        if key == "B4":
            # the hoisted limbs, the scaled error against float64 beside
            # K1's, and the tiled body at the long-campaign states
            entry, limb = kernels[-1], mode
            entry.update(hoisted_ms=res["B4"][limb]["hoisted_ms"],
                         max_scaled_err_f32_vs_f64=b4_dq["cap512"][name],
                         K1_max_scaled_err_f32_vs_f64=b4_dq["cap512"]["K1"])
            for state, ops in long_ops.items():
                n_long = int(ops[f32][5][0, 3])
                cap_long = ops[f32][2].shape[1]
                lb_ms, _ = split_bound(limb, N, d, cap_long, n_long)
                r = res["B4"][state]
                entry.update({
                    f"{state}_ms": r[limb]["inkernel_ms"],
                    f"{state}_hoisted_ms": r[limb]["hoisted_ms"],
                    f"{state}_bound_ms": lb_ms,
                    f"{state}_plain_ms": cuda_ms(
                        lambda: ie.intervals_split_plain(
                            *one_gp(ops[f32]), limb=limb), reps=1, warmup=0),
                    f"{state}_K1_ms": r["K1_ms"],
                    f"{state}_max_scaled_err_f32_vs_f64": b4_dq[state][name],
                    f"{state}_K1_max_scaled_err_f32_vs_f64":
                        b4_dq[state]["K1"]})
                print(f"  {name} {state} (tiled body): kernel "
                      f"{r[limb]['inkernel_ms']:.4f} ms (hoisted "
                      f"{r[limb]['hoisted_ms']:.4f}), bound {lb_ms:.4f} ms, "
                      f"share of the bound "
                      f"{lb_ms / r[limb]['inkernel_ms']:.1%}; K1 "
                      f"{r['K1_ms']:.4f} ms", flush=True)
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
    clock("19")
    # 19. the swarm ---------------------------------------------------------
    swarm = drive_swarm(smi)
    print_swarm(swarm, smi)
    clock("20")
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
    clock("21")
    # 21. the utilities -------------------------------------------------------
    via_ops = drive_utilities(grid_np, params_np, smi, exports)
    for entry, key in zip(kernels[:4], ("K1", "K3", "K2", "K4")):
        entry["launches"] += via_ops[key]
        entry["op_launches"] = via_ops[key]
    clock("22")
    # 22. sharding ------------------------------------------------------------
    sharded = drive_sharding(smi)
    for entry, key in zip(kernels, ("K1", "K3", "K2", "K4", "K1-3p",
                                    "K2-3p")):
        entry["launches"] += sharded[key]
        entry["sharded_launches"] = sharded[key]
    clock("23")
    # 23. the native host engine ----------------------------------------------
    drive_native(grid64, smi)
    clock("24")
    # 24. the examples --------------------------------------------------------
    example_launches = drive_examples(smi)
    for entry, key in zip(kernels[:4], ("K1", "K3", "K2", "K4")):
        entry["launches"] += example_launches[key]
        entry["example_launches"] = example_launches[key]
    clock(None)
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
    if len(sys.argv) == 3 and sys.argv[1] == "--profile-to":
        sys.exit(profile_main(sys.argv[2]))
    if len(sys.argv) == 5 and sys.argv[1] == "--kernel-names":
        sys.exit(kernel_names_main(sys.argv[2], sys.argv[3],
                                   int(sys.argv[4])))
    if len(sys.argv) == 6 and sys.argv[1] == "--shard-to":
        sys.exit(shard_main(int(sys.argv[3]), int(sys.argv[4]),
                            int(sys.argv[5]), sys.argv[2]))
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port of SafeOpt once on an NVIDIA GPU and check it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the CUDA kernels from ``safeopt_torch/ops/csrc``;
3. K1 (fused intervals) against its plain PyTorch version at G=2, d=2,
   N=1e6, capacity 64 (the flagship) and 512 (factor streamed), and
   G=1 at capacity 64: float64 kernel vs float64 plain to 1e-9; float32
   kernel vs float64 plain with identical ``l > fmin`` decisions outside
   a scaled band of 1e-3;
4. K3 (fused expander predicate) on a chunk of 32 flagship candidates
   from the head and the middle of the visit order, with padding slots,
   at several raised thresholds so that the plain predicate holds both
   values: float64 identical, float32 identical outside the band;
5. K5 (exact top-k) on CUDA tensors with massive ties and all -inf;
6. the main path: the flagship problem (two RBF GPs, 1000 x 1000 grid,
   50 observations, capacity 64, chunk 32) through ``SafeOpt.optimize``
   and ``add_new_data_point`` for 10 iterations against a NumPy plant,
   with the first query checked against the float64 plain path on the
   CPU and every kernel's launch count read around the run;
7. times of the main path and of each kernel against its plain version.

Any failed check exits non-zero. The last lines are one JSON object of
the kernels, the nvidia-smi line, and the result line.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

BAND = 1e-3          # scaled decision band for float32 comparisons
FMIN = [0.2, 0.5]
SCALING = [math.sqrt(2.0), 1.0]
BETA = 2.0
K3_SHIFTS = (0.0, 0.1, 0.3, 1.0)   # fmin raises, in units of scaling


def fail(msg):
    """Stop the run with a non-zero exit and the reason."""
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    """``fail(msg)`` unless ``cond`` holds."""
    if not cond:
        fail(msg)


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


def plant(rng, x):
    """One noisy measurement of the flagship's two functions at ``x``."""
    r2 = float(np.sum(np.asarray(x) ** 2))
    return np.array([[2.0 * math.exp(-0.5 * r2) + 0.05 * rng.normal(),
                      1.0 - 0.1 * r2 + 0.05 * rng.normal()]])


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


def decisions_agree(l32, l64, fmin, scaling):
    """(mismatches outside the band, rows inside the band)."""
    margin = (l64 - fmin) / scaling
    outside = margin.abs() > BAND
    wrong = ((l32 > fmin) != (l64 > fmin)) & outside
    return int(wrong.sum()), int((~outside).sum())


def check_k1(label, n_obs, cap, n_gps, grid64, seed, spread=1.5):
    """K1 vs its plain version in f64 and f32; returns both errors."""
    from safeopt_torch.ops import fused_posterior as fp

    out = {}
    for dtype in (torch.float64, torch.float32):
        gps = build_gps(np.random.default_rng(seed), n_obs, cap, "cuda",
                        dtype, spread=spread)[:n_gps]
        ops = fp.interval_operands([g.kern for g in gps],
                                   [g.state for g in gps],
                                   grid64.to(dtype), BETA)
        out[dtype] = (fp.fused_intervals(*ops), ops)
    k64, ops64 = out[torch.float64]
    k32, _ = out[torch.float32]
    p64 = fp.fused_intervals_plain(*ops64)
    torch.cuda.synchronize()
    err64 = (k64 - p64).abs().max().item()
    diff32 = (k32.double() - p64).abs()
    scale = torch.tensor(SCALING[:n_gps], dtype=torch.float64,
                         device="cuda")[:, None, None]
    err32 = diff32.max().item()
    err32_scaled = (diff32 / scale).max().item()
    fmin = torch.tensor(FMIN[:n_gps], dtype=torch.float64,
                        device="cuda")[:, None]
    wrong, in_band = decisions_agree(k32[:, 0].double(), p64[:, 0], fmin,
                                     scale[:, :, 0])
    print(f"K1 {label}: f64 max|kernel-plain|={err64:.3e} (limit 1e-9); "
          f"f32 max abs err={err32:.3e}, max scaled err={err32_scaled:.3e}; "
          f"f32 decisions differing outside the {BAND:g} band={wrong} "
          f"(rows inside the band: {in_band})", flush=True)
    check(err64 <= 1e-9, f"K1 {label} f64 error {err64}")
    check(wrong == 0, f"K1 {label} f32 decisions differ outside the band")
    return err64, err32


def check_k3(gps64, gps32, grid64):
    """K3 vs its plain version in f64 and f32 on one chunk of 32 flagship
    candidates: the first 16 in visit order and 16 from the middle of it,
    with the last 4 slots padding (valid=False). It runs at fmin raised
    by each of ``K3_SHIFTS`` times the scaling, so that the plain
    predicate is false for some valid candidates; the check fails unless
    some launch holds both values. Returns the f64 error and the float32
    operands at the flagship's fmin."""
    from safeopt_torch.algorithms import safe_opt_core as core
    from safeopt_torch.ops import fused_expander as fe

    f64 = torch.tensor(FMIN, dtype=torch.float64, device="cuda")
    s64 = torch.tensor(SCALING, dtype=torch.float64, device="cuda")
    kerns = [g.kern for g in gps64]
    Q, mu, sigma = core._confidence_intervals(
        kerns, [g.state for g in gps64], grid64, BETA)
    S, _, cand, width, _ = core._classify(
        Q, f64, s64, torch.zeros(2, dtype=torch.float64, device="cuda"),
        BETA)
    n_cand = int(cand.sum())
    check(n_cand >= 64, f"only {n_cand} expander candidates")
    order = core._visit_order(torch.where(cand, width, float("-inf")),
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
    for delta in K3_SHIFTS:
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
    print(f"K3 G=2 cap=64 C=32 (16 head + 16 mid-order candidates, 4 pad "
          f"slots) at fmin + {list(K3_SHIFTS)} x scaling: plain hits per "
          f"shift {counts} of {2 * int(valid.sum())} valid; f64 predicates "
          f"differing={wrong64} (limit 0); f32 differing outside the band="
          f"{wrong32}, inside the band={in_band}; hits in pad slots="
          f"{pad_hits}", flush=True)
    check(mixed > 0, "no K3 launch had a plain predicate holding both "
                     "values, so the check cannot see a wrong hit")
    check(pad_hits == 0, "K3 reported a hit in a padding slot")
    check(wrong64 == 0, "K3 f64 predicate differs from its plain version")
    check(wrong32 == 0, "K3 f32 predicate differs outside the band")
    return err64, ops32


def main():
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    from safeopt_torch import SafeOpt, linearly_spaced_combinations
    from safeopt_torch.ops import fused_expander as fe
    from safeopt_torch.ops import fused_posterior as fp
    from safeopt_torch.ops._build import build_info, library
    from safeopt_torch.ops.topk import top_k

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

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

    grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
    grid64 = torch.tensor(grid_np, dtype=torch.float64, device="cuda")

    # 3. K1 against its plain version -----------------------------------------
    k1_err64, k1_err32 = check_k1("G=2 cap=64", 50, 64, 2, grid64, seed=0)
    check_k1("G=2 cap=512", 400, 512, 2, grid64, seed=512, spread=4.0)
    check_k1("G=1 cap=64", 50, 64, 1, grid64, seed=0)

    # 4. K3 against its plain version on flagship candidates ------------------
    gps64 = build_gps(np.random.default_rng(0), 50, 64, "cuda",
                      torch.float64)
    gps32 = build_gps(np.random.default_rng(0), 50, 64, "cuda",
                      torch.float32)
    k3_err64, ops32 = check_k3(gps64, gps32, grid64)

    # 5. K5: exact top-k on the card ------------------------------------------
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

    # 6. main path ------------------------------------------------------------
    def flagship(device, dtype):
        gps = build_gps(np.random.default_rng(0), 50, 64, device, dtype)
        return SafeOpt(gps, grid_np, fmin=FMIN, beta=BETA, scaling=SCALING,
                       expander_chunk=32)

    ref = flagship("cpu", torch.float64)        # plain path, float64
    x_ref = ref.optimize()
    idx_ref = ref.stats.last.next_index
    opt = flagship("cuda", None)                # float32 on the card
    plant_rng = np.random.default_rng(1)

    fp.fused_intervals.launches = 0
    fe.fused_expander.launches = 0
    opt_ms, add_ms, walked = [], [], 0
    for it in range(10):
        x, ms = timed_ms(opt.optimize)
        opt_ms.append(ms)
        last = opt.stats.last
        check(last.safe_count > 0, f"empty safe set at iteration {it}")
        walked += last.walk_chunks
        if it == 0:
            idx0 = last.next_index
            w = (ref.Q[:, 1::2] - ref.Q[:, 0::2]) / np.asarray(SCALING)
            gap = abs(w[idx0].max() - w[idx_ref].max())
            print(f"first query: port f32 index {idx0}, f64 plain index "
                  f"{idx_ref}, scaled-width gap {gap:.3e}", flush=True)
            check(idx0 == idx_ref or gap <= BAND,
                  "first query differs from the float64 plain path")
        y = plant(plant_rng, x)
        add_ms.append(timed_ms(lambda: opt.add_new_data_point(x, y))[1])
    maximum = opt.get_maximum()
    torch.cuda.synchronize()
    launches = {"K1": fp.fused_intervals.launches,
                "K3": fe.fused_expander.launches}
    check(maximum is not None and np.all(np.isfinite(maximum[0])),
          "get_maximum returned no point")
    check(launches["K1"] > 0, "K1 was never launched on the main path")
    check(launches["K3"] > 0 or walked == 0,
          "the walk ran but K3 was never launched")
    print(f"main path: 10 iterations, |S| last={opt.stats.last.safe_count}, "
          f"walk chunks={walked}, launches {launches}, "
          f"get_maximum x={np.round(maximum[0], 4).tolist()} "
          f"lb={maximum[1]:.4f}; x0 ref={np.round(x_ref, 4).tolist()}",
          flush=True)

    # 7. times ----------------------------------------------------------------
    med_opt = float(np.median(opt_ms[1:]))
    med_add = float(np.median(add_ms[1:]))
    print(f"main path times (CUDA events, iterations 2-10): median "
          f"optimize() {med_opt:.3f} ms, median add_new_data_point() "
          f"{med_add:.3f} ms; grid points/s "
          f"{grid_np.shape[0] / (med_opt / 1e3):.4g}",
          flush=True)
    ops32_k1 = fp.interval_operands(
        [g.kern for g in gps32], [g.state for g in gps32],
        grid64.float(), BETA)
    times = {
        "K1": (cuda_ms(lambda: fp.fused_intervals(*ops32_k1)),
               cuda_ms(lambda: fp.fused_intervals_plain(*ops32_k1))),
        "K3": (cuda_ms(lambda: fe.fused_expander(*ops32)),
               cuda_ms(lambda: fe.fused_expander_plain(*ops32))),
    }
    for name, (k_ms, p_ms) in times.items():
        print(f"{name} float32 at the flagship shapes: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms", flush=True)

    kernels = [
        {"name": "K1 fused_intervals", "route": "cuda",
         "source": "safeopt_torch/ops/csrc/fused_intervals.cu",
         "replaces": "safeopt_tpu/ops/fused_posterior.py:454",
         "launches": launches["K1"], "max_abs_err": k1_err64,
         "max_abs_err_f32": k1_err32,
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K3 fused_expander", "route": "cuda",
         "source": "safeopt_torch/ops/csrc/fused_expander.cu",
         "replaces": "safeopt_tpu/ops/fused_expander.py:233",
         "launches": launches["K3"], "max_abs_err": k3_err64,
         "ms": times["K3"][0], "plain_ms": times["K3"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

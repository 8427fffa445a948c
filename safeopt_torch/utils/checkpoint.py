"""Checkpoint and resume for optimization runs.

Counterpart of ``safeopt_tpu/utils/checkpoint.py``, in its format: one
``.npz`` with a ``__meta__`` JSON (the algorithm, its settings, each
kernel's spec) and arrays under the same names (each GP's data and
kernel parameters, the global store, the grid or the safe set). A
checkpoint that ``safeopt_tpu`` wrote loads here, and one written here
loads into ``safeopt_tpu``: the arrays and settings this package adds
are ignored there, and the settings that mean nothing here
(``use_pallas``) are read and ignored, and written as the JAX package's
default.

What this package adds, so that a resumed run continues bit for bit:

- each GP's host float64 factor (``gp{i}_L``, ``gp{i}_Linv``,
  ``gp{i}_w``; a sparse model's information state ``gp{i}_A``,
  ``gp{i}_b``) and its capacity. A checkpoint without them (the JAX
  package's) refactors the data, as the JAX package always does: equal
  to round-off, not bit for bit.
- ``SafeOptSwarm``'s ``torch.Generator`` state (``generator_state``). A
  JAX swarm checkpoint carries a JAX key instead, which no torch
  generator can continue: loading it restores the data and settings,
  seeds the generator from ``load(..., seed=)`` and warns. The port
  writes a JAX key made from its generator's seed, so that
  ``safeopt_tpu`` loads its swarm checkpoints, with a stream of its own.

Callable ``beta`` schedules cannot be serialized: ``save`` warns and
stores the current value; ``load(path, beta=...)`` restores a schedule.

``save_state`` / ``load_state`` persist the device loops' states
(``GPState``, ``SwarmIterState``, ``BOLoopResult``, ``SwarmLoopResult``,
fleet axes included) with tuples, lists, dicts, scalars, tensors and
generator states, so that a campaign or a fleet that dies resumes from
the tail of its noise and streams.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from ..gp import kernels as _kernels
from ..gp.regression import GPRegression
from ..gp.sparse import SparseGPRegression

__all__ = ["save", "load", "save_state", "load_state"]

_KERNEL_CLASSES = {"RBF": _kernels.RBF, "Matern32": _kernels.Matern32,
                   "Matern52": _kernels.Matern52,
                   "Exponential": _kernels.Exponential,
                   "Cosine": _kernels.Cosine}
# stationary kernels with extra hyperparameter leaves beyond
# (variance, lengthscale): class -> extra leaf names
_EXTRA_PARAM_CLASSES = {"RatQuad": (_kernels.RatQuad, ("power",))}
# constant-variance kernels without a meaningful lengthscale/ARD
_SCALAR_KERNEL_CLASSES = {"Bias": _kernels.Bias, "White": _kernels.White}
_COMPOSITE_CLASSES = {"Product": _kernels.Product, "Sum": _kernels.Sum}


def _np(t) -> np.ndarray:
    """A tensor (or array) as a host NumPy array."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _kernel_spec(kern, arrays, prefix):
    """Flatten a kernel into (json-able spec, named arrays)."""
    for cname, ccls in _COMPOSITE_CLASSES.items():
        if isinstance(kern, ccls):
            s1 = _kernel_spec(kern.k1, arrays, prefix + "p1_")
            s2 = _kernel_spec(kern.k2, arrays, prefix + "p2_")
            return {"type": cname, "k1": s1, "k2": s2}
    leaves = {"StdPeriodic": ("variance", "period", "lengthscale"),
              "Linear": ("variances",),
              "Poly": ("variance", "scale", "bias"),
              "MLP": ("variance", "weight_variance", "bias_variance")}
    name = type(kern).__name__
    static = {"StdPeriodic": ("input_dim", "ARD1", "ARD2"),
              "Poly": ("input_dim", "order")}.get(name, ("input_dim", "ARD"))
    if name in _EXTRA_PARAM_CLASSES:
        leaves[name] = ("variance", "lengthscale",
                        *_EXTRA_PARAM_CLASSES[name][1])
    elif name in _SCALAR_KERNEL_CLASSES:
        leaves[name], static = ("variance",), ("input_dim",)
    elif name in _KERNEL_CLASSES:
        leaves[name] = ("variance", "lengthscale")
    if name not in leaves or type(kern) is not getattr(_kernels, name):
        raise TypeError(f"cannot checkpoint kernel type {name}")
    for p in leaves[name]:
        arrays[prefix + p] = _np(getattr(kern, p))
    spec = {"type": name, **{s: getattr(kern, s) for s in static}}
    spec.update(active_dims=list(kern.active_dims), prefix=prefix)
    return spec


def _kernel_from_spec(spec, arrays):
    if spec["type"] in _COMPOSITE_CLASSES:
        return _COMPOSITE_CLASSES[spec["type"]](
            _kernel_from_spec(spec["k1"], arrays),
            _kernel_from_spec(spec["k2"], arrays))
    p = spec["prefix"]
    if spec["type"] == "StdPeriodic":
        return _kernels.StdPeriodic(
            spec["input_dim"], variance=arrays[p + "variance"],
            period=arrays[p + "period"],
            lengthscale=arrays[p + "lengthscale"], ARD1=spec["ARD1"],
            ARD2=spec["ARD2"], active_dims=spec["active_dims"])
    if spec["type"] == "Linear":
        return _kernels.Linear(
            spec["input_dim"], variances=arrays[p + "variances"],
            ARD=spec["ARD"], active_dims=spec["active_dims"])
    if spec["type"] == "Poly":
        return _kernels.Poly(
            spec["input_dim"], variance=arrays[p + "variance"],
            scale=arrays[p + "scale"], bias=arrays[p + "bias"],
            order=spec["order"], active_dims=spec["active_dims"])
    if spec["type"] == "MLP":
        return _kernels.MLP(
            spec["input_dim"], variance=arrays[p + "variance"],
            weight_variance=arrays[p + "weight_variance"],
            bias_variance=arrays[p + "bias_variance"],
            ARD=spec["ARD"], active_dims=spec["active_dims"])
    if spec["type"] in _EXTRA_PARAM_CLASSES:
        cls, extras = _EXTRA_PARAM_CLASSES[spec["type"]]
        kw = {e: arrays[p + e] for e in extras}
        return cls(spec["input_dim"], variance=arrays[p + "variance"],
                   lengthscale=arrays[p + "lengthscale"], ARD=spec["ARD"],
                   active_dims=spec["active_dims"], **kw)
    if spec["type"] in _SCALAR_KERNEL_CLASSES:
        return _SCALAR_KERNEL_CLASSES[spec["type"]](
            spec["input_dim"], variance=arrays[p + "variance"],
            active_dims=spec["active_dims"])
    cls = _KERNEL_CLASSES[spec["type"]]
    return cls(spec["input_dim"], variance=arrays[p + "variance"],
               lengthscale=arrays[p + "lengthscale"], ARD=spec["ARD"],
               active_dims=spec["active_dims"])


def _save_model(g, i, meta, arrays):
    """GP i's kernel spec, data and (this package's) exact state."""
    if isinstance(g, SparseGPRegression):
        # the base (data-model) kernel: the constructor re-derives the
        # floored view from (kern_base, conservative)
        meta["kernels"].append(_kernel_spec(g.kern_base, arrays, f"k{i}_"))
        meta["gp_models"].append("sparse")
        arrays[f"gp{i}_Z"] = np.asarray(g.Z)
        meta.setdefault("sparse_conservative", {})[str(i)] = \
            float(g.conservative)
        meta.setdefault("sparse_calibration", {})[str(i)] = g.calibration
        arrays[f"gp{i}_A"], arrays[f"gp{i}_b"] = g._A, g._b
        meta.setdefault("sparse_state", {})[str(i)] = {
            "pending": g._pending, "floor": g._floor,
            "refit_every": g._refit_every, "jitter": g._jitter}
    else:
        meta["kernels"].append(_kernel_spec(g.kern, arrays, f"k{i}_"))
        meta["gp_models"].append("exact")
        h = g._host
        arrays[f"gp{i}_L"], arrays[f"gp{i}_Linv"] = h.L, h.Linv
        arrays[f"gp{i}_w"] = h.w
        meta.setdefault("capacities", {})[str(i)] = h.capacity
    arrays[f"gp{i}_X"] = np.asarray(g.X_host)
    arrays[f"gp{i}_Y"] = np.asarray(g.Y_host)


def save(opt, path: str) -> None:
    """Serialize a SafeOpt / SafeOptSwarm run to ``path`` (.npz)."""
    from ..algorithms.safe_opt import SafeOpt
    from ..algorithms.swarm_opt import SafeOptSwarm

    callable_beta = opt._beta_is_callable
    if callable_beta:
        logging.warning(
            "checkpoint: beta is a callable schedule and cannot be "
            "serialized; storing the current value beta(t=%d)=%s. Pass "
            "the schedule back via load(path, beta=...) to resume "
            "exactly.", opt.t, opt.beta(opt.t))

    arrays = {}
    meta = {
        "algo": type(opt).__name__,
        "fmin": np.asarray(opt.fmin).tolist(),
        "beta": float(opt.beta(opt.t)),
        "beta_was_callable": bool(callable_beta),
        "threshold": np.asarray(opt.threshold).tolist(),
        "scaling": np.asarray(opt.scaling).tolist(),
        "num_contexts": opt.num_contexts,
        "noise_vars": [g.noise_var for g in opt.gps],
        "kernels": [],
        "gp_models": [],
    }
    for i, g in enumerate(opt.gps):
        _save_model(g, i, meta, arrays)
    meta["dtype"] = str(opt.gp.dtype).replace("torch.", "")
    arrays["x"] = opt.x
    arrays["y"] = opt.y

    if isinstance(opt, SafeOpt):
        arrays["parameter_set"] = np.asarray(opt.parameter_set)
        meta["lipschitz"] = (None if opt.lipschitz is None
                             else np.asarray(opt.lipschitz).tolist())
        meta["use_lipschitz"] = bool(opt.use_lipschitz)
        meta["expander_chunk"] = int(opt._expander_chunk)
        meta["use_pallas"] = None            # the JAX package's default
        meta["exact_boundaries"] = bool(opt._exact_boundaries)
        meta["boundary_band"] = float(opt._boundary_band)
        meta["boundary_k"] = int(opt._boundary_k)
        if opt._interval_precision is not None:
            meta["interval_precision"] = str(opt._interval_precision)
        meta["refine_k"] = int(opt._refine_k)
        meta["refine_band"] = float(opt._refine_band)
        meta["refine_band_k"] = int(opt._refine_band_k)
        meta["oracle"] = str(opt._oracle)
        if opt.num_contexts:
            arrays["context"] = np.asarray(opt.context)
    elif isinstance(opt, SafeOptSwarm):
        arrays["safe_set"] = opt.S
        arrays["greedy_point"] = opt.greedy_point
        meta["best_lower_bound"] = float(opt.best_lower_bound)
        meta["bounds"] = np.asarray(opt.bounds, dtype=float).tolist()
        meta["swarm_size"] = opt.swarm_size
        meta["max_iters"] = int(opt.max_iters)
        arrays["generator_state"] = opt._generator.get_state().numpy()
        # a threefry key the JAX package can wrap (its own stream)
        arrays["key"] = np.array(
            [0, opt._generator.initial_seed() & 0xFFFFFFFF], dtype=np.uint32)
    else:
        raise TypeError(f"cannot checkpoint {type(opt).__name__}")

    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _load_models(meta, arrays, device, dtype):
    """The GPs of a checkpoint: from this package's exact state when it is
    there, else refactored from their data (after construction on an
    identical placeholder row: NaN-routed observations give GPs
    differing data, which the optimizers' global-store init rejects)."""
    d = arrays["gp0_X"].shape[1]
    placeholder = np.zeros((1, d))
    models = meta.get("gp_models", ["exact"] * len(meta["kernels"]))
    where = dict(device=device, dtype=dtype)
    gps = []
    for i, kspec in enumerate(meta["kernels"]):
        kern = _kernel_from_spec(kspec, arrays)
        noise = meta["noise_vars"][i]
        if models[i] == "sparse":
            extra = meta.get("sparse_state", {}).get(str(i), {})
            gps.append(SparseGPRegression(
                placeholder, np.zeros((1, 1)), kern, noise_var=noise,
                inducing=arrays[f"gp{i}_Z"],
                conservative=meta.get("sparse_conservative",
                                      {}).get(str(i), 0.0),
                calibration=meta.get("sparse_calibration",
                                     {}).get(str(i), "max"),
                **{k: extra[k] for k in ("refit_every", "jitter")
                   if k in extra}, **where))
        else:
            cap = meta.get("capacities", {}).get(str(i))
            gps.append(GPRegression(placeholder, np.zeros((1, 1)), kern,
                                    noise_var=noise, capacity=cap, **where))
    return gps


def _restore_data(gps, meta, arrays):
    """Each GP's data: its saved exact state, or ``set_XY``."""
    for i, g in enumerate(gps):
        X, Y = arrays[f"gp{i}_X"], arrays[f"gp{i}_Y"]
        if f"gp{i}_Linv" in arrays:
            h = g._host
            n = X.shape[0]
            h.X[:], h.Y[:] = 0.0, 0.0
            h.X[:n], h.Y[:n] = X, Y.reshape(n, 1)
            h.L = arrays[f"gp{i}_L"].copy()
            h.Linv = arrays[f"gp{i}_Linv"].copy()
            h.w = arrays[f"gp{i}_w"].copy()
            h.count = n
            g._rebuilt()
        elif f"gp{i}_A" in arrays:
            extra = meta["sparse_state"][str(i)]
            g._X, g._Y = X.copy(), Y.copy()
            g._A = arrays[f"gp{i}_A"].copy()
            g._b = arrays[f"gp{i}_b"].copy()
            g._pending = int(extra["pending"])
            g._recompute_posterior()
            g._floor = float(extra["floor"])
            g.kern = g.kern_base                 # the floored view
        else:
            g.set_XY(X, Y)


def load(path: str, beta=None, *, seed: int = 0, device="cuda",
         dtype=None):
    """Rebuild an optimizer from a checkpoint, its models on ``device``
    (the card by default, as the package's entry points) in ``dtype``
    (default: the saved models', else ``config.default_dtype(device)``).

    ``beta`` overrides the stored constant (required to resume a run that
    used a callable schedule). ``seed`` seeds a ``SafeOptSwarm``'s
    generator when the checkpoint carries no generator state (one written
    by the JAX package, whose key no torch generator can continue: a
    warning says so).
    """
    from ..algorithms.safe_opt import SafeOpt
    from ..algorithms.swarm_opt import SafeOptSwarm

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}

    if meta.get("beta_was_callable") and beta is None:
        logging.warning(
            "checkpoint: the saved run used a callable beta schedule; "
            "resuming with the frozen value %s. Pass beta=<schedule> to "
            "restore it.", meta["beta"])
    if dtype is None and "dtype" in meta:
        dtype = getattr(torch, meta["dtype"])
    gps = _load_models(meta, arrays, device, dtype)
    gp_arg = gps if len(gps) > 1 else gps[0]
    beta = beta if beta is not None else meta["beta"]
    threshold = meta["threshold"]
    if isinstance(threshold, list) and len(threshold) == 1:
        threshold = threshold[0]

    if meta["algo"] == "SafeOpt":
        opt = SafeOpt(gp_arg, arrays["parameter_set"],
                      fmin=list(meta["fmin"]), lipschitz=meta["lipschitz"],
                      beta=beta, num_contexts=meta["num_contexts"],
                      threshold=threshold, scaling=meta["scaling"],
                      expander_chunk=meta.get("expander_chunk", 32),
                      exact_boundaries=meta.get("exact_boundaries", False),
                      boundary_band=meta.get("boundary_band", 1e-3),
                      boundary_k=meta.get("boundary_k"),
                      interval_precision=meta.get("interval_precision"),
                      refine_k=meta.get("refine_k"),
                      **{k: meta[k] for k in ("refine_band", "refine_band_k")
                         if k in meta},
                      oracle=meta.get("oracle", "auto"))
        if "use_lipschitz" in meta:
            opt.use_lipschitz = meta["use_lipschitz"]
        _restore_data(opt.gps, meta, arrays)
        if meta["num_contexts"]:
            opt.context = arrays["context"]
    elif meta["algo"] == "SafeOptSwarm":
        opt = SafeOptSwarm(gp_arg, fmin=list(meta["fmin"]),
                           bounds=[tuple(b) for b in meta["bounds"]],
                           beta=beta, threshold=threshold,
                           scaling=meta["scaling"],
                           swarm_size=meta["swarm_size"],
                           max_iters=meta.get("max_iters", 100), seed=seed)
        _restore_data(opt.gps, meta, arrays)
        opt.S = arrays["safe_set"]
        opt.greedy_point = arrays["greedy_point"]
        opt.best_lower_bound = float(meta["best_lower_bound"])
        if "generator_state" in arrays:
            opt._generator.set_state(
                torch.from_numpy(arrays["generator_state"]))
        else:
            logging.warning(
                "checkpoint: a JAX swarm checkpoint carries a JAX PRNG key, "
                "which no torch generator can continue; the swarm's stream "
                "restarts from seed=%d", seed)
    else:
        raise ValueError(f"unknown algorithm {meta['algo']!r}")

    # the global store exactly (it can hold NaN-masked rows that no
    # single GP has)
    opt._x = arrays["x"]
    opt._y = arrays["y"]
    return opt


# ---------------------------------------------------------------------------
# device loop-state persistence (device campaigns and fleets)
# ---------------------------------------------------------------------------

def _state_types():
    from ..algorithms.runner import BOLoopResult, SwarmLoopResult
    from ..algorithms.swarm_opt_fused import SwarmIterState
    from ..gp.regression import GPState

    return {"GPState": GPState, "SwarmIterState": SwarmIterState,
            "BOLoopResult": BOLoopResult, "SwarmLoopResult": SwarmLoopResult}


def _encode_state(obj, arrays, prefix):
    types = _state_types()
    for name, cls in types.items():
        if isinstance(obj, cls):
            return {"type": name, "fields": {
                f: _encode_state(getattr(obj, f), arrays, f"{prefix}{f}_")
                for f in obj._fields}}
    if isinstance(obj, dict):
        return {"type": "dict", "items": {
            k: _encode_state(v, arrays, f"{prefix}{k}_")
            for k, v in obj.items()}}
    if isinstance(obj, (tuple, list)):
        return {"type": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_encode_state(v, arrays, f"{prefix}{i}_")
                          for i, v in enumerate(obj)]}
    if obj is None:
        return {"type": "none"}
    if isinstance(obj, torch.Generator):
        key = prefix + "generator"
        arrays[key] = obj.get_state().numpy()
        return {"type": "generator", "key": key}
    if isinstance(obj, (int, float, bool)):
        return {"type": "scalar", "value": obj}
    key = prefix + "a"
    arrays[key] = _np(obj)
    return {"type": "array", "key": key}


def _decode_state(spec, arrays, device):
    types = _state_types()
    t = spec["type"]
    if t in types:
        return types[t](**{f: _decode_state(s, arrays, device)
                           for f, s in spec["fields"].items()})
    if t == "dict":
        return {k: _decode_state(s, arrays, device)
                for k, s in spec["items"].items()}
    if t in ("tuple", "list"):
        vals = [_decode_state(s, arrays, device) for s in spec["items"]]
        return tuple(vals) if t == "tuple" else vals
    if t == "none":
        return None
    if t == "scalar":
        return spec["value"]
    if t == "generator":
        gen = torch.Generator(device=device)
        gen.set_state(torch.from_numpy(arrays[spec["key"]]))
        return gen
    return torch.from_numpy(arrays[spec["key"]]).to(device)


def save_state(path: str, tree) -> None:
    """Serialize a device loop-state tree to ``path`` (.npz).

    Accepts any nesting of tuples, lists and dicts, the package's state
    NamedTuples (``GPState``, ``SwarmIterState``, ``BOLoopResult``,
    ``SwarmLoopResult``), tensors and arrays (fleet axes included),
    ``torch.Generator``s (their state) and Python scalars; tensors are
    pulled to the host.
    """
    arrays = {}
    spec = _encode_state(tree, arrays, "s_")
    np.savez(path, __state__=json.dumps(spec), **arrays)


def load_state(path: str, device="cuda"):
    """Rebuild a tree saved by ``save_state``: its tensors (and arrays)
    as tensors on ``device``, the card by default, its generators as
    generators there, with their dtypes and shapes."""
    with np.load(path, allow_pickle=False) as data:
        spec = json.loads(str(data["__state__"]))
        arrays = {k: data[k] for k in data.files if k != "__state__"}
    return _decode_state(spec, arrays, torch.device(device))

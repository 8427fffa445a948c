"""Export of the SafeOpt step and of whole campaigns for serving.

Counterpart of ``safeopt_tpu/utils/deployment.py``. ``torch.export``
traces the step, or a whole device-side campaign, into an
``ExportedProgram``; ``torch.export.save`` writes it as one artifact that
a serving process loads (``load_step``) and calls without tracing any
Python of this package again. Kernel hyperparameters, the GP states,
the grid and every scalar stay *runtime arguments*, as in the JAX
package: one artifact serves new observations and new hyperparameters.
Shapes are fixed at export (one artifact per capacity, grid size,
number of GPs and chunk).

What is traced is ``safe_opt_core.traced_safeopt_step``: the grid
kernels K1-K4 as ``torch.library`` operators (``ops/library.py``), so
that an artifact exported on the card launches them there and one
exported on the CPU runs their plain versions (the counterpart of
``use_pallas=False``; the device of the example arguments decides, and
there is no ``platforms`` or ``use_pallas`` argument); and the expander
walk as one ``while_loop``. PyTorch runs an exported ``while_loop`` by
reading its condition on the host: once before the loop, once before
each round and once after the last (rounds + 2), the loaded step's only
host reads. Unlike the JAX
artifact, whose Mosaic calls need no package, a serving process needs
this package's operators registered: ``load_step`` imports them.

The artifact's device is recorded beside it; the loaded callable moves
kernel hyperparameters that lie elsewhere (the port keeps them on the
host) to it, a copy per call that ``device_kernels`` spares a server.
"""

from __future__ import annotations

import importlib
import inspect
import io
import json
import os
from typing import Optional

import torch

__all__ = ["export_step", "load_step", "export_campaign",
           "export_swarm_campaign", "device_kernels"]

_DEVICE_FILE = "safeopt_torch_device"
_registered = False


def _register_serializations() -> None:
    """Register the port's kernel classes as pytree nodes (their
    hyperparameter tensors the leaves, the static fields a JSON context)
    and its state NamedTuples with names ``torch.export.save`` can store.
    The counterpart of the JAX package's ``_register_serializations``.
    Idempotent."""
    global _registered
    if _registered:
        return
    import torch.utils._pytree as pytree

    from ..algorithms.runner import BOLoopResult, SwarmLoopResult
    from ..algorithms.safe_opt_core import StepResult
    from ..algorithms.swarm_opt_fused import SwarmIterState
    from ..gp import kernels as K
    from ..gp.regression import GPState

    def leaf_kernel(cls):
        def flatten(k):
            static = tuple(sorted((n, v) for n, v in vars(k).items()
                                  if n not in k._leaves))
            return [getattr(k, n) for n in k._leaves], static

        def flatten_with_keys(k):
            children, static = flatten(k)
            return [(pytree.GetAttrKey(n), c)
                    for n, c in zip(k._leaves, children)], static

        def unflatten(children, static):
            k = cls.__new__(cls)
            vars(k).update(static)
            for n, c in zip(cls._leaves, children):
                setattr(k, n, c)
            return k

        def dump(static):
            return json.dumps([[n, list(v) if isinstance(v, tuple) else v]
                               for n, v in static])

        def load(text):
            return tuple((n, tuple(v) if isinstance(v, list) else v)
                         for n, v in json.loads(text))

        pytree.register_pytree_node(
            cls, flatten, unflatten,
            serialized_type_name=f"safeopt_torch.{cls.__name__}",
            to_dumpable_context=dump, from_dumpable_context=load,
            flatten_with_keys_fn=flatten_with_keys)

    def composite(cls):
        pytree.register_pytree_node(
            cls, lambda k: ([k.k1, k.k2], None),
            lambda children, _: cls(*children),
            serialized_type_name=f"safeopt_torch.{cls.__name__}",
            to_dumpable_context=lambda _: "",
            from_dumpable_context=lambda _: None,
            flatten_with_keys_fn=lambda k: (
                [(pytree.GetAttrKey("k1"), k.k1),
                 (pytree.GetAttrKey("k2"), k.k2)], None))

    for name in _SERIALIZABLE_KERNELS:
        cls = getattr(K, name)
        (composite if issubclass(cls, K._Composite) else leaf_kernel)(cls)
    for nt in (GPState, StepResult, BOLoopResult, SwarmLoopResult,
               SwarmIterState):
        pytree._register_namedtuple(
            nt, serialized_type_name=f"safeopt_torch.{nt.__name__}")
    _registered = True


#: kernel classes that export (every public class of ``gp.kernels``)
_SERIALIZABLE_KERNELS = ("RBF", "Matern32", "Matern52", "Exponential",
                         "RatQuad", "Cosine", "StdPeriodic", "Linear",
                         "Poly", "MLP", "Bias", "White", "Product", "Sum")


def _check_kernels_serializable(kernels) -> None:
    """Raise a one-line ``TypeError`` naming a kernel class that cannot
    export (a subclass or a class of the user's own), anywhere in a
    Product/Sum tree, before ``torch.export`` fails deep inside."""
    from ..gp import kernels as K

    allowed = tuple(getattr(K, name) for name in _SERIALIZABLE_KERNELS)

    def walk(kern):
        if isinstance(kern, K._Composite):
            for part in kern.parts:
                walk(part)
        if type(kern) not in allowed:
            raise TypeError(
                f"kernel class {type(kern).__name__!r} is not registered "
                "for torch.export serialization; exportable kernels: "
                f"{', '.join(_SERIALIZABLE_KERNELS)}")

    for kern in (kernels if isinstance(kernels, (list, tuple))
                 else [kernels]):
        walk(kern)


def device_kernels(kernels, device):
    """The kernels with their hyperparameters on ``device`` (a copy only
    of the tensors that lie elsewhere; dtypes kept): an exported step
    builds its operands from hyperparameters on its own device."""
    from ..gp.kernels import kernel_leaves, with_leaves

    return tuple(with_leaves(k, [t.to(device) for t in kernel_leaves(k)])
                 for k in kernels)


class _Program(torch.nn.Module):
    """A function as the module ``torch.export.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args, device, path) -> bytes:
    """``torch.export`` of ``fn`` on ``args`` (kernels first), saved with
    its device recorded; the bytes, written to ``path`` when given."""
    _register_serializations()
    _check_kernels_serializable(args[0])
    args = (device_kernels(args[0], device),) + tuple(args[1:])
    program = torch.export.export(_Program(fn), args, strict=False)
    # the example arguments (kernel objects among them) are not stored:
    # loading unpickles only tensors
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={_DEVICE_FILE: str(torch.device(device))})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def export_step(kernels, states, grid, fmin, beta, scaling, threshold, *,
                chunk: int = 64, ucb: bool = False,
                path: Optional[str] = None) -> bytes:
    """Serialize one SafeOpt iteration for the given shapes.

    The example arguments fix shapes, dtypes and the device only; the
    exported function takes ``(kernels, states, grid, fmin, beta,
    scaling, threshold)`` at call time (kernel hyperparameters
    included), ``beta`` a 0-d tensor, every tensor on the grid's device,
    and returns ``safe_opt_core.StepResult`` (``walk_chunks`` a 0-d
    tensor). Returns the bytes of ``torch.export.save``, also written to
    ``path`` when given.
    """
    from ..algorithms.safe_opt_core import traced_safeopt_step

    def step(kernels, states, grid, fmin, beta, scaling, threshold):
        return traced_safeopt_step(kernels, states, grid, fmin, beta,
                                   scaling, threshold, ucb=ucb, chunk=chunk)

    return _export(step, (tuple(kernels), tuple(states), grid, fmin, beta,
                          scaling, threshold), grid.device, path)


def load_step(blob_or_path):
    """Deserialize an exported step or campaign into a callable.

    Accepts the bytes from ``export_step`` / ``export_campaign`` /
    ``export_swarm_campaign``, a ``str`` or a ``pathlib.Path``. The
    returned callable has the artifact's exported signature (kernels
    first); it registers K1-K4's operators (``ops/library.py``) first,
    since the artifact calls them, and moves kernel hyperparameters that
    lie off the artifact's device onto it.
    """
    # the artifact calls K1-K4's operators: register them first
    importlib.import_module("..ops.library", __package__)
    _register_serializations()
    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as fh:
            blob = fh.read()
    else:
        blob = blob_or_path
    extra = {_DEVICE_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    # The generated guard function names each input by its path and
    # replaces the paths by prefix: GPState's ``L`` is a prefix of its
    # ``Linv``, and the code it writes does not parse. Without it the
    # module still checks the inputs' structure and shapes in a hook.
    kw = ({"check_guards": False} if "check_guards"
          in inspect.signature(program.module).parameters else {})
    module = program.module(**kw)
    device = torch.device(extra[_DEVICE_FILE])

    def call(kernels, *args):
        return module(device_kernels(kernels, device), *args)

    return call


def export_campaign(kernels, states, grid, fmin, beta, scaling, threshold,
                    noise=None, *, objectives, n_iter: int,
                    path: Optional[str] = None, **loop_kwargs) -> bytes:
    """Serialize an ENTIRE device-side SafeOpt campaign as one artifact.

    Wraps ``algorithms.runner.run_safeopt_loop`` on the traced step
    (``runner.safeopt_loop`` with ``traced_safeopt_step``): ``n_iter``
    iterations of the step, the objectives (traced in, baked), the noise
    and the float64 ``gp_append``. The float64 factor states, the grid,
    the scalars and the noise ``(n_iter, G)`` stay runtime arguments:
    the loaded callable has the signature ``(kernels, states, grid,
    fmin, beta, scaling, threshold, noise) -> BOLoopResult``, whose
    ``host_syncs`` are its walks' ``while_loop`` reads. The example
    states' capacities must admit ``n_iter`` more rows (checked here;
    the artifact cannot check them). One campaign: a fleet's states
    (a leading campaign axis) are refused.
    """
    from ..algorithms.runner import (_check_float64, check_capacity,
                                     safeopt_loop)
    from ..algorithms.safe_opt_core import traced_safeopt_step

    n_iter = int(n_iter)
    _check_float64(states, "export_campaign")
    if states[0].X.dim() != 2:
        raise ValueError("export_campaign takes one campaign's states")
    check_capacity(states, n_iter)

    def campaign(kernels, states, grid, fmin, beta, scaling, threshold,
                 *noise):
        return safeopt_loop(traced_safeopt_step, kernels, states, grid,
                            fmin, [beta] * n_iter, scaling, threshold,
                            *noise, objectives=objectives, n_iter=n_iter,
                            **loop_kwargs)

    return _export(campaign, (tuple(kernels), tuple(states), grid, fmin,
                              beta, scaling, threshold, *_given(noise)),
                   grid.device, path)


def export_swarm_campaign(kernels, states, iter_state, velocity_scale, bounds,
                          fmin, scaling, threshold, betas, greedy0, blb0,
                          streams, noise=None, *, objectives, n_iter: int,
                          swarm_size: int, max_iters: int,
                          path: Optional[str] = None,
                          **loop_kwargs) -> bytes:
    """``export_campaign`` for the SafeOptSwarm device loop
    (``runner.run_swarmopt_loop`` on the eager fused iteration, not its
    CUDA graph): objectives and loop structure baked in; the float64
    states, the safe-set buffer, the constants, the betas ``(n_iter,)``,
    the uniform streams ``(n_iter, U)`` and the noise runtime, in
    ``run_swarmopt_loop``'s order. Every tensor argument lies on the
    safe-set buffer's device."""
    from ..algorithms.runner import run_swarmopt_loop

    def campaign(kernels, states, iter_state, velocity_scale, bounds, fmin,
                 scaling, threshold, betas, greedy0, blb0, streams, *noise):
        return run_swarmopt_loop(
            kernels, states, iter_state, velocity_scale, bounds, fmin,
            scaling, threshold, betas, greedy0, blb0, streams, *noise,
            objectives=objectives, n_iter=n_iter, swarm_size=swarm_size,
            max_iters=max_iters, graph=False, **loop_kwargs)

    return _export(campaign, (tuple(kernels), tuple(states), iter_state,
                              velocity_scale, bounds, fmin, scaling,
                              threshold, betas, greedy0, blb0, streams,
                              *_given(noise)), iter_state.S.device, path)


def _given(noise):
    """The noise as a trailing runtime argument, or none: a campaign
    exported without noise takes one argument fewer."""
    return () if noise is None else (noise,)

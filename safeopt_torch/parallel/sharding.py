"""Several cards: device meshes and grid and state placement.

Counterpart of ``safeopt_tpu/parallel/sharding.py``, written the PyTorch
way. A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
initialised process group, one rank per card; its axes are the JAX
package's:

* ``data`` (``GRID_AXIS``): the candidate-grid rows. Every O(N) part of
  the step is row-parallel; the shards exchange only the step's few
  scalars, the walk's candidate chunks and its predicates.
* ``model`` (``MODEL_AXIS``): the GP factor rows. ``V = Linv k(X, grid)``
  contracts over them, so each ``model`` rank forms its partial mean and
  variance sums and one ``all_reduce`` over the axis adds them.
* ``dcn`` (``DCN_AXIS``, ``make_hier_mesh`` only): the hosts of a
  multi-host run, varying slowest; the grid rows shard over ``dcn`` and
  ``data`` jointly, and campaign fleets over ``dcn``.

A multi-host run is one ``torchrun`` per host (the counterpart of
``jax.distributed.initialize()``); a single process may also call
``torch.distributed.init_process_group`` itself with an address, a world
size and a rank. A placed tensor is a ``DTensor``: it carries the mesh
and its placement, so ``safe_opt_core.safeopt_step`` keeps its signature
and hands a ``DTensor`` grid to ``sharded_step.py``. Every process holds
the same global values (the grid, the states) and keeps its own rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["make_mesh", "make_hier_mesh", "shard_grid", "shard_state",
           "replicate", "GRID_AXIS", "MODEL_AXIS", "DCN_AXIS"]

GRID_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


def _world(n_devices: Optional[int]) -> int:
    """The mesh's rank count: the process group's world size, which
    ``n_devices``, if given, must equal (every rank is one card)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: run "
                           "under torchrun or call torch.distributed."
                           "init_process_group first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices} differs from the process "
                         f"group's world size {n}")
    return n


def _init(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(torch.distributed.get_rank()
                              % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = "cuda"):
    """A (data, model) mesh over every rank of the process group.

    ``model_parallel`` ranks split the GP-factor contraction; the rest
    shard the candidate grid (default: the grid only). ``device_type``
    is ``'cuda'`` (NCCL, one card per rank) unless the caller passes
    ``'cpu'`` (gloo), as the tests do. ``ValueError`` when the world size
    does not divide by ``model_parallel`` (or differs from
    ``n_devices``)."""
    shape = mesh_shape(_world(n_devices), model_parallel)
    return _init(device_type, shape, (GRID_AXIS, MODEL_AXIS))


def mesh_shape(n_devices: int, model_parallel: int = 1,
               n_hosts: Optional[int] = None) -> Tuple[int, ...]:
    """The shape ``make_mesh`` (``n_hosts`` None) or ``make_hier_mesh``
    gives ``n_devices`` ranks, with their ``ValueError``s: the check
    without a process group."""
    if n_hosts is None:
        if model_parallel < 1 or n_devices % model_parallel != 0:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"model_parallel={model_parallel}")
        return n_devices // model_parallel, model_parallel
    if n_hosts < 1 or n_devices % n_hosts != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by n_hosts={n_hosts}")
    per_host = n_devices // n_hosts
    if model_parallel < 1 or per_host % model_parallel != 0:
        raise ValueError(f"{per_host} devices/host not divisible by "
                         f"model_parallel={model_parallel}")
    return n_hosts, per_host // model_parallel, model_parallel


def make_hier_mesh(n_hosts: int, model_parallel: int = 1,
                   n_devices: Optional[int] = None,
                   device_type: str = "cuda"):
    """A (dcn, data, model) mesh for a run over ``n_hosts`` hosts.

    Ranks are numbered host-major (``torchrun``'s order), so ``dcn``
    varies slowest and strides across hosts, and ``model`` fastest, which
    keeps the factor's ``all_reduce`` on one host's adjacent cards. The
    grid shards over ``(dcn, data)`` jointly (``shard_grid``): its only
    traffic across hosts is the step's scalars and the walk's chunks.
    Campaign fleets shard over ``dcn``
    (``shard_campaigns(..., axis=DCN_AXIS)``), with no traffic inside
    the loop. The JAX package's ``ValueError``s (``sharding.py:66-99``)."""
    shape = mesh_shape(_world(n_devices), model_parallel, n_hosts)
    return _init(device_type, shape, (DCN_AXIS, GRID_AXIS, MODEL_AXIS))


def grid_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the grid rows shard over, slowest first."""
    if DCN_AXIS in mesh.mesh_dim_names:
        return DCN_AXIS, GRID_AXIS
    return (GRID_AXIS,)


def _placements(mesh, sharded_axes):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name in sharded_axes else Replicate()
            for name in mesh.mesh_dim_names]


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shard_index(mesh, axes) -> Tuple[int, int]:
    """``(index, count)`` of this rank's block along ``axes`` jointly
    (the first axis slowest)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for name in axes:
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index, count = index * size + coord[name], count * size
    return index, count


def _place(t: torch.Tensor, mesh, axes):
    """``t`` (the same global tensor on every rank) as a ``DTensor``
    whose dim 0 is split in equal blocks over ``axes`` jointly and
    replicated over the other axes; dim 0 must divide."""
    from torch.distributed.tensor import DTensor

    t = torch.as_tensor(t).to(_device(mesh))
    local = t
    if axes:
        index, count = _shard_index(mesh, axes)
        if t.shape[0] % count:
            raise ValueError(f"{t.shape[0]} rows do not split evenly over "
                             f"{count} shards of {axes}")
        rows = t.shape[0] // count
        local = t[index * rows:(index + 1) * rows]
    return DTensor.from_local(local.contiguous(), mesh,
                              _placements(mesh, axes), run_check=False)


def shard_grid(grid, mesh):
    """``(grid, pad)``: the candidate grid row-sharded over the data axis
    (``(dcn, data)`` jointly on a ``make_hier_mesh``), replicated over
    ``model``, as a ``DTensor``.

    The rows are padded to a multiple of the grid shards so that every
    shard is equal; a padding row repeats the last row (JAX
    ``sharding.py:109-129``). Pass ``num_valid`` = the unpadded row count
    to the step: padding rows are then neither safe nor unsafe, never
    candidates and never chosen."""
    axes = grid_axes(mesh)
    grid, pad = pad_rows(grid, _shard_index(mesh, axes)[1])
    return _place(grid, mesh, axes), pad


def pad_rows(grid, n_shards: int):
    """``(grid, pad)``: ``grid`` (a tensor or array) as a tensor with its
    last row repeated ``pad`` times, the fewest that make the row count
    a multiple of ``n_shards``."""
    grid = torch.as_tensor(np.asarray(grid) if not isinstance(
        grid, torch.Tensor) else grid)
    pad = (-grid.shape[0]) % n_shards
    if pad:
        grid = torch.cat([grid, grid[-1:].expand(pad, -1)])
    return grid, pad


def shard_state(state, mesh):
    """A ``GPState`` with the rows of X, Y, L, Linv and w split over the
    model axis and count and noise_var replicated (JAX
    ``sharding.py:142-160``). The capacity must divide by the axis
    size."""
    from ..gp.regression import GPState

    model = (MODEL_AXIS,)
    return GPState(X=_place(state.X, mesh, model),
                   Y=_place(state.Y, mesh, model),
                   count=_place(state.count, mesh, ()),
                   L=_place(state.L, mesh, model),
                   Linv=_place(state.Linv, mesh, model),
                   w=_place(state.w, mesh, model),
                   noise_var=_place(state.noise_var, mesh, ()))


def map_tensors(tree, fn):
    """``fn`` over the tensor leaves of ``tree`` (tuples, lists, named
    tuples and dicts of them); any other leaf is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def replicate(tree, mesh):
    """Every tensor leaf of ``tree`` replicated over the mesh as a
    ``DTensor``; any other leaf (a kernel, a float) is returned as it is:
    kernels hold their hyperparameters on every rank already."""
    return map_tensors(tree, lambda t: _place(t, mesh, ()))

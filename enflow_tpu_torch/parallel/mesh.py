"""Device meshes, the port of ``enflow_tpu/parallel/mesh.py``.

The reference scaled by ``DistributedDataParallel`` over an NCCL process
group set up from SLURM's environment (reference ``enflow/main.py:42-60``);
the JAX package by a ``jax.sharding.Mesh``. The port's mesh names its axes
(``("data",)`` or ``("data", "atom")``) and holds one collective axis
object each (``collectives.py``), in one of two forms:

- the process-group form: one rank a device, set up by
  :func:`maybe_initialize_distributed` (NCCL on cards, gloo on the CPU);
  each mesh axis is a family of ``dist.new_group`` groups, the ranks laid
  out row-major over the mesh shape as JAX lays out its device list.
- the in-process form: ``virtual_devices`` devices in one process, the
  counterpart of XLA's forced host device count. The ``atom`` axis is a
  :class:`~.collectives.VirtualAxis`; every other axis holds the whole
  batch (:class:`~.collectives.WholeAxis`). NCCL refuses two ranks on one
  card, so on a one-card machine this is the form that runs the
  atom-sharded configurations.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os

import numpy as np
import torch

from .collectives import GroupAxis, VirtualAxis, WholeAxis


def _env_int(*names, default=None):
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def maybe_initialize_distributed(device=None) -> bool:
    """Join the process group that the environment describes; a no-op
    (False) for one process. Reads the JAX package's variables
    (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES`` /
    ``SLURM_NTASKS``, ``PROCESS_ID`` / ``SLURM_PROCID``) and torchrun's
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; they win
    when set, as torchrun inside a SLURM job sets them). A CUDA
    ``device`` selects NCCL and the card ``LOCAL_RANK`` / ``SLURM_LOCALID``
    (else the rank modulo the card count); any other device gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if os.environ.get("WORLD_SIZE") and os.environ.get("RANK"):  # torchrun
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    else:
        world = _env_int("SLURM_NTASKS", "NUM_PROCESSES", default=1)
        rank = _env_int("SLURM_PROCID", "PROCESS_ID", default=0)
    if world <= 1:
        return False
    if os.environ.get("COORDINATOR_ADDRESS"):
        init = f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init = "env://"
    else:
        raise ValueError(
            f"{world} processes but no rendezvous address: set "
            "COORDINATOR_ADDRESS=host:port (or MASTER_ADDR and MASTER_PORT)")
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID",
                         default=rank % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world)
    return True


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes: ``shape[name]`` is the axis's device count (as JAX's
    ``mesh.shape``), ``axes[name]`` its collective axis object."""

    shape: dict
    axes: dict

    def __getitem__(self, name):
        return self.axes[name]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def get_mesh(axes=("data",), shape=None, virtual_devices: int = 1) -> Mesh:
    """A mesh over every rank of the process group, or, in one process,
    over ``virtual_devices`` virtual devices. ``shape`` partitions the
    devices over ``axes`` (default: all on the first axis)."""
    n = process_count()
    if n == 1:
        n = int(virtual_devices)
    elif virtual_devices != 1:
        raise ValueError("virtual devices are the one-process form; with "
                         f"{n} processes leave virtual_devices at 1")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes} does not "
                         f"cover {n} devices")
    if process_count() == 1:
        objs = {a: (VirtualAxis(s) if a == "atom" and s > 1 else WholeAxis())
                for a, s in zip(axes, shape)}
        return Mesh(dict(zip(axes, shape)), objs)
    import torch.distributed as dist
    grid = np.arange(n).reshape(shape)
    me = process_index()
    objs = {}
    for d, a in enumerate(axes):
        if shape[d] == 1:
            objs[a] = WholeAxis()
            continue
        # every rank creates every group, in the same order
        others = [range(s) for i, s in enumerate(shape) if i != d]
        for idx in itertools.product(*others):
            sel = list(idx)
            sel.insert(d, slice(None))
            ranks = [int(r) for r in grid[tuple(sel)]]
            group = dist.new_group(ranks)
            if me in ranks:
                objs[a] = GroupAxis(group, ranks)
    return Mesh(dict(zip(axes, shape)), objs)


def shard_batch(batch, mesh: Mesh, axis="data"):
    """This process's rows of a batched tensor (or a ``System`` or dict of
    them): rows ``r::R`` for data index ``r`` of ``R`` (the loader's
    ``shard`` rule) in the process-group form, the whole batch in one
    process."""
    ax = mesh[axis]
    if isinstance(ax, WholeAxis):
        return batch
    return _map(lambda a: a[ax.index::ax.size], batch)


def split_rows(fn, mesh: Mesh, axis="data"):
    """``fn`` over whole particle batches (a tensor or dict ``[P, ...]`` to
    ``[P]`` or such a dict), evaluated on this rank's block of rows of
    ``mesh[axis]`` and gathered: the sampler's state stays whole on every
    rank, drawn from the same generators, while the densities' flow work
    divides over the ranks (the process-group form's chain axis). Autograd
    runs through (the gather takes this rank's cotangent rows, the split
    gathers the gradients). In one process, or for a batch the ranks do not
    divide, ``fn`` itself."""
    ax = mesh[axis]
    if isinstance(ax, WholeAxis):
        return fn

    def rows(x):
        lead = next(iter(x.values())) if isinstance(x, dict) else x
        if lead.shape[0] % ax.size:
            return fn(x)
        out = fn(_map(lambda a: ax.split(a, dim=0), x))
        return _map(lambda a: ax.gather(a, dim=0), out)

    return rows


def replicate(tree, mesh: Mesh):
    """Make every rank hold rank 0's copy of ``tree`` (parameters and
    optimizer state; a broadcast in place); a no-op in one process."""
    if process_count() > 1:
        import torch.distributed as dist
        with torch.no_grad():
            for t in _leaves(tree):
                dist.broadcast(t, src=0)
    return tree


def sum_grads(leaves, axis=None):
    """Sum the parameters' gradients over every rank (each holds its
    partial: its own molecules, its own atoms), or over the ranks of the
    collective ``axis`` alone; a no-op in one process. The sum, not DDP's
    mean: every rank back-propagates the same global loss."""
    if process_count() == 1 or isinstance(axis, WholeAxis):
        return
    import torch.distributed as dist
    group = None if axis is None else axis.group
    for p in leaves:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)

"""Atom-sharded flow, the port of ``enflow_tpu/flow/sharded.py``.

Each molecule's atoms are split over a mesh's ``atom`` axis
(``parallel/mesh.py``): every EGCL becomes the ring EGCL
(``parallel/ring.py``), the NLL's pair term the ring term
(``parallel/pairwise.py``) and the per-molecule sums ``psum``s. Composes
with a ``data`` axis: its shards hold other molecules, and the NLL's sums
over molecules are ``psum``med over it. The wrappers take and return whole
tensors (this process's molecules, every atom) and split and gather the
atoms inside, as a ``shard_map``'s specs do; parameters enter whole.

Only the exact, blockwise neighbour formats shard: ``nbr_mode`` 'dense'
(min-image and the cutoff) and 'all_pairs'. The top-k capacity is a global
op over the atoms.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.system import System
from ..nn import argmax as argmax_deq
from ..nn import floor as floor_deq
from .integrators import FlowConfig, forward, forward_core, reverse_core


def shard_system(sys: System, mesh, axis="atom") -> System:
    """This shard's block of ``sys``'s atoms: the atom fields split over
    ``mesh[axis]``, ``box`` and ``r_cut`` held whole by every shard."""
    ax = mesh[axis]
    return System(h=ax.split(sys.h), g=ax.split(sys.g), pos=ax.split(sys.pos),
                  vel=ax.split(sys.vel), mask=ax.split(sys.mask),
                  box=ax.broadcast(sys.box), r_cut=ax.broadcast(sys.r_cut))


def gather_system(blk: System, mesh, axis="atom") -> System:
    """The inverse of :func:`shard_system`."""
    ax = mesh[axis]
    return System(h=ax.gather(blk.h), g=ax.gather(blk.g),
                  pos=ax.gather(blk.pos), vel=ax.gather(blk.vel),
                  mask=ax.gather(blk.mask), box=ax.collapse(blk.box),
                  r_cut=ax.collapse(blk.r_cut))


def _sharded_cfg(cfg: FlowConfig, axis) -> FlowConfig:
    """``cfg`` on the atom axis object ``axis``. The refusals are the JAX
    package's; ``remat`` goes off as there (the port's plain path ignores
    it)."""
    if cfg.nbr_mode not in ("dense", "all_pairs"):
        raise ValueError(
            f"atom-sharded flow supports nbr_mode 'dense'/'all_pairs', got "
            f"{cfg.nbr_mode!r} (top-k capacity is a global op)")
    if cfg.nbr_capacity is not None:
        raise ValueError("nbr_capacity is not supported in atom-sharded mode")
    return dataclasses.replace(cfg, axis_name=axis, remat=False)


def draw_noise(cfg: FlowConfig, gen, h, n_rows=None):
    """The dequantizer's noise for whole molecules like ``h`` (``n_rows``
    of them, default ``h``'s): the draw that :func:`~.integrators.forward`
    makes from ``gen`` (standard normal for ArgMax, ``U[0, 1)`` for Floor),
    so a sharded forward that splits it sees what a dense one draws."""
    draw = torch.randn if cfg.dequantizer == "argmax" else torch.rand
    shape = (h.shape[0] if n_rows is None else n_rows,) + tuple(h.shape[1:])
    return draw(shape, generator=gen, dtype=h.dtype, device=h.device)


def sharded_forward(mesh, params, cfg: FlowConfig, sys: System, gen=None,
                    eps=None, axis="atom"):
    """``flow.forward`` with atoms sharded: ``(out_system, ldj [B])``. The
    noise is ``eps`` for the whole molecules when given, else drawn from
    ``gen`` (:func:`draw_noise`); each shard takes its block."""
    ax = mesh[axis]
    if eps is None:
        eps = draw_noise(cfg, gen, sys.h)
    out, ldj = forward(params, _sharded_cfg(cfg, ax),
                       shard_system(sys, mesh, axis), eps=ax.split(eps))
    return gather_system(out, mesh, axis), ax.collapse(ldj)


def sharded_forward_core(mesh, params, cfg: FlowConfig, sys: System,
                         axis="atom"):
    ax = mesh[axis]
    out, ldj = forward_core(params, _sharded_cfg(cfg, ax),
                            shard_system(sys, mesh, axis))
    return gather_system(out, mesh, axis), ax.collapse(ldj)


def sharded_reverse_core(mesh, params, cfg: FlowConfig, sys: System,
                         axis="atom"):
    ax = mesh[axis]
    out, ldj = reverse_core(params, _sharded_cfg(cfg, ax),
                            shard_system(sys, mesh, axis))
    return gather_system(out, mesh, axis), ax.collapse(ldj)


def sharded_reverse(mesh, params, cfg: FlowConfig, sys: System, axis="atom"):
    """``flow.reverse`` (inverse integrate and re-quantize), atoms
    sharded."""
    out, _ = sharded_reverse_core(mesh, params, cfg, sys, axis)
    deq = argmax_deq if cfg.dequantizer == "argmax" else floor_deq
    return out.replace(h=deq.reverse(out.h, out.mask))


def make_sharded_nll(mesh, cfg: FlowConfig, kBT, softening,
                     num_log_gaussian_calls=3, partition_func=10.0,
                     axis="atom", data_axis=None):
    """``loss(params, sys, gen=None, eps=None) -> scalar``: the alchemical
    NLL of the sharded forward pass, equal to ``alchemical_nll(forward(...))``
    on one device over the molecules of every ``data_axis`` shard, with
    autograd through the ring. ``sys`` holds this process's molecules
    whole; the noise as :func:`sharded_forward`'s. In the process-group form
    each rank's parameter gradient is its partial: sum them over the mesh
    (``parallel.mesh.sum_grads``)."""
    from .loss import alchemical_nll

    ax = mesh[axis]
    dx = mesh[data_axis] if data_axis else None
    cfg_s = _sharded_cfg(cfg, ax)

    def loss(params, sys, gen=None, eps=None):
        if eps is None:
            eps = draw_noise(cfg, gen, sys.h)
        out, ldj = forward(params, cfg_s, shard_system(sys, mesh, axis),
                           eps=ax.split(eps))
        return alchemical_nll(out, ldj, kBT, softening, partition_func,
                              num_log_gaussian_calls, axis_name=ax,
                              data_axis=dx)

    return loss

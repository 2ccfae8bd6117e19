"""Atom-sharded pair energies: the ring pattern, the port of
``enflow_tpu/parallel/pairwise.py``.

Each shard holds a block of every molecule's atoms; position blocks go
around the ring (``axis.ring_shift``) while each shard accumulates its
atoms' pair terms with the visiting block. Ordered pairs accumulate over
the ``axis.size`` rotations and are halved, so the result is the dense
``i < j`` sum of any symmetric term; the self-pair diagonal exists only at
rotation 0. Plain PyTorch on every device, as the JAX package computes it
outside any kernel; autograd runs through the ring (``collectives.py``).

Bodies take per-shard blocks ``pos_blk [B, n_blk, 3]``, ``mask_blk [B,
n_blk]`` and an axis object, and return replicated per-molecule ``[B]``.
"""

from __future__ import annotations

import torch

from ..utils.helpers import min_image


def _ring(pos_blk, mask_blk, axis, block_fn):
    """``0.5 * psum`` over the shards of ``sum_s block_fn(s, pos_j,
    mask_j)``, the visiting block ``(pos_j, mask_j)`` the one that started
    on shard ``my + s``."""
    pos_j, mask_j = pos_blk, mask_blk
    acc = None
    for s in range(axis.size):
        e = block_fn(s, pos_j, mask_j)
        acc = e if acc is None else acc + e
        if s + 1 < axis.size:
            pos_j = axis.ring_shift(pos_j)
            mask_j = axis.ring_shift(mask_j)
    return 0.5 * axis.psum(acc)


def _off_diagonal(s, valid):
    """``valid`` without the self pairs, which rotation 0 alone holds."""
    if s:
        return valid
    n = valid.shape[-1]
    return valid & ~torch.eye(n, dtype=torch.bool, device=valid.device)


def ring_softened_lj_energy(pos_blk, mask_blk, box, softening, cutoff,
                            axis):
    """The MD potential ``4((s + r)^-12 - (s + r)^-6)`` over min-image
    pairs within ``cutoff`` (``sim.potentials.softened_lj_energy``), atoms
    sharded: ``box [B, 3]`` per molecule; returns ``[B]``."""
    box_b = box[:, None, None, :]

    def block(s, pos_j, mask_j):
        diff = min_image(pos_blk[:, :, None, :] - pos_j[:, None, :, :], box_b)
        d2 = (diff * diff).sum(-1)
        valid = (mask_blk[:, :, None] & mask_j[:, None, :]
                 & (d2 < cutoff * cutoff))
        valid = _off_diagonal(s, valid)
        r = torch.sqrt(torch.where(valid, d2, torch.ones_like(d2)))
        inv6 = (1.0 / (softening + r)) ** 6
        e = 4.0 * (inv6 * inv6 - inv6)
        return torch.where(valid, e, torch.zeros_like(e)).sum(dim=(1, 2))

    return _ring(pos_blk, mask_blk, axis, block)


def ring_alchemical_lj(pos_blk, mask_blk, softening, axis):
    """The NLL's pair term (``flow/loss.py:lj_potential``: softening on
    ``r^2``, no periodic wrap, no cutoff, pairs at distance 0 left out),
    atoms sharded; returns ``[B]``. The ``d2 != 0`` test drops the self
    pairs at rotation 0, as the JAX package's does."""

    def block(s, pos_j, mask_j):
        diff = pos_blk[:, :, None, :] - pos_j[:, None, :, :]
        d2 = (diff * diff).sum(-1)
        valid = (mask_blk[:, :, None] & mask_j[:, None, :]) & (d2 != 0.0)
        r_sq = torch.where(valid, d2 + softening, torch.ones_like(d2))
        r_6 = r_sq * r_sq * r_sq
        e = 4.0 * (1.0 / (r_6 * r_6) - 1.0 / r_6)
        return torch.where(valid, e, torch.zeros_like(e)).sum(dim=(1, 2))

    return _ring(pos_blk, mask_blk, axis, block)


def ring_pair_terms(pos_blk, mask_blk, axis, term_fn, box=None):
    """The generic unordered-pair reduction: ``term_fn(d2 [B, bi, bj],
    valid [B, bi, bj]) -> [B]`` sums one block pair's term over its valid
    entries (``valid`` already without padded atoms and self pairs). With
    ``box`` (a scalar, or anything broadcastable to ``[B, bi, bj, 3]``) the
    displacements are min-image wrapped first. Returns ``[B]``."""

    def block(s, pos_j, mask_j):
        diff = pos_blk[:, :, None, :] - pos_j[:, None, :, :]
        if box is not None:
            diff = min_image(diff, torch.as_tensor(box, dtype=diff.dtype,
                                                   device=diff.device))
        d2 = (diff * diff).sum(-1)
        valid = _off_diagonal(s, mask_blk[:, :, None] & mask_j[:, None, :])
        return term_fn(d2, valid)

    return _ring(pos_blk, mask_blk, axis, block)


def make_sharded_lj_energy(mesh, axis: str = "atom"):
    """``f(pos [N, 3], mask [N], box [3], softening, cutoff) -> scalar``
    with ``N`` divided over ``mesh[axis]``."""
    ax = mesh[axis]

    def energy(pos, mask, box, softening, cutoff):
        e = ring_softened_lj_energy(
            ax.split(pos[None]), ax.split(mask[None]),
            ax.broadcast(torch.as_tensor(box, dtype=pos.dtype,
                                         device=pos.device).reshape(1, 3)),
            softening, cutoff, ax)
        return ax.collapse(e)[0]

    return energy


"""Neighbor structures, the port of ``enflow_tpu/data/neighbors.py``.

Every mode of the JAX package (the atom-sharded ring builds its edges
blockwise, ``parallel/ring.py``):

- ``all_pairs`` (the cluster workloads): every real atom neighbors every
  other. It feeds the plain all-pairs EGCL; the all-pairs CUDA kernel
  builds its pairs from raw positions itself.
- ``dense``/``topk``: min-image neighbors within the cutoff. With no
  capacity, or one ``>= N``, the dense format ``K = N`` (an ``[B, N, N]``
  adjacency); with a capacity ``K < N`` the top-K nearest by ``torch.topk``
  over ``-d2``, and ``excess`` counts the in-cutoff slots it dropped
  (``generate.yaml``'s 2,944 atoms).
- ``cell``: the same top-K over the candidates of the 27 neighbouring
  cells (``data/celllist.py``).
- ``images`` (``train.yaml``): one (neighbor, periodic image) slot per
  in-cutoff image among the 27 around each atom, a top-K over the
  ``[N, 27N]`` candidate scores. Each slot carries its own image
  displacement.

Where scores tie (including the ``-inf`` invalid slots) ``torch.topk`` may
order slots otherwise than ``lax.top_k``: the neighbor *set* and its mask
are the JAX package's, the slot order may not be. The EGCL sums over
slots, so its result does not depend on that order.

Builds are batched over molecules where the JAX package vmaps one
molecule's build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.helpers import min_image

# the 27 periodic-image offsets in {-1, 0, 1}^3 (own cell included)
IMAGE_OFFSETS = np.array(
    [[a, b, c] for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)],
    dtype=np.int32)


class Neighbors(NamedTuple):
    """``idx [B, N, K]`` neighbor indices and ``mask [B, N, K]`` validity."""

    idx: torch.Tensor
    mask: torch.Tensor


def all_pairs(mask: torch.Tensor) -> Neighbors:
    """Static all-pairs adjacency: every real atom neighbors every other."""
    B, N = mask.shape
    idx = torch.arange(N, dtype=torch.int32, device=mask.device)
    idx = idx[None, None, :].expand(B, N, N)
    eye = torch.eye(N, dtype=torch.bool, device=mask.device)
    m = mask[:, :, None] & mask[:, None, :] & ~eye[None]
    return Neighbors(idx=idx, mask=m)


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _pair_dist_sq(pos, box):
    """``[B, N, N]`` min-image squared distances and ``[B, N, N, 3]``
    displacements ``pos_i - pos_j``."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    diff = min_image(diff, box[:, None, None, :])
    return (diff * diff).sum(-1), diff


def _valid_pairs(pos, box, mask, r_cut):
    """``[B, N, N]`` bool: j is a neighbor of i (both real, i != j, within
    the cutoff), and the squared distances."""
    n = pos.shape[1]
    d2, _ = _pair_dist_sq(pos, box)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    valid = (mask[:, :, None] & mask[:, None, :] & ~eye
             & (d2 < (r_cut * r_cut)[:, None, None]))
    return valid, d2


def _neighbors_dense(pos, box, mask, r_cut):
    """The dense format: ``idx [B, N, N]`` every atom, ``mask`` the valid
    pairs."""
    B, n, _ = pos.shape
    valid, _ = _valid_pairs(pos, box, mask, r_cut)
    idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    return idx[None, None, :].expand(B, n, n), valid


def _neighbors_topk(pos, box, mask, r_cut, capacity: int):
    """The top-K format: the ``capacity`` nearest valid neighbors of each
    atom, and ``excess``, the in-cutoff slots that did not fit (an int64
    device scalar summed over the batch)."""
    valid, d2 = _valid_pairs(pos, box, mask, r_cut)
    score = torch.where(valid, -d2, torch.full((), -torch.inf,
                                               dtype=d2.dtype,
                                               device=d2.device))
    top, idx = torch.topk(score, capacity, dim=-1)
    excess = torch.clamp(valid.sum(dim=-1) - capacity, min=0).sum()
    return idx.to(torch.int32), top > -torch.inf, excess


def _neighbors_min_image(pos, box, mask, r_cut, capacity):
    """``(Neighbors, excess)``: dense when ``capacity`` is None or ``>=
    N`` (excess an int32 zero), else top-K with its int32 excess."""
    if capacity is None or capacity >= pos.shape[1]:
        return (Neighbors(*_neighbors_dense(pos, box, mask, r_cut)),
                torch.zeros((), dtype=torch.int32, device=pos.device))
    idx, m, excess = _neighbors_topk(pos, box, mask, r_cut, int(capacity))
    return Neighbors(idx=idx, mask=m), excess.to(torch.int32)


def neighbor_list(pos, box, mask, r_cut, capacity: int | None = None
                  ) -> Neighbors:
    """Static-shape neighbors of a batch ``pos [B,N,3]``, ``box [B,3]``,
    ``mask [B,N]``, ``r_cut [B]``: dense when ``capacity`` is None or
    ``>= N``, else top-K (``neighbors.py:81-104``)."""
    return _neighbors_min_image(pos, box, mask, r_cut, capacity)[0]


def neighbor_overflow(pos, box, mask, r_cut, capacity: int):
    """Diagnostic: True (a device bool) if any atom has more than
    ``capacity`` in-cutoff neighbors."""
    valid, _ = _valid_pairs(pos, box, mask, r_cut)
    return (valid.sum(dim=-1) > capacity).any()


def max_neighbor_count(pos, box, mask, r_cut):
    """The largest per-atom in-cutoff neighbor count in the batch (a device
    scalar)."""
    valid, _ = _valid_pairs(pos, box, mask, r_cut)
    return valid.sum(dim=-1).max()


def coord_diffs(pos, box, nbrs: Neighbors):
    """Min-image displacements ``pos[b,i] - pos[b, idx[b,i,k]]`` for each
    slot, ``[B, N, K, 3]``, zeroed on invalid slots."""
    b = torch.arange(pos.shape[0], device=pos.device)[:, None, None]
    diff = pos[:, :, None, :] - pos[b, nbrs.idx.long()]
    diff = min_image(diff, box[:, None, None, :])
    return torch.where(nbrs.mask[..., None], diff, _zero(diff))


def _image_candidates(pos, box, mask, r_cut):
    """Displacements ``d [B,27,N,N,3]`` to every image of every atom, their
    squares ``d2`` and validity (both real, not the same atom, in cutoff)."""
    B, N, _ = pos.shape
    diff0 = pos[:, :, None, :] - pos[:, None, :, :]               # [B,N,N,3]
    offs = torch.as_tensor(IMAGE_OFFSETS, device=pos.device).to(pos.dtype)
    offs = offs[None] * box[:, None, :]                           # [B,27,3]
    d = diff0[:, None] + offs[:, :, None, None, :]              # [B,27,N,N,3]
    d2 = (d * d).sum(-1)                                          # [B,27,N,N]
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    valid = (mask[:, None, :, None] & mask[:, None, None, :] & ~eye
             & (d2 < (r_cut * r_cut)[:, None, None, None]))
    return d, d2, valid


def image_neighbor_list(pos, box, mask, r_cut, capacity: int):
    """Multi-image neighbors (``nbr_mode: images``): ``(Neighbors, diff
    [B,N,K,3], excess)`` where ``excess`` counts the in-cutoff slots that
    did not fit in ``capacity`` (a device scalar)."""
    B, N, _ = pos.shape
    d, d2, valid = _image_candidates(pos, box, mask, r_cut)
    ninf = torch.full((), -torch.inf, dtype=d2.dtype, device=d2.device)
    score = torch.where(valid, -d2, ninf)
    score = score.permute(0, 2, 1, 3).reshape(B, N, 27 * N)
    top, flat = torch.topk(score, capacity, dim=-1)
    slot_ok = top > -torch.inf
    d_rows = d.permute(0, 2, 1, 3, 4).reshape(B, N, 27 * N, 3)
    diff = torch.gather(d_rows, 2, flat[..., None].expand(B, N, capacity, 3))
    diff = torch.where(slot_ok[..., None], diff,
                       torch.zeros((), dtype=diff.dtype, device=diff.device))
    excess = torch.clamp(valid.sum(dim=(1, 3)) - capacity, min=0).sum()
    return (Neighbors(idx=(flat % N).to(torch.int32), mask=slot_ok), diff,
            excess.to(torch.int32))


def neighbors_with_diffs(pos, box, mask, r_cut=None, capacity=None,
                         mode: str = "all_pairs", cells_per_dim=None,
                         cell_capacity=None, with_overflow: bool = False):
    """Neighbors plus displacements ``pos_i - pos_j`` (min-image, or per
    image in ``images`` mode) zeroed on invalid slots
    (``neighbors.py:239-304``). ``mode`` is ``all_pairs`` (the port's
    default; the JAX function's is ``dense``), ``dense``/``topk`` (as
    :func:`neighbor_list`), ``cell`` (needs ``capacity``,
    ``cells_per_dim`` and ``cell_capacity``) or ``images`` (needs
    ``capacity``). ``with_overflow`` adds an int32 device scalar counting
    the slots the build dropped: 0 for the exact formats, the top-K excess
    otherwise, and in ``cell`` mode also the atoms dropped from over-full
    cells."""
    zero = torch.zeros((), dtype=torch.int32, device=pos.device)
    if mode == "images":
        if capacity is None:
            raise ValueError(
                "nbr_mode 'images' needs nbr_capacity ((neighbor, image) "
                "slots per atom; 'auto' works in the driver)")
        nbrs, diff, excess = image_neighbor_list(pos, box, mask, r_cut,
                                                 int(capacity))
        return (nbrs, diff, excess) if with_overflow else (nbrs, diff)
    if mode == "all_pairs":
        nbrs = all_pairs(mask)
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        diff = min_image(diff, box[:, None, None, :])
        diff = torch.where(nbrs.mask[..., None], diff, _zero(diff))
        return (nbrs, diff, zero) if with_overflow else (nbrs, diff)
    ovf = zero
    if mode == "cell":
        from .celllist import cell_neighbor_list
        if capacity is None or cells_per_dim is None or cell_capacity is None:
            raise ValueError(
                "nbr_mode 'cell' needs nbr_capacity (per-atom neighbor "
                "slots; 'auto' works), cells_per_dim and cell_capacity "
                "(ints or 'auto' in the dynamics section)")
        nbrs, ovf = cell_neighbor_list(pos, box, mask, r_cut, int(capacity),
                                       int(cells_per_dim), int(cell_capacity),
                                       with_overflow=True)
    elif mode in ("dense", "topk"):
        nbrs, ovf = _neighbors_min_image(pos, box, mask, r_cut, capacity)
    else:
        raise ValueError(f"unknown nbr_mode {mode!r}")
    out = nbrs, coord_diffs(pos, box, nbrs)
    return out + (ovf,) if with_overflow else out


def image_edge_max(pos, box, r_cut) -> int:
    """Host-side numpy count of the largest per-atom (neighbor, image) slot
    number of one frame ``pos [N,3]`` (``driver.py:63-80``): one slot per
    in-cutoff periodic image, self-image pairs excluded."""
    n = pos.shape[0]
    r2 = r_cut * r_cut
    offs = IMAGE_OFFSETS.astype(np.float64) * box
    counts = np.zeros(n, np.int64)
    for lo in range(0, n, 1024):
        diff0 = pos[lo:lo + 1024, None, :] - pos[None, :, :]
        same = np.zeros(diff0.shape[:2], bool)
        same[np.arange(diff0.shape[0]),
             np.arange(lo, lo + diff0.shape[0])] = True
        for off in offs:
            d2 = ((diff0 + off) ** 2).sum(-1)
            counts[lo:lo + 1024] += ((d2 < r2) & ~same).sum(axis=1)
    return int(counts.max())

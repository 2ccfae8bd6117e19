"""Neighbor structures, the port of ``enflow_tpu/data/neighbors.py``.

Two modes are ported:

- ``all_pairs`` (the cluster workloads): every real atom neighbors every
  other. It feeds the plain all-pairs EGCL; the all-pairs CUDA kernel
  builds its pairs from raw positions itself.
- ``images`` (``train.yaml``): one (neighbor, periodic image) slot per
  in-cutoff image among the 27 around each atom, a top-K over the
  ``[N, 27N]`` candidate scores, batched over molecules. Each slot carries
  its own image displacement. Where scores tie (including the ``-inf``
  invalid slots) ``torch.topk`` may order slots otherwise than
  ``lax.top_k``; the EGCL sums over slots, so the result does not depend
  on that order.

The other modes (dense, topk, cell) are ROADMAP A4.
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
                         mode: str = "all_pairs",
                         with_overflow: bool = False):
    """Neighbors plus displacements ``pos_i - pos_j`` (min-image, or per
    image in ``images`` mode) zeroed on invalid slots
    (``neighbors.py:239-304``). ``with_overflow`` adds the count of slots
    the build dropped (0 for ``all_pairs``)."""
    if mode == "images":
        if capacity is None:
            raise ValueError(
                "nbr_mode 'images' needs nbr_capacity ((neighbor, image) "
                "slots per atom; 'auto' works in the driver)")
        nbrs, diff, excess = image_neighbor_list(pos, box, mask, r_cut,
                                                 int(capacity))
        return (nbrs, diff, excess) if with_overflow else (nbrs, diff)
    if mode != "all_pairs":
        raise NotImplementedError(
            f"nbr_mode={mode!r} is not ported yet (ROADMAP A4); "
            "the port supports nbr_mode 'all_pairs' and 'images'")
    nbrs = all_pairs(mask)
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    diff = min_image(diff, box[:, None, None, :])
    diff = torch.where(nbrs.mask[..., None], diff,
                       torch.zeros((), dtype=diff.dtype, device=diff.device))
    if with_overflow:
        return nbrs, diff, torch.zeros((), dtype=torch.int32,
                                       device=pos.device)
    return nbrs, diff


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

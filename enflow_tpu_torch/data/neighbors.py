"""Neighbor structures, the port of ``enflow_tpu/data/neighbors.py``.

Only the ``all_pairs`` mode is ported (the cluster workloads; the other
modes are ROADMAP queue A items 2 and 5). It feeds the plain EGCL path;
the CUDA kernel builds its pairs from raw positions itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.helpers import min_image


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


def neighbors_with_diffs(pos, box, mask, r_cut=None, capacity=None,
                         mode: str = "all_pairs"):
    """Neighbors plus min-image displacements ``pos_i - pos_j`` zeroed on
    invalid slots (``neighbors.py:275-280``)."""
    if mode != "all_pairs":
        raise NotImplementedError(
            f"nbr_mode={mode!r} is not ported yet (ROADMAP queue A items 2 "
            "and 5); the port supports nbr_mode 'all_pairs'")
    nbrs = all_pairs(mask)
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    diff = min_image(diff, box[:, None, None, :])
    return nbrs, torch.where(nbrs.mask[..., None], diff,
                             torch.zeros((), dtype=diff.dtype,
                                         device=diff.device))

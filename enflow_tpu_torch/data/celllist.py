"""Cell-list neighbor construction, the port of
``enflow_tpu/data/celllist.py``.

Atoms are binned into ``m^3`` cells of side ``box / m >= r_cut``, so each
atom tests only the candidates of its 27 neighbouring cells: ``O(N 27 C)``
distance tests instead of ``O(N^2)``, with C the per-cell capacity. The
output is the fixed-capacity ``Neighbors(idx, mask)`` of the top-K format,
selected by ``torch.topk`` over the ``27 C`` candidates: the same neighbor
set as the dense builder whenever nothing overflows.

Static parameters (the YAML ``dynamics`` section):

- ``cells_per_dim`` m: correctness needs ``box / m >= r_cut``
  (:func:`suggest_cells_per_dim`).
- ``cell_capacity`` C: the most atoms a cell holds. Atoms past it are
  dropped from the candidate table; :func:`cell_overflow` and the
  ``with_overflow`` counter report them.

Inside a cell the atoms are ranked by a stable sort of their cell index,
as ``jnp.argsort`` ranks them, so an over-full cell drops the same atoms
as the JAX package. Builds are batched over molecules where the JAX
package vmaps one molecule's build.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.helpers import min_image
from .neighbors import Neighbors


def suggest_cells_per_dim(box, r_cut, max_cells: int = 32) -> int:
    """Largest m with ``box / m >= r_cut`` (host-side; box in reduced
    units), at least 1 and at most ``max_cells``."""
    m = int(np.floor(np.min(np.asarray(box)) / float(r_cut)))
    return max(1, min(m, max_cells))


# the 27 neighbouring-cell offsets, a static [27, 3] table
_OFFSETS = np.array([[i, j, k]
                     for i in (-1, 0, 1)
                     for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=np.int64)


def _cell_ids(pos, box, m: int):
    """``[B, N]`` flat cell index per atom and ``[B, N, 3]`` its cell
    coordinates (positions wrapped into ``[0, box)``)."""
    frac = pos / box[:, None, :] + 0.5        # [-box/2, box/2) -> [0, 1)
    frac = frac - torch.floor(frac)           # robust wrap for outliers
    ijk = torch.clamp((frac * m).to(torch.int64), 0, m - 1)
    return (ijk[..., 0] * m + ijk[..., 1]) * m + ijk[..., 2], ijk


def _build_cell_table(cell_id, mask, m: int, cap: int):
    """``[B, m^3, cap]`` atom indices per cell (``N`` marks an empty slot),
    each cell's atoms in the order of a stable sort, the ones past ``cap``
    dropped; padded atoms go to a virtual overflow row. Returns the table
    and the number of real atoms dropped (a device scalar)."""
    B, n = cell_id.shape
    n_cells = m * m * m
    dev = cell_id.device
    cid = torch.where(mask, cell_id, torch.full((), n_cells, device=dev,
                                                 dtype=cell_id.dtype))
    sorted_cid, order = torch.sort(cid, dim=-1, stable=True)
    cells = torch.arange(n_cells + 1, device=dev, dtype=cid.dtype)
    first = torch.searchsorted(sorted_cid,
                               cells[None].expand(B, -1).contiguous())
    rank = (torch.arange(n, device=dev)[None]
            - torch.gather(first, 1, torch.clamp(sorted_cid, 0, n_cells)))
    ok = rank < cap
    table = torch.full((B, n_cells + 1, cap), n, dtype=torch.int64,
                       device=dev)
    b = torch.arange(B, device=dev)[:, None].expand(B, n)
    row = torch.where(ok, sorted_cid, n_cells)
    col = torch.where(ok, rank, cap - 1)
    table[b, row, col] = torch.where(ok, order, n)
    dropped = (~ok & (sorted_cid < n_cells)).sum()
    return table[:, :n_cells], dropped


def cell_neighbor_list(pos, box, mask, r_cut, capacity: int,
                       cells_per_dim: int, cell_capacity: int,
                       with_overflow: bool = False):
    """Batched cell-list neighbor build, the interface of
    ``neighbors.neighbor_list`` with a top-K capacity.

    ``pos/box/mask/r_cut``: ``[B,N,3] / [B,3] / [B,N] / [B]``;
    ``capacity`` K neighbor slots an atom; ``cells_per_dim`` m;
    ``cell_capacity`` C. ``with_overflow`` also returns an int32 device
    scalar: the in-cutoff candidates past the top-K plus the atoms dropped
    from over-full cells."""
    B, n, _ = pos.shape
    m, dev = int(cells_per_dim), pos.device
    cell_id, ijk = _cell_ids(pos, box, m)
    table, dropped = _build_cell_table(cell_id, mask, m, int(cell_capacity))

    # the candidates: the 27 neighbouring cells' tables -> [B, N, 27 C].
    # For m <= 2 the periodic wrap makes several offsets hit the same
    # cell; each distinct cell is kept once, so no edge is duplicated.
    offs = torch.as_tensor(_OFFSETS, device=dev)
    nbr_ijk = (ijk[:, :, None, :] + offs) % m                 # [B, N, 27, 3]
    nbr_cell = ((nbr_ijk[..., 0] * m + nbr_ijk[..., 1]) * m
                + nbr_ijk[..., 2])
    earlier = torch.tril(torch.ones((27, 27), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup_cell = ((nbr_cell[..., :, None] == nbr_cell[..., None, :])
                & earlier).any(-1)                            # [B, N, 27]
    b = torch.arange(B, device=dev)[:, None, None]
    cand = table[b, nbr_cell]                                 # [B, N, 27, C]
    cand_valid = (cand < n) & ~dup_cell[..., None]
    cand = cand.reshape(B, n, -1)
    cand_valid = cand_valid.reshape(B, n, -1)
    cand_safe = torch.where(cand_valid, cand, 0)

    diff = pos[:, :, None, :] - pos[b, cand_safe]             # [B, N, 27C, 3]
    diff = min_image(diff, box[:, None, None, :])
    d2 = (diff * diff).sum(-1)
    valid = (cand_valid
             & mask[:, :, None]
             & mask[b, cand_safe]
             & (cand_safe != torch.arange(n, device=dev)[None, :, None])
             & (d2 < (r_cut * r_cut)[:, None, None]))
    score = torch.where(valid, -d2, torch.full((), -torch.inf,
                                               dtype=d2.dtype, device=dev))
    top, idx_c = torch.topk(score, int(capacity), dim=-1)
    idx = torch.gather(cand_safe, 2, idx_c)
    nbrs = Neighbors(idx=idx.to(torch.int32), mask=top > -torch.inf)
    if with_overflow:
        excess = torch.clamp(valid.sum(dim=-1) - int(capacity), min=0).sum()
        return nbrs, (excess + dropped).to(torch.int32)
    return nbrs


def _occupancy(pos, box, mask, cells_per_dim: int):
    """``[B, m^3]`` real atoms per cell."""
    m = int(cells_per_dim)
    cid, _ = _cell_ids(pos, box, m)
    counts = torch.zeros((pos.shape[0], m ** 3), dtype=torch.int64,
                         device=pos.device)
    return counts.scatter_add_(1, cid, mask.to(torch.int64))


def cell_overflow(pos, box, mask, r_cut, cells_per_dim: int,
                  cell_capacity: int):
    """Diagnostic: True (a device bool) if any cell holds more than
    ``cell_capacity`` real atoms."""
    return (_occupancy(pos, box, mask, cells_per_dim) > cell_capacity).any()


def max_cell_occupancy(pos, box, mask, cells_per_dim: int):
    """The most real atoms any one cell holds in the batch (a device
    scalar)."""
    return _occupancy(pos, box, mask, cells_per_dim).max()

"""Host-side neighbor counting for sizing the fixed-capacity neighbor
lists, the port of ``enflow_tpu/native.py``'s ``neighbor_counts`` and
``suggest_capacity``.

The JAX package runs these through a C++ cell list
(``native/enflow_native.cpp: enflow_cell_list_neighbor_counts``). The port
keeps its own copy in numpy float64 and loads no shared library: the same
cell walk, vectorized over atoms, one pass per neighbouring-cell offset.
It gives the C++ scan's counts exactly, because it repeats its arithmetic:

- at most ``MAX_CELLS`` cells per axis, ``(int)(box / r_cut)`` of them
  and at least one, each of side ``box / cells``;
- an atom's cell from its position wrapped into ``[0, box)`` with
  ``fmod``, clamped to the last cell;
- with one or two cells per axis the offsets that alias the same cell are
  walked once (two cells: -1 and 0; one cell: 0);
- the min-image integer rounds half away from zero (``std::round``, not
  numpy's half-to-even ``np.round``), and ``d2`` sums the axes in order.

A 2,944-atom frame scans in milliseconds. The JAX module's C++ TRR
index and frame reader have no counterpart here: the port reads TRR
frames with ``data/formats.py`` only (the same bytes, in numpy).
"""

from __future__ import annotations

import numpy as np

#: the C++ scan's bound on the cells per axis
MAX_CELLS = 64
#: candidate pairs tested per numpy pass (bounds the scan's memory)
_PAIRS_PER_PASS = 1 << 21


def _round_half_away(x):
    """``std::round``: to the nearest integer, halves away from zero
    (``x - trunc(x)`` is exact in floating point)."""
    r = np.trunc(x)
    return r + np.where(np.abs(x - r) >= 0.5, np.sign(x), 0.0)


def _axis_offsets(nc: int):
    """The cell offsets one axis walks: the C++ scan skips +1 with two
    cells (it aliases -1) and everything but 0 with one."""
    if nc == 1:
        return (0,)
    if nc == 2:
        return (-1, 0)
    return (-1, 0, 1)


def neighbor_counts(pos, box, r_cut):
    """Per-atom within-cutoff neighbor counts under the minimum-image
    convention, by the C++ scan's cell walk. Returns ``(counts [N] int32,
    max_count)``."""
    pos = np.ascontiguousarray(pos, np.float64).reshape(-1, 3)
    box = np.ascontiguousarray(box, np.float64).reshape(3)
    n = pos.shape[0]
    r_cut = float(r_cut)
    if n <= 0 or r_cut <= 0 or (box <= 0).any():
        raise ValueError(f"neighbor_counts needs atoms, r_cut > 0 and a "
                         f"positive box (got {n} atoms, r_cut={r_cut}, "
                         f"box={box})")
    r2 = r_cut * r_cut
    nc = np.clip(np.floor(box / r_cut), 1, MAX_CELLS).astype(np.int64)
    cell = box / nc
    w = np.fmod(pos, box)
    w = np.where(w < 0, w + box, w)
    c = np.minimum((w / cell).astype(np.int64), nc - 1)          # [N, 3]
    cid = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    n_cells = int(nc.prod())
    start = np.searchsorted(sorted_cid, np.arange(n_cells), side="left")
    end = np.searchsorted(sorted_cid, np.arange(n_cells), side="right")

    counts = np.zeros(n, np.int64)
    atoms = np.arange(n)
    for dx in _axis_offsets(int(nc[0])):
        for dy in _axis_offsets(int(nc[1])):
            for dz in _axis_offsets(int(nc[2])):
                o = np.array([dx, dy, dz])
                nb = (c + o + nc) % nc
                ncid = (nb[:, 0] * nc[1] + nb[:, 1]) * nc[2] + nb[:, 2]
                lo, cnt = start[ncid], end[ncid] - start[ncid]
                # rows in passes of at most _PAIRS_PER_PASS candidates
                csum = np.cumsum(cnt)
                cuts = np.searchsorted(
                    csum, np.arange(_PAIRS_PER_PASS, int(csum[-1]),
                                    _PAIRS_PER_PASS), side="right")
                for a0, a1 in zip(np.r_[0, cuts], np.r_[cuts, n]):
                    if a1 <= a0:
                        continue
                    k = cnt[a0:a1]
                    ii = np.repeat(atoms[a0:a1], k)
                    first = np.repeat(np.cumsum(k) - k, k)
                    jj = order[np.repeat(lo[a0:a1], k)
                               + np.arange(ii.size) - first]
                    d = pos[ii] - pos[jj]
                    d -= _round_half_away(d / box) * box
                    d2 = d[:, 0] * d[:, 0]
                    d2 += d[:, 1] * d[:, 1]
                    d2 += d[:, 2] * d[:, 2]
                    hit = (d2 < r2) & (ii != jj)
                    counts += np.bincount(ii[hit], minlength=n)
    counts = counts.astype(np.int32)
    return counts, int(counts.max())


def suggest_capacity(pos, box, r_cut, margin: float = 1.25) -> int:
    """A neighbor-list capacity: the largest count times ``margin``,
    rounded up to a multiple of 8, at least 8."""
    _, mx = neighbor_counts(pos, box, r_cut)
    cap = int(np.ceil(mx * margin))
    return max(8, ((cap + 7) // 8) * 8)

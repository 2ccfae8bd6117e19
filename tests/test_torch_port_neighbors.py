"""Port parity: the dense, top-k and cell neighbor formats and the host
capacity scan.

- ``neighbors_with_diffs`` in ``dense`` (K = N) and ``topk`` mode (a
  capacity below the largest count, so slots are truncated and ``excess``
  is positive) against the JAX package at float64: the valid index *sets*
  and the masks' counts exactly (``torch.topk`` and ``lax.top_k`` may
  order tied slots differently), each valid slot's displacement within
  1e-12, the overflow count exactly; ``neighbor_list``,
  ``neighbor_overflow``, ``max_neighbor_count`` and ``coord_diffs``.
- ``cell_neighbor_list`` at m = 1, 2, 3, 4 with padded atoms, and with an
  over-full cell (the same dropped atoms, the same overflow), against the
  JAX package; ``cell_overflow``, ``max_cell_occupancy`` and
  ``suggest_cells_per_dim``.
- The port's own ``neighbor_counts``/``suggest_capacity`` against
  ``enflow_tpu.native`` (the C++ cell list), including a box of two cells
  per axis, where the scan's offsets alias, and displacements of exactly
  half a box, where the min-image integer rounds half away from zero.

Inputs are made with numpy from a seed and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu import native as j_native
from enflow_tpu.data import celllist as jcl
from enflow_tpu.data import neighbors as jnb

from enflow_tpu_torch import native
from enflow_tpu_torch.data import celllist as tcl
from enflow_tpu_torch.data import neighbors as tnb
from torch_threads import one_torch_thread  # noqa: F401

B, N = 3, 40


def _state(seed, box_len=6.0, n_pad=0, r_cut=2.0, clump=False):
    """A batch of fluid-like frames: uniform positions in the box (the
    first molecule's atoms clumped into one corner when ``clump``), the
    last ``n_pad`` atoms of molecule 1 padded."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-box_len / 2, box_len / 2, (B, N, 3))
    if clump:
        pos[0, :N // 2] = rng.uniform(-box_len / 2, -box_len / 2 + 1.0,
                                      (N // 2, 3))
    mask = np.ones((B, N), bool)
    if n_pad:
        mask[1, N - n_pad:] = False
        pos[1, N - n_pad:] = 0.0
    box = np.full((B, 3), box_len)
    box[2] *= 1.1                           # a molecule with its own box
    return pos, box, mask, np.full((B,), r_cut)


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.asarray(a)) for a in arrs])


def _slot_sets(idx, diff, mask):
    """Per atom, the sorted (neighbor, displacement rounded to 1e-12) of
    its valid slots."""
    idx, diff, mask = (np.asarray(a) for a in (idx, diff, mask))
    return [[sorted((int(j), *np.round(d, 12))
                    for j, d, ok in zip(idx[b, i], diff[b, i], mask[b, i])
                    if ok)
             for i in range(idx.shape[1])] for b in range(idx.shape[0])]


def _assert_same_neighbors(tn, td, jn, jd):
    np.testing.assert_array_equal(tn.mask.sum(-1).numpy(),
                                  np.asarray(jn.mask).sum(-1))
    assert _slot_sets(tn.idx, td, tn.mask) == _slot_sets(jn.idx, jd, jn.mask)
    assert (td[~tn.mask] == 0).all()


@pytest.mark.parametrize("mode,capacity", [("dense", None), ("dense", 60),
                                           ("topk", 5), ("dense", 7)])
def test_dense_topk_match_jax(mode, capacity):
    """K = N (no capacity, or one >= N) and the truncating top-K."""
    arrs = _state(1, n_pad=6)
    (jp, jb, jm, jr), (tp, tb, tm, tr) = _both(arrs)
    jn, jd, jx = jnb.neighbors_with_diffs(jp, jb, jm, jr, capacity, mode,
                                          with_overflow=True)
    tn, td, tx = tnb.neighbors_with_diffs(tp, tb, tm, tr, capacity, mode,
                                          with_overflow=True)
    assert tn.idx.shape == tuple(jn.idx.shape)
    assert tn.idx.dtype == torch.int32 and tx.dtype == torch.int32
    _assert_same_neighbors(tn, td, jn, jd)
    assert int(tx) == int(jx)
    largest = int(jnb.max_neighbor_count(jp, jb, jm, jr))
    assert int(tnb.max_neighbor_count(tp, tb, tm, tr)) == largest
    if capacity is not None and capacity < largest:
        assert int(tx) > 0                  # truncation occurred
    else:
        assert int(tx) == 0
    # the split API gives the same structure
    nl = tnb.neighbor_list(tp, tb, tm, tr, capacity)
    assert torch.equal(nl.mask.sum(-1), tn.mask.sum(-1))
    torch.testing.assert_close(tnb.coord_diffs(tp, tb, nl), td, rtol=0,
                               atol=0)
    for cap in (largest - 1, largest):
        assert bool(tnb.neighbor_overflow(tp, tb, tm, tr, cap)) == bool(
            jnb.neighbor_overflow(jp, jb, jm, jr, cap))


def test_coord_diffs_match_jax():
    """``coord_diffs`` on a given neighbor structure: min-image, zeroed on
    invalid slots."""
    pos, box, mask, r_cut = _state(2, n_pad=3)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, N, (B, N, 9)).astype(np.int32)
    nmask = rng.random((B, N, 9)) > 0.3
    (jp, jb), (tp, tb) = _both((pos, box))
    want = jnb.coord_diffs(jp, jb, jnb.Neighbors(jnp.asarray(idx),
                                                 jnp.asarray(nmask)))
    got = tnb.coord_diffs(tp, tb, tnb.Neighbors(torch.from_numpy(idx),
                                                torch.from_numpy(nmask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_cell_list_matches_jax(m):
    """Every grid size, the degenerate m = 1, 2 wrap cases included, with
    padded atoms; and against the dense builder's set."""
    box_len = 9.0
    arrs = _state(10 + m, box_len=box_len, n_pad=5, r_cut=2.0)
    (jp, jb, jm, jr), (tp, tb, tm, tr) = _both(arrs)
    kw = dict(cells_per_dim=m, cell_capacity=N)
    jn, jd, jx = jnb.neighbors_with_diffs(jp, jb, jm, jr, 24, "cell",
                                          with_overflow=True, **kw)
    tn, td, tx = tnb.neighbors_with_diffs(tp, tb, tm, tr, 24, "cell",
                                          with_overflow=True, **kw)
    _assert_same_neighbors(tn, td, jn, jd)
    assert int(tx) == int(jx) == 0
    dn, dd = tnb.neighbors_with_diffs(tp, tb, tm, tr, None, "dense")
    assert _slot_sets(tn.idx, td, tn.mask) == _slot_sets(dn.idx, dd, dn.mask)


@pytest.mark.parametrize("m,cell_cap,capacity", [(2, 4, 24), (3, 3, 6),
                                                 (4, 2, 24)])
def test_cell_list_overflow_matches_jax(m, cell_cap, capacity):
    """Over-full cells (one molecule's atoms clumped into a corner) drop
    the same atoms as the JAX build; the overflow counts the dropped atoms
    and the slots past the top-K alike."""
    arrs = _state(20 + m, box_len=8.0, n_pad=4, r_cut=2.0, clump=True)
    (jp, jb, jm, jr), (tp, tb, tm, tr) = _both(arrs)
    jn, jx = jcl.cell_neighbor_list(jp, jb, jm, jr, capacity, m, cell_cap,
                                    with_overflow=True)
    tn, tx = tcl.cell_neighbor_list(tp, tb, tm, tr, capacity, m, cell_cap,
                                    with_overflow=True)
    np.testing.assert_array_equal(tn.mask.sum(-1).numpy(),
                                  np.asarray(jn.mask).sum(-1))
    sets = lambda nb: [[sorted(int(j) for j, ok in zip(r, mr) if ok)
                        for r, mr in zip(np.asarray(nb.idx[b]),
                                         np.asarray(nb.mask[b]))]
                       for b in range(B)]
    assert sets(tn) == sets(jn)
    assert int(tx) == int(jx) > 0
    occ = int(jcl.max_cell_occupancy(jp, jb, jm, m))
    assert int(tcl.max_cell_occupancy(tp, tb, tm, m)) == occ > cell_cap
    for cap in (occ - 1, occ):
        assert bool(tcl.cell_overflow(tp, tb, tm, tr, m, cap)) == bool(
            jcl.cell_overflow(jp, jb, jm, jr, m, cap))


@pytest.mark.parametrize("box,r_cut,max_cells", [
    ([9.0, 9.0, 9.0], 2.0, 32), ([5.0, 7.0, 9.0], 2.4, 32),
    ([100.0, 100.0, 100.0], 1.0, 32), ([1.0, 1.0, 1.0], 3.0, 32),
    ([50.0, 50.0, 50.0], 1.0, 16)])
def test_suggest_cells_per_dim_matches_jax(box, r_cut, max_cells):
    assert tcl.suggest_cells_per_dim(np.asarray(box), r_cut, max_cells) \
        == jcl.suggest_cells_per_dim(np.asarray(box), r_cut, max_cells)


def _frames():
    """(pos, box, r_cut) frames: many cells, few cells of unequal axes,
    two cells per axis (the aliasing branches, ``test_native.py:73``'s
    case), one cell, positions outside the box, and a lattice whose
    displacements hit exactly half a box."""
    rng = np.random.default_rng(7)
    out = [(rng.uniform(0, 1, (200, 3)) * [8.0, 9.0, 10.0],
            np.asarray([8.0, 9.0, 10.0]), 2.3),
           (rng.uniform(0, 3, (40, 3)), np.full(3, 3.0), 1.4),
           (rng.uniform(-3, 3, (60, 3)), np.asarray([4.0, 7.0, 12.0]), 1.9),
           (rng.uniform(-1, 1, (30, 3)), np.full(3, 2.0), 2.5),
           (rng.uniform(-20, 20, (90, 3)), np.full(3, 10.0), 3.1)]
    g = np.arange(4.0)
    lattice = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3) - 1.5
    out.append((lattice, np.full(3, 4.0), 2.01))
    box = np.full(3, 100.0 / 3.4)
    out.append((rng.uniform(-0.5, 0.5, (2944, 3)) * box, box, 3.0))
    return out


@pytest.mark.parametrize("case", range(7))
def test_neighbor_counts_match_native(case):
    if not j_native.available():
        pytest.skip("the JAX package's C++ library did not build")
    pos, box, r_cut = _frames()[case]
    want, want_max = j_native.neighbor_counts(pos, box, r_cut)
    got, got_max = native.neighbor_counts(pos, box, r_cut)
    np.testing.assert_array_equal(got, want)
    assert got_max == want_max
    assert native.suggest_capacity(pos, box, r_cut) == \
        j_native.suggest_capacity(pos, box, r_cut)


def test_half_box_rounds_away_from_zero():
    """A displacement of exactly 2.5 boxes: ``std::round`` takes 3 boxes
    off (|d| = 2.078999999999999), numpy's half-to-even ``np.round`` 2
    (|d| = 2.0790000000000006, 3 x 4.158 being inexact). With the cutoff
    between the two the pair counts only under ``std::round``, as in the
    C++ scan."""
    box = np.full(3, 4.158)
    pos = np.array([[2.5 * 4.158, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = pos[0, 0]
    away, even = abs(d - 3.0 * box[0]), abs(d - np.round(d / box[0]) * box[0])
    assert away < even
    r_cut = 0.5 * (away + even)
    counts, mx = native.neighbor_counts(pos, box, r_cut)
    np.testing.assert_array_equal(counts, [1, 1])
    assert mx == 1
    if j_native.available():
        want, _ = j_native.neighbor_counts(pos, box, r_cut)
        np.testing.assert_array_equal(counts, want)

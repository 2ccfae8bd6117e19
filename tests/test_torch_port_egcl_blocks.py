"""Port parity: the block-pair schedule of the bf16 Hopper all-pairs EGCL
kernels, for molecules past one warpgroup's shared memory.

``csrc/egcl_allpairs_sm90.cu``'s block-pair kernels cut a molecule into
``nI = ceil(N / A)`` blocks of ``A`` atoms (``ops.block_atoms``). The unit
of work is a (molecule, i-block) pair: it keeps the i-block's sums and
walks the j-blocks in order, each block pair's edge rows i != j in 64-row
tiles, i-major (row q: i = q // ncol, j the (q % ncol)-th j atom, skipping
j = i on the diagonal block pair), with the node sums as products S T as
in the one-molecule kernels. The i-side sums are whole when the walk ends;
the backward's j-side sums of each block pair go to their own row of
partials ``[B, nI, N, H+4]``, which a second kernel sums over the i-blocks
in order before it forms dh and dpos. The parameter gradients add into a
slice per warpgroup: dW2/dW3 and the column sums per tile, dW1b per block
pair (h_j times its j-side sums), dW1a per work item (h_i times the whole
i-side sums); the wrapper sums the slices in order.

``tiled_block_fwd`` / ``tiled_block_bwd`` / ``tiled_block_bwd_params``
below emulate that schedule in plain PyTorch: the same blocks, tiles,
segment boundaries, partial buffers and sums in the same places. Nothing
on the main path uses them. They are held against the plain version
(``allpairs_edges_plain`` / ``_plain_bwd``) at float64, to 1e-10 of each
output's largest value, and against the v3 Pallas kernels in interpret
mode at float32. The route rule (``ops.route_for``), the block plan and
the launch counters are checked here too; the kernels themselves run on
the card only (``chip_smoke.py``). Last, the port's flow at N=60 (past the
bf16 input-gradient kernel's one-molecule limit of 55) against the JAX
flow at float64.

Inputs are made with numpy from a seed: ragged masks, a molecule with one
real atom and one with none.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_egcl_tiles import (H, NF, TILE, _rows, _seg_matrix,
                                        _torch_weights, _weights)

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.flow import reverse_core as j_reverse_core
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, reverse_core
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import egcl_allpairs as ops
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten
from torch_threads import one_torch_thread  # noqa: F401

# the one-molecule kernels' limits at nf=5, H=128 (bf16 K1, K2, K2 p; f32
# K1, K2, K2 p), as the card's shared memory gives them
LARGEST = {(1, "fwd"): 111, (1, "bwd"): 55, (1, "bwd_params"): 61,
           (0, "fwd"): 142, (0, "bwd"): 519, (0, "bwd_params"): 70}
SLICES = 3                     # parameter slices (the kernel: warpgroups)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def pair_tiles(ni, nj, diag):
    """The tiles of one block pair: ``(row0, nr, li [64], lj [64], ncol)``
    with the block-local atoms of each row; rows past nr are padding
    (atoms 0)."""
    ncol = nj - int(diag)
    E = ni * ncol
    tiles = []
    for row0 in range(0, E, TILE):
        q = np.arange(row0, row0 + TILE)
        nr = min(TILE, E - row0)
        li = q // ncol
        jj = q - li * ncol
        lj = jj + (diag & (jj >= li))
        live = q < E
        tiles.append((row0, nr, np.where(live, li, 0), np.where(live, lj, 0),
                      ncol))
    return tiles


def block_schedule(N, A):
    """Per i-block (a molecule's work item): ``(i0, ni, [(j0, nj, tiles),
    ...])``, its first atom and atoms, and the ``ceil(N / A)`` j-blocks in
    the order the kernels walk them."""
    blocks = [(k, min(A, N - k)) for k in range(0, N, A)]
    return [(i0, ni, [(j0, nj, pair_tiles(ni, nj, i0 == j0))
                      for j0, nj in blocks])
            for i0, ni in blocks]


def _sum_into(acc, T, seg, nr, base, n):
    """acc[:, base + s] += (S T)[:, s] for the n block-local atoms from
    base (the kernels' seg_sum)."""
    S = _seg_matrix(seg, nr, base, n, T.dtype)
    acc[:, base:base + n] += torch.einsum("sr,brc->bsc", S, T)


def _i_side(acc, T, li, row0, nr, ncol):
    s0 = row0 // ncol
    _sum_into(acc, T, li, nr, s0, (row0 + nr - 1) // ncol - s0 + 1)


def _j_side(acc, T, lj, nr, nj):
    for jb in range(0, nj, TILE):
        _sum_into(acc, T, lj, nr, jb, min(TILE, nj - jb))


def tiled_block_fwd(h, pos, box, mask_f, weights, A):
    """The block-pair forward: ``(agg, f_sum)`` as ``allpairs_edges_plain``
    returns them."""
    Bm, N, _ = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = weights[4].shape[1]
    sums = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    for i0, ni, pairs in block_schedule(N, A):
        acci = torch.zeros((Bm, ni, Hd + 3), dtype=acc)
        for j0, _, tiles in pairs:
            for row0, nr, li, lj, ncol in tiles:
                cd, valid, _, _, _, m2, _, gate = _rows(
                    h, pos, box, mask_f, weights, i0 + li, j0 + lj, nr)
                trans = (torch.clamp(cd * gate, -100.0, 100.0)
                         * valid).to(cdt)
                T = torch.cat([m2.to(acc), trans.to(acc)], dim=-1)
                _i_side(acci, T, li, row0, nr, ncol)
        sums[:, i0:i0 + ni] = acci
    return sums[..., :Hd].to(cdt), sums[..., Hd:].to(cdt)


def _bwd_rows(h, pos, box, mask_f, weights, dagg, dfsum, gi, gj, nr):
    """One tile's backward chain at the kernels' rounding points (as
    ``tiled_bwd_params`` of the one-molecule schedule): its node-sum rows
    T = [dz1, dcd] and the pieces of the parameter gradients."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    cdt, acc = h.dtype, ops._acc(h.dtype)
    cd, valid, validc, z1, z2, m2, z3, gate = _rows(
        h, pos, box, mask_f, weights, gi, gj, nr)
    it = torch.from_numpy(gi)
    r2 = (cd * cd).sum(-1, keepdim=True)
    d_trans = dfsum.to(cdt).to(acc)[:, it]
    raw = cd * gate
    inside = ((raw >= -100.0) & (raw <= 100.0)).to(acc)
    d_trans = d_trans * inside * valid
    d_gate = (cd * d_trans).sum(-1, keepdim=True)
    d_cd = gate * d_trans
    dz3 = ops._dot(d_gate.to(cdt), w4.T, cdt) * ops._dsilu(z3)
    d_m2 = (ops._dot(dz3, W3.T, cdt) + dagg.to(cdt)[:, it]) * validc
    dz2 = d_m2 * ops._dsilu(z2)
    dz1 = ops._dot(dz2, W2.T, cdt) * ops._dsilu(z1)
    d_r2 = (dz1.to(acc) * w1r.to(acc)).sum(-1, keepdim=True)
    dcd = (d_cd + 2.0 * cd * d_r2).to(cdt)
    T = torch.cat([dz1.to(acc), dcd.to(acc)], dim=-1)
    return T, dict(z1=z1, m2=m2, z3=z3, dz1=dz1, dz2=dz2, dz3=dz3,
                   d_gate=d_gate, r2=r2)


def tiled_block_bwd_params(h, pos, box, mask_f, weights, dagg, dfsum, A,
                           params=True):
    """The block-pair backward: ``(dh, dpos)``, and with ``params`` the
    nine parameter gradients after them, as ``allpairs_edges_plain_bwd``
    returns them. Work item ``it = b nI + ib`` adds into slice ``it %
    SLICES`` (a warpgroup's grid-stride walk); the slices are summed in
    order, as the wrapper sums them."""
    W1a, W1b = weights[0], weights[1]
    Bm, N, nf = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = weights[4].shape[1]
    nI = math.ceil(N / A)
    si = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    pj = torch.zeros((Bm, nI, N, Hd + 3), dtype=acc)
    shapes = (("dW2", (Hd, Hd)), ("dW3", (Hd, Hd)), ("dW1a", (nf, Hd)),
              ("dW1b", (nf, Hd)), ("dw1r", (Hd,)), ("db1", (Hd,)),
              ("db2", (Hd,)), ("db3", (Hd,)), ("dw4", (Hd,)))
    item = {k: torch.zeros((Bm, nI) + shape, dtype=acc)
            for k, shape in shapes}
    ones = torch.ones((1, TILE), dtype=acc)
    colsum = lambda T: torch.einsum("sr,brc->bc", ones, T.to(acc))
    wsum = lambda w, T: torch.einsum("br,brc->bc", w[..., 0], T.to(acc))
    outer = lambda X, T: torch.einsum("brk,brn->bkn", X.to(acc), T.to(acc))
    hf = h.to(acc)
    for ib, (i0, ni, pairs) in enumerate(block_schedule(N, A)):
        acci = torch.zeros((Bm, ni, Hd + 3), dtype=acc)
        add = lambda k, v: item[k][:, ib].add_(v)
        for j0, nj, tiles in pairs:
            accj = torch.zeros((Bm, nj, Hd + 3), dtype=acc)
            for row0, nr, li, lj, ncol in tiles:
                T, p = _bwd_rows(h, pos, box, mask_f, weights, dagg, dfsum,
                                 i0 + li, j0 + lj, nr)
                _i_side(acci, T, li, row0, nr, ncol)
                _j_side(accj, T, lj, nr, nj)
                add("dW3", outer(p["m2"], p["dz3"]))
                add("db3", colsum(p["dz3"]))
                add("dw4", wsum(p["d_gate"], ops._silu(p["z3"])))
                add("db2", colsum(p["dz2"]))
                add("dW2", outer(ops._silu(p["z1"]), p["dz2"]))
                add("db1", colsum(p["dz1"]))
                add("dw1r", wsum(p["r2"], p["dz1"]))
            pj[:, ib, j0:j0 + nj] = accj
            add("dW1b", torch.einsum("bik,bic->bkc", hf[:, j0:j0 + nj],
                                     accj[..., :Hd]))
        si[:, i0:i0 + ni] = acci
        add("dW1a", torch.einsum("bik,bic->bkc", hf[:, i0:i0 + ni],
                                 acci[..., :Hd]))
    # the second kernel: the partials summed over the i-blocks in order
    sj = torch.zeros_like(si)
    for ib in range(nI):
        sj = sj + pj[:, ib]
    dh = (ops._dot(si[..., :Hd].to(cdt), W1a.T, acc)
          + ops._dot(sj[..., :Hd].to(cdt), W1b.T, acc)).to(cdt)
    out = (dh, si[..., Hd:] - sj[..., Hd:])
    if not params:
        return out
    tot = {}
    for k, v in item.items():
        flat = v.reshape((Bm * nI,) + v.shape[2:])   # items in it order
        tot[k] = torch.stack([flat[g::SLICES].sum(0)
                              for g in range(SLICES)]).sum(0)
    return out + (tot["dW1a"], tot["dW1b"], tot["dw1r"][None],
                  tot["db1"][None], tot["dW2"], tot["db2"][None], tot["dW3"],
                  tot["db3"][None], tot["dw4"][:, None])


def tiled_block_bwd(h, pos, box, mask_f, weights, dagg, dfsum, A):
    """The block-pair input-gradient backward: ``(dh, dpos)``."""
    return tiled_block_bwd_params(h, pos, box, mask_f, weights, dagg, dfsum,
                                  A, params=False)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _inputs(N, Bm, seed, dtype):
    """h, pos, box, mask for Bm >= 4 molecules: molecule 0 full, 1 with a
    padded tail, 2 with one real atom, 3 with none, the rest ragged at
    random; periodic boxes for odd molecules."""
    rng = np.random.default_rng(seed)
    mask = np.ones((Bm, N), bool)
    mask[1, N - max(1, N // 3):] = False
    mask[2, 1:] = False
    mask[3, :] = False
    for b in range(4, Bm):
        mask[b] = rng.uniform(size=N) > 0.25
    h = rng.normal(size=(Bm, N, NF))
    pos = rng.normal(size=(Bm, N, 3)) * 2.0
    box = np.full((Bm, 3), 1e3)
    box[1::2] = 4.0
    pos[1::2] = rng.uniform(-4.0, 4.0, size=pos[1::2].shape)
    h[~mask] = 0.0
    pos[~mask] = 0.0
    return (h.astype(dtype), pos.astype(dtype), box.astype(dtype), mask)


def _torch_args(N, Bm, seed, dtype, wseed):
    h, pos, box, mask = _inputs(N, Bm, seed, dtype)
    jp, leaves = _weights(wseed)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    t = lambda a: torch.from_numpy(np.asarray(a))
    W = _torch_weights(leaves, tdt)
    rng = np.random.default_rng(seed + 1000)
    dagg = rng.normal(size=(Bm, N, H)).astype(dtype)
    dfsum = rng.normal(size=(Bm, N, 3)).astype(dtype)
    return ((t(h), t(pos), t(box), t(mask).to(tdt), W), t(dagg), t(dfsum),
            (jp, h, pos, box, mask, dagg, dfsum))


# ---------------------------------------------------------------------------
# the route rule, the block plan and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code,direction", sorted(LARGEST))
def test_route_rule(code, direction):
    """At the one-molecule limit the old route; one atom past it the
    block-pair kernels of the dtype: bf16 ``"blocks"``, f32
    ``"f32_blocks"`` (no refusal any more)."""
    largest = LARGEST[(code, direction)]
    old = "sm90" if code == 1 else "f32"
    new = "blocks" if code == 1 else "f32_blocks"
    assert ops.route_for(largest, 5, 128, code, direction, largest) == old
    assert ops.route_for(1, 5, 128, code, direction, largest) == old
    for n in (largest + 1, 147 if largest < 147 else 561, 5000):
        assert ops.route_for(n, 5, 128, code, direction, largest) == new
    assert ops.route_for(largest + 1, 5, 64, code, direction, largest) == new


@pytest.mark.parametrize("code", [0, 1])
def test_route_rule_other_widths_refuse(code):
    """Other widths run at the padded width (``ops.padded_width``): H = 96
    on the routes of 128 (the dtype's one-molecule kernels up to their
    limit, its block pairs past it), 128 < H <= 256 on the dtype's block
    pairs with streamed weights at every N (``"wide"``, bf16;
    ``"f32_wide"``, float32); past 256 the column-chunked kernels of the
    dtype at every N (``"xwide"`` / ``"f32_xwide"``). Only a width past
    ``XWIDE_MAX_H`` is refused, in either dtype, naming the queue item that
    holds it."""
    one, blk = ("sm90", "blocks") if code == 1 else ("f32", "f32_blocks")
    wide = "wide" if code == 1 else "f32_wide"
    assert ops.route_for(40, 5, 96, code, "bwd", 40) == one
    assert ops.route_for(41, 5, 96, code, "bwd", 40) == blk
    for H in (160, 192, 256):
        for N in (40, 41, 5000):
            assert ops.route_for(N, 5, H, code, "bwd", 40) == wide
    assert ops.route_for(2, 5, 320, code, "bwd", 40) == \
        ops.XWIDE_ROUTE[code]
    with pytest.raises(ValueError, match="B7.5") as e:
        ops.route_for(2, 5, ops.XWIDE_MAX_H + 1, code, "bwd", 40)
    assert ops.XWIDE_ITEM in str(e.value)


@pytest.mark.parametrize("N,fit,want", [(56, 48, 32), (62, 56, 32),
                                        (75, 48, 40), (147, 48, 40),
                                        (147, 32, 32), (147, 56, 56),
                                        (512, 48, 48), (1, 48, 8),
                                        (40, 64, 40)])
def test_block_atoms(N, fit, want):
    A = ops.block_atoms(N, fit)
    assert A == want and A % 8 == 0 and A <= max(fit, 8)
    nI = math.ceil(N / A)
    assert nI == math.ceil(N / fit)          # no more blocks than needed


@pytest.mark.parametrize("direction,largest_a,want", [
    ("fwd", {3: 16, 2: 32, 1: 64}, (32, 2)),
    ("fwd", {3: 40, 2: 64, 1: 64}, (32, 3)),
    ("bwd", {2: 8, 1: 48}, (32, 1)),
    ("bwd_params", {2: 16, 1: 56}, (32, 1)),
    ("bwd", {2: 0, 1: 24}, (24, 1)),
    ("bwd", {2: 0, 1: 8}, (8, 1))])
def test_blocks_plan(direction, largest_a, want):
    """The most warpgroups with blocks of 32 atoms, else one warpgroup
    and the most atoms that fit; N=147."""
    fits = lambda A, nwg: A <= largest_a.get(nwg, 0)
    assert ops.blocks_plan(147, direction, fits) == want


def test_blocks_plan_refuses_when_nothing_fits():
    with pytest.raises(ValueError, match="no atom block fits"):
        ops.blocks_plan(147, "bwd", lambda A, nwg: False)


@pytest.mark.parametrize("direction,name", [
    ("fwd", "fwd_blocks_launches"), ("bwd", "bwd_blocks_launches"),
    ("bwd_params", "bwd_param_blocks_launches")])
def test_blocks_route_counts_on_its_own_counter(direction, name):
    ops.counts.reset()
    ops._count(direction, 128, "blocks")
    got = {k: v for k, v in vars(ops.counts).items()
           if not k.startswith("_") and v}
    assert got == {name: 1}
    ops.counts.reset()


def test_a_failed_launch_raises_with_the_route():
    """A launch the card refuses raises, with the error string of the
    route's own library (which has no other route's)."""
    class Lib:
        def egcl_sm90_error_string(self, err):
            return b"invalid argument"
    with pytest.raises(RuntimeError, match="invalid argument.*blocks"):
        ops._raise_on(Lib(), 1, "backward", (2, 147, 5, 128), "blocks")
    ops._raise_on(Lib(), 0, "backward", (2, 147, 5, 128), "blocks")


def test_blocks_entry_point_takes_cuda_tensors_only():
    args, dagg, dfsum, _ = _torch_args(8, 4, 1, np.float32, 3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.allpairs_edges_blocks("fwd", *args)


# ---------------------------------------------------------------------------
# the schedule against the plain version and the Pallas kernels
# ---------------------------------------------------------------------------

SCHED = [(56, 32), (62, 56), (75, 48), (147, 48), (147, 32), (75, 16)]


@pytest.mark.parametrize("N,fit", SCHED)
def test_block_schedule_visits_each_pair_once(N, fit):
    """Every ordered pair i != j once (the walk does not depend on the
    mask); each tile's i-side segments inside the 64 rows of S; padding
    only in a block pair's last tile."""
    A = ops.block_atoms(N, fit)
    seen = []
    items = block_schedule(N, A)
    assert [i0 for i0, _, _ in items] == list(range(0, N, A))
    assert sum(ni for _, ni, _ in items) == N
    for i0, ni, pairs in items:
        assert [j0 for j0, _, _ in pairs] == list(range(0, N, A))
        for j0, nj, tiles in pairs:
            for k, (row0, nr, li, lj, ncol) in enumerate(tiles):
                assert row0 == k * TILE and (nr == TILE
                                             or k == len(tiles) - 1)
                seen += list(zip((i0 + li[:nr]).tolist(),
                                 (j0 + lj[:nr]).tolist()))
                s0 = row0 // ncol
                ns = (row0 + nr - 1) // ncol - s0 + 1
                assert 1 <= ns <= TILE and set(li[:nr]) == set(
                    range(s0, s0 + ns))
                assert lj[:nr].max() < nj
    want = [(a, b) for a in range(N) for b in range(N) if a != b]
    assert len(seen) == len(want) and set(seen) == set(want)


@pytest.mark.parametrize("N,fit", [(56, 32), (62, 24), (75, 48), (147, 32)])
def test_block_tiles_match_plain_f64(N, fit):
    """Forward, input gradients and all nine parameter gradients of the
    block schedule against the plain version at float64, to 1e-10 of each
    output's largest value."""
    A = ops.block_atoms(N, fit)
    args, dagg, dfsum, (_, _, _, _, mask, _, _) = _torch_args(
        N, 6, N, np.float64, 7)
    got = (tiled_block_fwd(*args, A)
           + tiled_block_bwd_params(*args, dagg, dfsum, A))
    want = (ops.allpairs_edges_plain(*args)
            + ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        w = w.numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
    # padded atoms receive nothing; the empty molecule is all zeros
    for g in got[:4]:
        assert float(g[torch.from_numpy(~mask)].abs().max()) == 0.0
        assert float(g[3].abs().max()) == 0.0
    # the input-gradient form is the same schedule
    dh, dpos = tiled_block_bwd(*args, dagg, dfsum, A)
    assert torch.equal(dh, got[2]) and torch.equal(dpos, got[3])


@pytest.mark.parametrize("N", [56, 75])
def test_block_tiles_match_pallas_f32(N):
    """Against the v3 Pallas K1/K2 in interpret mode at float32: forward
    at rtol 2e-5 / atol 2e-6, the input-gradient VJP at rtol 5e-5 / atol
    5e-6 and the nine parameter gradients at rtol 5e-5 / atol 5e-6 of
    their largest value (test_torch_port_egcl.py's f32 tolerances)."""
    A = ops.block_atoms(N, ops.BLOCK_ATOMS_MAX)
    args, dagg, dfsum, (jp, h, pos, box, mask, c_agg, c_fs) = _torch_args(
        N, 4, 50 + N, np.float32, 5)
    jh, jpos = jnp.asarray(h), jnp.asarray(pos)
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(p, hh, pp):
        a, f, _ = fused_allpairs_edges_v3(p, hh, pp, jbox, jmask,
                                          mol_tile=4)
        return (a * c_agg).sum() + (f * c_fs).sum()

    ja, jf, _ = fused_allpairs_edges_v3(jp, jh, jpos, jbox, jmask,
                                        mol_tile=4)
    jg, jgh, jgp = jax.grad(jloss, argnums=(0, 1, 2))(jp, jh, jpos)
    W1 = np.asarray(jg["edge_nn"][0]["w"])
    jparams = [W1[:NF], W1[NF:2 * NF], W1[2 * NF:2 * NF + 1],
               np.asarray(jg["edge_nn"][0]["b"])[None],
               np.asarray(jg["edge_nn"][1]["w"]),
               np.asarray(jg["edge_nn"][1]["b"])[None],
               np.asarray(jg["coord_nn"][0]["w"]),
               np.asarray(jg["coord_nn"][0]["b"])[None],
               np.asarray(jg["coord_nn"][1]["w"])]
    agg, fsum = tiled_block_fwd(*args, A)
    dh, dpos, *pgrads = tiled_block_bwd_params(*args, dagg, dfsum, A)
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
    for got, want in ((dh, jgh), (dpos, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)
    for g, w in zip(pgrads, jparams):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the slice as a whole: the flow past the one-molecule limit
# ---------------------------------------------------------------------------

FLOW_N, FLOW_B, FLOW_NF, FLOW_H = 60, 2, 5, 16


def test_flow_past_the_bf16_limit_matches_jax_f64():
    """The port's flow log-density (reverse, 2 LF steps, all pairs) and
    its gradient in the positions and every parameter at N=60, the size
    that the block-pair backward serves on the card, against the JAX flow
    at float64 (1e-10 of each array's largest value)."""
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(FLOW_NF, FLOW_H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(FLOW_NF, FLOW_H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(4), jcfg, jnp.float64)
    rng = np.random.default_rng(60)
    mask = np.ones((FLOW_B, FLOW_N), bool)
    mask[1, -7:] = False
    arrs = {"h": rng.normal(size=(FLOW_B, FLOW_N, FLOW_NF)),
            "g": rng.normal(size=(FLOW_B, FLOW_N, FLOW_NF)),
            "pos": rng.normal(size=(FLOW_B, FLOW_N, 3)) * 1.5,
            "vel": rng.normal(size=(FLOW_B, FLOW_N, 3))}
    for a in arrs.values():
        a[~mask] = 0.0
    box = np.full((FLOW_B, 3), 1e3)
    r_cut = np.full((FLOW_B,), 1e2)
    c_pos = rng.normal(size=(FLOW_B, FLOW_N, 3))

    def jlog_density(p, pos):
        sys = JSystem(mask=jnp.asarray(mask), box=jnp.asarray(box),
                      r_cut=jnp.asarray(r_cut), h=jnp.asarray(arrs["h"]),
                      g=jnp.asarray(arrs["g"]), pos=pos,
                      vel=jnp.asarray(arrs["vel"]))
        out, ldj = j_reverse_core(p, jcfg, sys)
        return ldj.sum() + (out.pos * c_pos).sum(), ldj

    (_, jldj), (jgp, jgpos) = jax.value_and_grad(
        jlog_density, argnums=(0, 1), has_aux=True)(
            jp, jnp.asarray(arrs["pos"]))

    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    pos = t(arrs["pos"]).requires_grad_(True)
    tsys = System(mask=t(mask), box=t(box), r_cut=t(r_cut), h=t(arrs["h"]),
                  g=t(arrs["g"]), pos=pos, vel=t(arrs["vel"]))
    out, ldj = reverse_core(tp, tcfg, tsys)
    (ldj.sum() + (out.pos * t(c_pos)).sum()).backward()

    close = lambda g, w: np.testing.assert_allclose(
        g, w, rtol=1e-10, atol=1e-10 * np.abs(w).max())
    close(ldj.detach().numpy(), np.asarray(jldj))
    close(pos.grad.numpy(), np.asarray(jgpos))
    jleaves = jax.tree_util.tree_leaves(jgp)
    assert len(jleaves) == len(leaves)
    for g, w in zip(leaves, jleaves):
        # a leaf the reverse pass does not read has no gradient (JAX: 0)
        got = g.grad if g.grad is not None else torch.zeros_like(g)
        close(got.numpy(), np.asarray(w))

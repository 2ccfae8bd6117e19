"""Port parity: the block plan of the pair-energy kernel (K7).

``csrc/pair_energy.cu`` runs on the plan of ``ops.pair_plan``: blocks of
128 threads as rows x column lanes; molecules of up to 32 atoms whole in a
block (several a block where the rows take them), larger ones in row tiles
of 32 atoms and column splits; each thread owns a row atom and every
lanes-th column of the block's columns, staged 1,024 at a time; a row's
lanes are summed by xor shuffles, a block's rows in row order, and the
partials (E per block ``[B, row_tiles * splits]``, the gradient per split
``[B, splits, N, 3]``) by a second kernel in a fixed order. ``visits`` and
``emulate`` below repeat those loops and sums in plain PyTorch; nothing on
the main path uses them. Held here:

- the plans at the committed shapes (the NLL term at B=30, N=13; the MD
  of train.yaml at B=1, N=13; generate.yaml's 2,944 atoms; phase pair's
  B=2, N=1,500) and the packing rule for large B;
- every ordered pair (i, j), self pairs included, visited exactly once
  over B in {1, 30} and N in {4, 13, 300} (also with a 64-column stage, so
  that the stage loop runs several times);
- the partial layout's sums in the kernel's order against
  ``pair_energy_plain`` at float64 (1e-12), both forms, with padded atoms,
  coincident atoms and the ``coincident`` flag, and periodic boxes;
- the port's plain version against ``pallas_softened_lj_energy`` in
  interpret mode at float32 (rtol 1e-5, as ``test_torch_port_pair.py``)
  and against the JAX package's dense ``softened_lj_energy`` at float64,
  on a jittered lattice of 216 atoms in generate.yaml's box (100 A in
  reduced units, cutoff 3) that straddles the periodic boundary.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.ops import pairwise_kernel as pk
from enflow_tpu.sim.potentials import softened_lj_energy as j_softened

from enflow_tpu_torch.data.lj import arrange_points_on_grid
from enflow_tpu_torch.ops import pair_energy as ops
from enflow_tpu_torch.utils import conversion as cv
from torch_threads import one_torch_thread  # noqa: F401

N_SM = 132


def visits(B, N, plan, stage=ops.STAGE_COLS):
    """The kernel's loops: for each live thread, ``(block, row, lane,
    molecule b, row atom i, columns j)``, the columns in the order the
    thread takes them."""
    out = []
    CL = plan.lanes
    RB = ops.THREADS // CL
    for blk in range(plan.blocks):
        grp, u = divmod(blk, plan.units)
        t, s = divmod(u, plan.splits)
        b0 = grp * plan.mols
        nm = min(plan.mols, B - b0)
        c_first = s * plan.cols
        count = nm * N if plan.splits == 1 else min(plan.cols, N - c_first)
        for r in range(RB):
            m, rr = divmod(r, plan.tile)
            i = t * plan.tile + rr
            if not (r < plan.mols * plan.tile and m < nm and i < N):
                continue
            lo = m * N if plan.splits == 1 else 0
            n = N if plan.splits == 1 else count
            j0 = 0 if plan.splits == 1 else c_first
            for c in range(CL):
                cols = []
                for base in range(0, count, stage):
                    nc = min(stage, count - base)
                    q1 = min(lo + n, base + nc)
                    cols.append(np.arange(max(lo, base) + c, q1, CL))
                q = np.concatenate(cols)
                out.append((blk, r, c, b0 + m, i, j0 + q - lo))
    return out


def _pairs(pos, mask, box, form, soft, cutoff, coincident):
    """Per ordered pair, as the kernel evaluates it: energy ``e [B,N,N]``
    and gradient term ``g [B,N,N,3]`` (0 where invalid)."""
    d = pos[:, :, None, :] - pos[:, None, :, :]
    if form == "r":
        bx = box[:, None, None, :]
        d = d - torch.round(d / bx) * bx
    d2 = (d * d).sum(-1)
    real = mask[:, :, None] * mask[:, None, :] > 0
    valid = real & (d2 > 0)
    if form == "r":
        if coincident and soft > 0:
            other = ~torch.eye(pos.shape[1], dtype=torch.bool)
            valid = valid | (real & other & (d2 == 0))
        valid = valid & (d2 < cutoff * cutoff)
    e, de = ops._pair_terms(torch.where(valid, d2, torch.ones_like(d2)),
                            soft, form)
    e = torch.where(valid, e, torch.zeros_like(e))
    de = torch.where(valid & (d2 > 0), de, torch.zeros_like(de))
    return e, de[..., None] * 2.0 * d


def emulate(pos, mask, box, form, soft, cutoff=None, coincident=False,
            plan=None, stage=ops.STAGE_COLS):
    """``(E [B], dE/dpos [B,N,3])`` as the kernel sums them: per thread
    over its columns, the row's lanes by the xor butterfly, the block's
    rows per molecule in row order, then the gradient partials over the
    splits in order and the energy partials as the reduce kernel does."""
    B, N, _ = pos.shape
    plan = plan or ops.pair_plan(B, N, N_SM)
    e, g = _pairs(pos, mask, box, form, soft, cutoff, coincident)
    dt = pos.dtype
    RB, CL = ops.THREADS // plan.lanes, plan.lanes
    lane_e = torch.zeros((plan.blocks, RB, CL), dtype=dt)
    lane_g = torch.zeros((plan.blocks, RB, CL, 3), dtype=dt)
    rows = {}
    for blk, r, c, b, i, js in visits(B, N, plan, stage):
        js = torch.from_numpy(js)
        lane_e[blk, r, c] = e[b, i, js].sum()
        lane_g[blk, r, c] = g[b, i, js].sum(0)
        rows[(blk, r)] = (b, i)
    o = CL // 2
    while o:                                    # xor butterfly
        idx = torch.arange(CL) ^ o
        lane_e = lane_e + lane_e[:, :, idx]
        lane_g = lane_g + lane_g[:, :, idx]
        o //= 2
    units = plan.units
    energy = torch.zeros(B, dtype=dt)
    grad = torch.zeros((B, N, 3), dtype=dt)
    part_e = torch.zeros((B, units), dtype=dt)
    part_g = torch.zeros((B, plan.splits, N, 3), dtype=dt)
    for blk in range(plan.blocks):
        grp, u = divmod(blk, units)
        s = u % plan.splits
        b0 = grp * plan.mols
        erow = [lane_e[blk, r, 0] if (blk, r) in rows else 0.0
                for r in range(RB)]
        for (bb, r), (b, i) in rows.items():
            if bb == blk:
                if plan.splits == 1:
                    grad[b, i] = lane_g[blk, r, 0]
                else:
                    part_g[b, s, i] = lane_g[blk, r, 0]
        for m in range(min(plan.mols, B - b0)):
            tot = torch.zeros((), dtype=dt)
            for r in range(m * plan.tile, min(m * plan.tile + plan.tile, RB)):
                tot = tot + erow[r]
            if units == 1:
                energy[b0 + m] = 0.5 * tot
            else:
                part_e[b0 + m, u] = tot
    if plan.splits > 1:
        grad = torch.zeros((B, N, 3), dtype=dt)
        for s in range(plan.splits):
            grad = grad + part_g[:, s]
    if units > 1:
        tot = torch.zeros(B, dtype=dt)
        for u in range(units):
            tot = tot + part_e[:, u]
        energy = 0.5 * tot
    return energy, grad


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_at_the_committed_shapes():
    """B=30 / B=1 at N=13: one molecule a block, 13 rows x 8 lanes (two
    columns a thread), E written directly; generate.yaml's 2,944 atoms:
    92 row tiles x 12 splits of 246 columns, 1,104 blocks; phase pair's
    B=2, N=1,500: 47 x 11 splits of 137, 1,034 blocks; N=4: 8 molecules a
    block of 32 rows x 4 lanes."""
    P = ops.PairPlan
    assert ops.pair_plan(30, 13, N_SM) == P(8, 1, 13, 1, 1, 13, 30)
    assert ops.pair_plan(1, 13, N_SM) == P(8, 1, 13, 1, 1, 13, 1)
    big = ops.pair_plan(1, 2944, N_SM)
    assert big == P(4, 1, 32, 92, 12, 246, 1) and big.blocks == 1104
    assert ops.pair_plan(2, 1500, N_SM) == P(4, 1, 32, 47, 11, 137, 2)
    assert ops.pair_plan(30, 4, N_SM) == P(4, 8, 4, 1, 1, 4, 4)
    assert ops.pair_plan(1, 1, N_SM) == P(1, 128, 1, 1, 1, 1, 1)


def test_plan_packs_molecules_when_b_is_large():
    """One molecule a block until that takes more than 16 blocks an SM;
    then the lanes halve and the molecules a block double (N=13: 4
    molecules of 13 rows x 2 lanes at B=5000); a large molecule keeps
    splits of at least 128 columns."""
    assert ops.pair_plan(2000, 13, N_SM).mols == 1
    assert ops.pair_plan(5000, 13, N_SM) == ops.PairPlan(2, 4, 13, 1, 1, 13,
                                                         1250)
    p = ops.pair_plan(1, 200, N_SM)
    assert (p.row_tiles, p.splits, p.cols) == (7, 1, 200)
    for B, N in ((1, 2944), (2, 1500), (64, 40), (1, 33)):
        p = ops.pair_plan(B, N, N_SM)
        assert p.splits == 1 or p.cols >= ops.MIN_SPLIT_COLS
        assert (p.splits - 1) * p.cols < N <= p.splits * p.cols
        assert p.mols * p.tile <= ops.THREADS // p.lanes


@pytest.mark.parametrize("stage", (ops.STAGE_COLS, 64))
@pytest.mark.parametrize("N", (4, 13, 300))
@pytest.mark.parametrize("B", (1, 30))
def test_plan_visits_each_ordered_pair_once(B, N, stage):
    plan = ops.pair_plan(B, N, N_SM)
    seen = np.zeros((B, N, N), np.int64)
    owner = {}
    for blk, r, c, b, i, js in visits(B, N, plan, stage):
        np.add.at(seen[b, i], js, 1)
        # a row atom has one (block, row) per split, all in one molecule
        owner.setdefault((b, i), set()).add(blk)
    assert (seen == 1).all()
    assert all(len(v) == plan.splits for v in owner.values())
    assert len(owner) == B * N


# ---------------------------------------------------------------------------
# the partial layout's sums
# ---------------------------------------------------------------------------

def _inputs(B, N, form, seed):
    """Positions, masks and boxes: padded atoms in molecule 0, a coincident
    pair in the last molecule, boxes of 4 to 7 (form r: positions over
    1.3 boxes, so the min-image takes 0 and +-1)."""
    rng = np.random.default_rng(seed)
    box = rng.uniform(4.0, 7.0, size=(B, 3)) if form == "r" else np.ones(
        (B, 3))
    if form == "r":
        pos = (rng.uniform(-0.65, 0.65, size=(B, N, 3)) * box[:, None])
    else:
        pos = rng.normal(size=(B, N, 3)) * 1.4
    mask = np.ones((B, N))
    mask[0, N - max(1, N // 5):] = 0.0
    pos[-1, 1] = pos[-1, 0]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    return t(pos * mask[..., None]), t(mask), t(box)


@pytest.mark.parametrize("form,coincident", [("r2", False), ("r", False),
                                             ("r", True)])
@pytest.mark.parametrize("B,N", [(1, 4), (1, 13), (1, 300), (30, 4),
                                 (30, 13), (4, 300)])
def test_partial_sums_match_plain_f64(B, N, form, coincident):
    pos, mask, box = _inputs(B, N, form, seed=100 * B + N)
    soft, cut = 0.1, 3.0
    got = emulate(pos, mask, box, form, soft, cut, coincident)
    want = ops.pair_energy_plain(pos, mask, box, form, soft, cut, coincident)
    for g, w in zip(got, want):
        w = w.numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the plain version on generate.yaml's geometry
# ---------------------------------------------------------------------------

def _generate_lattice(dtype):
    """216 atoms of generate.yaml's box (100 A, in sigma) on a jittered
    lattice of spacing ~1.4 sigma, shifted across the periodic boundary
    and wrapped into the box."""
    box = float(cv.dist_to_lj(100.0, "ang"))
    sub = arrange_points_on_grid(216, [box / 3.5] * 3, 0.5)
    rng = np.random.default_rng(5)
    pos = sub + 0.08 * rng.normal(size=sub.shape) - box / 7.0
    pos = np.mod(pos, box)
    return pos.astype(dtype), np.full(3, box, dtype)


def test_plain_matches_pallas_on_generate_lattice_f32():
    pos, box = _generate_lattice(np.float32)
    f = lambda p: pk.pallas_softened_lj_energy(p, jnp.asarray(box), 0.0, 3.0)
    je = float(f(jnp.asarray(pos)))
    jg = np.asarray(jax.grad(f)(jnp.asarray(pos)))
    te, tg = ops.pair_energy_and_grad(
        torch.from_numpy(pos)[None], torch.ones((1, len(pos))),
        torch.from_numpy(box)[None], "r", 0.0, 3.0)
    assert float(te[0]) == pytest.approx(je, rel=1e-5)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    # the lattice has pairs inside the cutoff, some across the boundary
    assert np.abs(jg).max() > 0


def test_plain_matches_dense_jax_on_generate_lattice_f64():
    pos, box = _generate_lattice(np.float64)
    f = lambda p: j_softened(p, jnp.asarray(box), 0.0, 3.0)
    je = float(f(jnp.asarray(pos)))
    jg = np.asarray(jax.grad(f)(jnp.asarray(pos)))
    te, tg = ops.pair_energy_and_grad(
        torch.from_numpy(pos)[None], torch.ones((1, len(pos)),
                                                dtype=torch.float64),
        torch.from_numpy(box)[None], "r", 0.0, 3.0, coincident=True)
    assert float(te[0]) == pytest.approx(je, rel=1e-12)
    np.testing.assert_allclose(tg[0].numpy(), jg, rtol=1e-10, atol=1e-12)
    # and the kernel's sums, emulated, on the same atoms
    ee, eg = emulate(torch.from_numpy(pos)[None],
                     torch.ones((1, len(pos)), dtype=torch.float64),
                     torch.from_numpy(box)[None], "r", 0.0, 3.0, True)
    assert float(ee[0]) == pytest.approx(je, rel=1e-12)
    np.testing.assert_allclose(eg[0].numpy(), jg, rtol=1e-10, atol=1e-12)

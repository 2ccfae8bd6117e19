"""Port parity: the block-pair schedule of the float32 all-pairs EGCL
kernels, for molecules past the tiled f32 kernels' shared memory.

``csrc/egcl_allpairs_f32.cu``'s block-pair kernels
(``egcl_f32_blocks_*``) cut a molecule into ``nI = ceil(N / A)`` blocks of
``A`` atoms (``ops.f32_blocks_plan``, ``ops.block_atoms``). The unit of
work is a (molecule, i-block) item: it keeps the i-block's sums and walks
the j-blocks in order, each block pair's rows i != j (i-major; row q: i = q
// ncol, j the (q % ncol)-th j atom, skipping j = i on the diagonal block
pair) in row tiles of R rows, the last holding the rest, each computed as
a multiple of 8 rows with the padding masked (the one-molecule f32
kernels' row code). The forward's sums are i-side only: an item writes its
atoms' agg and f_sum. The backward's j-side sums of each block pair go to
their own row of partials ``[B, nI, N, nf + 3]`` as ``[dcd_j, dz1_j
W1b^T]`` (the input-gradient K2: per row; K2 p: the block pair's H-wide
dz1 sums projected once), an item's i-side sums to ``[B, N, nf + 3]`` as
``[dz1_i W1a^T, dcd_i]``; a finish kernel sums the partials over the
i-blocks in order. K2 p adds dW2, dW3 and the column sums per row tile,
dW1b per block pair (h_j times its j-side dz1 sums), dW1a and db1 per item
into the slice of the block that walks the item (item ``b nI + ib`` on
block ``it % blocks``); the wrapper sums the slices in order.

``f32_blocks_fwd`` / ``f32_blocks_bwd`` emulate that schedule in plain
PyTorch: the same blocks, row tiles, padding, partial buffers and sums in
the same places. Nothing on the main path uses them. They are held against
the plain version (``allpairs_edges_plain`` / ``_plain_bwd``) at float64,
to 1e-10 of each output's largest value, and against the v3 Pallas kernels
in interpret mode at float32. The route rule, the f32 block plan and the
launch counters are checked here too; the kernels themselves run on the
card only (``chip_smoke.py``). Last, the port's flow in float32 at N=75
(past the tiled f32 K2 p's limit of 70 at nf=5, H=128) against the JAX
flow.

Inputs are made with numpy from a seed: ragged masks, a molecule with one
real atom and one with none, periodic boxes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_egcl_blocks import _torch_args
from test_torch_port_egcl_tiles import NF

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

# the tiled f32 kernels' one-molecule limits at nf=5, H=128 (the card's
# shared memory)
LARGEST = {"fwd": 142, "bwd": 519, "bwd_params": 70}
BLOCKS = 3                     # blocks of threads (parameter slices)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def f32_pair_tiles(ni, nj, diag, R):
    """The row tiles of one block pair: ``(g0, nr, li, lj, live)``, the
    block-local atoms of each computed row (``8 ceil(nr / 8)`` of them;
    padding rows take atom 0, geometry and valid 0)."""
    ncol = nj - int(diag)
    E = ni * ncol
    tiles = []
    for g0 in range(0, E, R):
        nr = min(R, E - g0)
        q = np.arange(g0, g0 + 8 * math.ceil(nr / 8))
        live = q < g0 + nr
        li = q // ncol
        jj = q - li * ncol
        lj = jj + (diag & (jj >= li))
        tiles.append((g0, nr, np.where(live, li, 0), np.where(live, lj, 0),
                      live))
    return tiles


def f32_block_schedule(N, A, R):
    """Per i-block: ``(i0, ni, [(j0, nj, tiles), ...])`` with the j-blocks
    in the order the kernels walk them."""
    blocks = [(k, min(A, N - k)) for k in range(0, N, A)]
    return [(i0, ni, [(j0, nj, f32_pair_tiles(ni, nj, i0 == j0, R))
                      for j0, nj in blocks])
            for i0, ni in blocks]


def _rows(h, pos, box, mask_f, W, gi, gj, live):
    """The forward chain of a row tile's rows for every molecule, [B, n,
    .]: z1 from h per row, as the f32 kernels make it."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    cdt, acc = h.dtype, ops._acc(h.dtype)
    gi, gj = torch.from_numpy(gi), torch.from_numpy(gj)
    lv = torch.from_numpy(live).to(acc)[None, :, None]
    cd = pos[:, gi] - pos[:, gj]
    bx = box[:, None, :]
    cd = (cd - torch.round(cd / bx) * bx) * lv
    r2 = (cd * cd).sum(-1, keepdim=True)
    mf = mask_f.to(acc)
    valid = (mf[:, gi] * mf[:, gj])[..., None] * lv
    z1 = (ops._dot(h[:, gi], W1a, cdt) + ops._dot(h[:, gj], W1b, cdt) + b1
          + r2.to(cdt) * w1r)
    m1 = ops._silu(z1)
    z2 = ops._dot(m1, W2, cdt) + b2
    m2 = ops._silu(z2) * valid.to(cdt)
    z3 = ops._dot(m2, W3, cdt) + b3
    g1 = ops._silu(z3)
    gate = ops._dot(g1, w4, acc)
    return cd, r2, valid, z1, z2, m1, m2, z3, g1, gate


def _bwd_rows(args, dagg, dfsum, gi, gj, live):
    """One row tile's backward chain: dz1, dcd and the parameter
    gradients' pieces."""
    h, pos, box, mask_f, W = args
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    cdt, acc = h.dtype, ops._acc(h.dtype)
    cd, r2, valid, z1, z2, m1, m2, z3, g1, gate = _rows(h, pos, box, mask_f,
                                                        W, gi, gj, live)
    it = torch.from_numpy(gi)
    d_trans = dfsum.to(cdt).to(acc)[:, it]
    raw = cd * gate
    inside = ((raw >= -100.0) & (raw <= 100.0)).to(acc)
    d_trans = d_trans * inside * valid
    d_gate = (cd * d_trans).sum(-1, keepdim=True)
    d_cd = gate * d_trans
    dz3 = ops._dot(d_gate.to(cdt), w4.T, cdt) * ops._dsilu(z3)
    d_m2 = (ops._dot(dz3, W3.T, cdt) + dagg.to(cdt)[:, it]) * valid.to(cdt)
    dz2 = d_m2 * ops._dsilu(z2)
    dz1 = ops._dot(dz2, W2.T, cdt) * ops._dsilu(z1)
    d_r2 = (dz1.to(acc) * w1r.to(acc)).sum(-1, keepdim=True)
    dcd = d_cd + 2.0 * cd * d_r2
    return dict(dz1=dz1.to(acc), dcd=dcd, m1=m1, m2=m2, g1=g1, dz2=dz2,
                dz3=dz3, d_gate=d_gate, r2=r2)


def _seg_sum(n, idx, T):
    """[B, n, C]: the rows of T [B, rows, C] summed by their atom idx."""
    out = torch.zeros((T.shape[0], n, T.shape[2]), dtype=T.dtype)
    return out.index_add_(1, torch.from_numpy(idx), T)


def f32_blocks_fwd(h, pos, box, mask_f, W, A, R):
    """The block-pair forward: ``(agg, f_sum)`` as ``allpairs_edges_plain``
    returns them."""
    Bm, N, _ = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = W[4].shape[1]
    sums = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    for i0, ni, pairs in f32_block_schedule(N, A, R):
        acci = torch.zeros((Bm, ni, Hd + 3), dtype=acc)
        for j0, _, tiles in pairs:
            for g0, nr, li, lj, live in tiles:
                cd, _, valid, _, _, _, m2, _, _, gate = _rows(
                    h, pos, box, mask_f, W, i0 + li, j0 + lj, live)
                trans = torch.clamp(cd * gate, -100.0, 100.0) * valid
                T = torch.cat([m2.to(acc), trans.to(acc)], dim=-1)
                acci += _seg_sum(ni, li[:nr], T[:, :nr])
        sums[:, i0:i0 + ni] = acci
    return sums[..., :Hd].to(cdt), sums[..., Hd:].to(cdt)


def f32_blocks_bwd(args, dagg, dfsum, A, R, params=False):
    """The block-pair backward: ``(dh, dpos)``, and with ``params`` the
    nine parameter gradients after them, as ``allpairs_edges_plain_bwd``
    returns them. Without ``params`` each row's vector ``[dz1 W1a^T, dcd,
    dz1 W1b^T]`` is summed (the input-gradient K2); with it the H-wide dz1
    sums are kept and projected once a block pair and once an item (K2
    p)."""
    h, pos, box, mask_f, W = args
    W1a, W1b = W[0], W[1]
    Bm, N, nf = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = W[4].shape[1]
    f = lambda t: t.to(acc)
    nI = math.ceil(N / A)
    si = torch.zeros((Bm, N, nf + 3), dtype=acc)
    pj = torch.zeros((Bm, nI, N, nf + 3), dtype=acc)
    shapes = (("dW1a", (nf, Hd)), ("dW1b", (nf, Hd)), ("dw1r", (Hd,)),
              ("db1", (Hd,)), ("dW2", (Hd, Hd)), ("db2", (Hd,)),
              ("dW3", (Hd, Hd)), ("db3", (Hd,)), ("dw4", (Hd,)))
    item = {k: torch.zeros((Bm, nI) + s, dtype=acc) for k, s in shapes}
    outer = lambda X, T: torch.einsum("brk,brn->bkn", f(X), f(T))
    hf = f(h)
    for ib, (i0, ni, pairs) in enumerate(f32_block_schedule(N, A, R)):
        add = lambda k, v: item[k][:, ib].add_(v)
        di = torch.zeros((Bm, ni, Hd if params else nf + 3), dtype=acc)
        pi = torch.zeros((Bm, ni, 3), dtype=acc)
        for j0, nj, tiles in pairs:
            dj = torch.zeros((Bm, nj, Hd if params else nf + 3), dtype=acc)
            pjb = torch.zeros((Bm, nj, 3), dtype=acc)
            for g0, nr, li, lj, live in tiles:
                r = _bwd_rows(args, dagg, dfsum, i0 + li, j0 + lj, live)
                dz1, dcd = r["dz1"], r["dcd"]
                if params:
                    di += _seg_sum(ni, li[:nr], dz1[:, :nr])
                    dj += _seg_sum(nj, lj[:nr], dz1[:, :nr])
                    pi += _seg_sum(ni, li[:nr], dcd[:, :nr])
                    pjb += _seg_sum(nj, lj[:nr], dcd[:, :nr])
                    # the slice: outer products over the tile's nr rows,
                    # column sums over its rows (the padding adds zeros)
                    add("dW3", outer(r["m2"][:, :nr], r["dz3"][:, :nr]))
                    add("dW2", outer(r["m1"][:, :nr], r["dz2"][:, :nr]))
                    add("db3", f(r["dz3"]).sum(1))
                    add("db2", f(r["dz2"]).sum(1))
                    add("dw1r", (r["r2"] * dz1).sum(1))
                    add("dw4", (f(r["g1"]) * r["d_gate"]).sum(1))
                else:
                    V = torch.cat([dz1 @ f(W1a).T, dcd, dz1 @ f(W1b).T],
                                  dim=-1)
                    di += _seg_sum(ni, li[:nr], V[:, :nr, :nf + 3])
                    dj += _seg_sum(nj, lj[:nr], V[:, :nr, nf:])
            if params:
                add("dW1b", torch.einsum("bik,bic->bkc",
                                         hf[:, j0:j0 + nj], dj))
                dj = torch.cat([pjb, dj @ f(W1b).T], dim=-1)
            pj[:, ib, j0:j0 + nj] = dj
        if params:
            add("dW1a", torch.einsum("bik,bic->bkc", hf[:, i0:i0 + ni], di))
            add("db1", di.sum(1))
            di = torch.cat([di @ f(W1a).T, pi], dim=-1)
        si[:, i0:i0 + ni] = di
    # the finish kernel: the partials summed over the i-blocks in order
    sj = torch.zeros_like(si)
    for ib in range(nI):
        sj = sj + pj[:, ib]
    out = ((si[..., :nf] + sj[..., 3:]).to(cdt), si[..., nf:] - sj[..., :3])
    if not params:
        return out
    tot = {}
    for k, v in item.items():
        flat = v.reshape((Bm * nI,) + v.shape[2:])   # items in it order
        tot[k] = torch.stack([flat[g::BLOCKS].sum(0)
                              for g in range(BLOCKS)]).sum(0)
    return out + (tot["dW1a"], tot["dW1b"], tot["dw1r"][None],
                  tot["db1"][None], tot["dW2"], tot["db2"][None], tot["dW3"],
                  tot["db3"][None], tot["dw4"][:, None])


# ---------------------------------------------------------------------------
# the schedule against the plain version and the Pallas kernels
# ---------------------------------------------------------------------------

SCHED = [(20, 8, 16), (20, 8, 40), (19, 16, 72), (13, 8, 8), (33, 16, 24)]


@pytest.mark.parametrize("N,A,R", SCHED)
def test_f32_block_schedule_visits_each_pair_once(N, A, R):
    """Every ordered pair i != j once (the walk does not depend on the
    mask); row tiles of R rows computed as a multiple of 8, padding only in
    a block pair's last tile."""
    seen = []
    for i0, ni, pairs in f32_block_schedule(N, A, R):
        for j0, nj, tiles in pairs:
            for k, (g0, nr, li, lj, live) in enumerate(tiles):
                assert g0 == k * R and (nr == R or k == len(tiles) - 1)
                assert len(li) % 8 == 0 and len(li) - nr < 8
                assert live.sum() == nr
                seen += list(zip((i0 + li[:nr]).tolist(),
                                 (j0 + lj[:nr]).tolist()))
                assert li[:nr].max() < ni and lj[:nr].max() < nj
    want = [(a, b) for a in range(N) for b in range(N) if a != b]
    assert len(seen) == len(want) and set(seen) == set(want)


@pytest.mark.parametrize("N,A,R", SCHED)
def test_f32_block_tiles_match_plain_f64(N, A, R):
    """Forward, input gradients (both backward forms) and the nine
    parameter gradients of the block schedule against the plain version at
    float64, to 1e-10 of each output's largest value."""
    args, dagg, dfsum, (_, _, _, _, mask, _, _) = _torch_args(
        N, 6, 70 + N, np.float64, 7)
    got = (f32_blocks_fwd(*args, A, R)
           + f32_blocks_bwd(args, dagg, dfsum, A, R, params=True))
    want = (ops.allpairs_edges_plain(*args)
            + ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True))
    assert len(got) == len(want) == 13
    close = lambda g, w: np.testing.assert_allclose(
        g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10 * np.abs(w.numpy()).max())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert np.abs(w.numpy()).max() > 0
        close(g, w)
    # the input-gradient form (per-row projections): the same dh, dpos
    dh, dpos = f32_blocks_bwd(args, dagg, dfsum, A, R)
    close(dh, want[2])
    close(dpos, want[3])
    # padded atoms receive nothing; the empty molecule is all zeros
    for g in got[:4]:
        assert float(g[torch.from_numpy(~mask)].abs().max()) == 0.0
        assert float(g[3].abs().max()) == 0.0


@pytest.mark.parametrize("N,A,R", [(20, 8, 16), (19, 16, 72)])
def test_f32_block_tiles_match_pallas_f32(N, A, R):
    """Against the v3 Pallas K1/K2 in interpret mode at float32: forward
    at rtol 2e-5 / atol 2e-6, the input-gradient VJP at rtol 5e-5 / atol
    5e-6 (both backward forms) and the nine parameter gradients at rtol
    5e-5 / atol 5e-6 of their largest value (test_torch_port_egcl.py's f32
    tolerances)."""
    args, dagg, dfsum, (jp, h, pos, box, mask, c_agg, c_fs) = _torch_args(
        N, 4, 90 + N, np.float32, 5)
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
    agg, fsum = f32_blocks_fwd(*args, A, R)
    dh, dpos, *pgrads = f32_blocks_bwd(args, dagg, dfsum, A, R, params=True)
    dh_in, dpos_in = f32_blocks_bwd(args, dagg, dfsum, A, R)
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
    for got, want in ((dh, jgh), (dpos, jgp), (dh_in, jgh),
                      (dpos_in, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)
    for g, w in zip(pgrads, jparams):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the route rule, the f32 block plan and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", sorted(LARGEST))
@pytest.mark.parametrize("H_", [64, 128])
def test_f32_route_rule(direction, H_):
    """float32 at H = 64 / 128: the tiled kernels to the one-molecule
    limit, the f32 block-pair kernels past it, at every N."""
    largest = LARGEST[direction]
    assert ops.route_for(largest, 5, H_, 0, direction, largest) == "f32"
    for n in (largest + 1, 2 * largest, 5000):
        assert ops.route_for(n, 5, H_, 0, direction, largest) == "f32_blocks"


@pytest.mark.parametrize("direction,fits,want", [
    # (the most atoms with 8 rows, then the most rows) at N=147; at most
    # F32_BLOCK_ATOMS (32 forward, 24 backward)
    ("fwd", {32: 64, 24: 72}, (32, 64)),
    ("bwd", {32: 72, 24: 72}, (24, 72)),
    ("bwd_params", {24: 40, 16: 40}, (24, 40)),
    ("bwd_params", {24: 0, 16: 40}, (16, 40)),
    ("bwd_params", {24: 0, 16: 0, 8: 8}, (8, 8))])
def test_f32_blocks_plan(direction, fits, want):
    A, R = ops.f32_blocks_plan(147, direction,
                               lambda a, r: r <= fits.get(a, 0))
    assert (A, R) == want
    assert A % 8 == 0 and R % 8 == 0 and R <= ops.F32_ROWS_MAX[direction]


@pytest.mark.parametrize("N,fit,A", [(143, 32, 32), (71, 32, 24),
                                     (520, 32, 32), (147, 32, 32),
                                     (561, 32, 32), (20, 32, 24)])
def test_f32_blocks_plan_balances_the_blocks(N, fit, A):
    """The plan's blocks: as few as N needs at ``fit`` atoms, of equal
    size (a multiple of 8); R a multiple of 8 that cuts a block pair's
    rows evenly."""
    got, R = ops.f32_blocks_plan(N, "fwd", lambda a, r: a <= fit)
    assert got == A and math.ceil(N / got) == math.ceil(N / fit)
    assert R == ops.tile_rows(ops.F32_ROWS_MAX["fwd"], got * got)


def test_f32_blocks_plan_refuses_when_nothing_fits():
    with pytest.raises(ValueError, match="no f32 atom block fits"):
        ops.f32_blocks_plan(147, "fwd", lambda a, r: False)


@pytest.mark.parametrize("direction,name", [
    ("fwd", "fwd_f32_blocks_launches"), ("bwd", "bwd_f32_blocks_launches"),
    ("bwd_params", "bwd_param_f32_blocks_launches")])
def test_f32_blocks_count_on_their_own_counter(direction, name):
    ops.counts.reset()
    ops._count(direction, 128, "f32_blocks")
    got = {k: v for k, v in vars(ops.counts).items()
           if not k.startswith("_") and v}
    assert got == {name: 1}
    ops.counts.reset()


def test_f32_blocks_launch_failure_names_the_route():
    class Lib:
        def egcl_f32_error_string(self, err):
            return b"invalid argument"
    with pytest.raises(RuntimeError, match="invalid argument.*f32_blocks"):
        ops._raise_on(Lib(), 1, "forward", (2, 147, 5, 128), "f32_blocks")


def test_blocks_entry_point_takes_cuda_tensors_only_f32():
    args, dagg, dfsum, _ = _torch_args(8, 4, 1, np.float32, 3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.allpairs_edges_blocks("bwd_params", *args, dagg, dfsum)


# ---------------------------------------------------------------------------
# the slice as a whole: the f32 flow past the one-molecule limit
# ---------------------------------------------------------------------------

FLOW_N, FLOW_B, FLOW_NF, FLOW_H = 75, 2, 5, 16


def test_f32_flow_past_the_tiled_limit_matches_jax():
    """The port's flow log-density (reverse, 2 LF steps, all pairs,
    float32) and its gradient in the positions and every parameter at
    N=75, the size the f32 block-pair K2 p serves on the card, against the
    JAX flow in float32 (rtol 1e-4 of each array's largest value: float32
    round-off over 75 atoms)."""
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(FLOW_NF, FLOW_H), **kw)
    # the port's EGCLs through the kernel's contract (on the CPU its plain
    # version), JAX's on XLA
    tcfg = FlowConfig(egcl=EGCLConfig(FLOW_NF, FLOW_H, use_pallas="v3"),
                      **kw)
    jp = j_init_flow(jax.random.PRNGKey(5), jcfg, jnp.float32)
    rng = np.random.default_rng(75)
    mask = np.ones((FLOW_B, FLOW_N), bool)
    mask[1, -9:] = False
    f32 = lambda a: a.astype(np.float32)
    arrs = {"h": f32(rng.normal(size=(FLOW_B, FLOW_N, FLOW_NF))),
            "g": f32(rng.normal(size=(FLOW_B, FLOW_N, FLOW_NF))),
            "pos": f32(rng.normal(size=(FLOW_B, FLOW_N, 3)) * 1.8),
            "vel": f32(rng.normal(size=(FLOW_B, FLOW_N, 3)))}
    for a in arrs.values():
        a[~mask] = 0.0
    box = np.full((FLOW_B, 3), 1e3, np.float32)
    r_cut = np.full((FLOW_B,), 1e2, np.float32)
    c_pos = f32(rng.normal(size=(FLOW_B, FLOW_N, 3)))

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
        assert leaf.dtype == torch.float32
        leaf.requires_grad_(True)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    pos = t(arrs["pos"]).requires_grad_(True)
    tsys = System(mask=t(mask), box=t(box), r_cut=t(r_cut), h=t(arrs["h"]),
                  g=t(arrs["g"]), pos=pos, vel=t(arrs["vel"]))
    ops.counts.reset()
    out, ldj = reverse_core(tp, tcfg, tsys)
    (ldj.sum() + (out.pos * t(c_pos)).sum()).backward()
    # the kernel's plain version ran (a CPU tensor), forward and backward
    assert ops.counts.plain_fwd_calls > 0
    assert ops.counts.plain_bwd_param_calls > 0

    close = lambda g, w: np.testing.assert_allclose(
        g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    close(ldj.detach().numpy(), np.asarray(jldj))
    close(pos.grad.numpy(), np.asarray(jgpos))
    jleaves = jax.tree_util.tree_leaves(jgp)
    assert len(jleaves) == len(leaves)
    for g, w in zip(leaves, jleaves):
        got = g.grad if g.grad is not None else torch.zeros_like(g)
        close(got.numpy(), np.asarray(w))

"""Port parity: the row schedule of the tiled f32 all-pairs EGCL kernels.

``csrc/egcl_allpairs_f32.cu`` (f32 K1 and K2 with parameter gradients at
H = 64 or 128) walks, per block, molecule tiles ``b, b + blocks, ...`` of
``mt`` whole molecules (``ops.f32_grid``), each tile's ``nm N(N-1)`` rows
i != j (i-major) in row tiles of ``rows`` rows (``ops.tile_rows``,
``ops.row_tiles``) computed as a multiple of 8 with the padding masked. A
row tile may span several molecules and a molecule may straddle two row
tiles; the node sums (agg; dz1 and dcd on the i side and on the j side)
are kept per molecule tile across its row tiles. The parameter gradients
go per block into one slice: dW2 = m1^T dz2 and dW3 = m2^T dz3 over each
row tile's rows, the column sums db2, db3, dw1r and dw4 over its rows,
and once a molecule tile dW1a, dW1b and db1 from the node sums of dz1;
the wrapper sums the slices in block order. ``f32_fwd`` and
``f32_bwd_params`` below emulate that schedule in plain PyTorch (the same
tiles, rows, padding and sums in the same places); nothing on the main
path uses them. They are held against

- the plain version of the contract (``allpairs_edges_plain`` /
  ``allpairs_edges_plain_bwd``) at float64, to 1e-10 of each output's
  largest value: the two differ only by the order of the sums;
- the v3 Pallas kernels (``enflow_tpu/ops/egcl_fused_v3.py``) in interpret
  mode at float32: the forward, the input-gradient VJP and the parameter
  gradients, at the tolerances of ``test_torch_port_egcl.py``.

Cases: N in {2, 4, 13, 22} (nf 5, 2, 5, 4: LJ, DW4, LJ13, alanine
dipeptide), each at the kernels' largest row tile and at 16 rows a tile
(molecules straddling row tiles); B = 7 molecules over 3 blocks (not a
multiple of the molecules a tile holds), ragged masks, a molecule with
one real atom and one with none, periodic boxes. Inputs are made with
numpy from a seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3

from enflow_tpu_torch.ops import egcl_allpairs as ops

H, B, N_SM = 16, 7, 3
NF = {2: 5, 4: 2, 13: 5, 22: 4}
NS = tuple(NF)
FITS = (None, 16)       # the kernels' largest row tile, and 16 rows


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def plan(Bm, N, direction, fit=None):
    """``(molecules a tile, blocks, rows a row tile)`` as the wrapper
    chooses them on ``N_SM`` multiprocessors, with at most ``fit`` rows a
    row tile (the largest the kernel takes by default)."""
    mt, blocks = ops.f32_grid(Bm, N, N_SM, direction)
    fit = fit or ops.F32_ROWS_MAX[direction]
    return mt, blocks, ops.tile_rows(fit, mt * N * (N - 1))


def _rows(N, g0, nr):
    """(local molecule, i, j, live) of a row tile's rows, computed as a
    multiple of 8; padding rows take atom 0 of the tile's first
    molecule."""
    E = N * (N - 1)
    g = np.arange(g0, g0 + 8 * math.ceil(nr / 8))
    live = g < g0 + nr
    m = g // E
    q = g - m * E
    i = q // (N - 1)
    jj = q - i * (N - 1)
    j = jj + (jj >= i)
    zero = lambda a: np.where(live, a, 0)
    return zero(m), zero(i), zero(j), live


def _chain(h, pos, box, mask_f, W, mol, i, j, live):
    """The forward chain of a row tile's rows (molecule mol, atoms i and
    j; padding rows with geometry and valid 0)."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    cdt, acc = h.dtype, ops._acc(h.dtype)
    mol, i, j = (torch.from_numpy(a) for a in (mol, i, j))
    lv = torch.from_numpy(live).to(acc)[:, None]
    cd = pos[mol, i] - pos[mol, j]
    bx = box[mol]
    cd = (cd - torch.round(cd / bx) * bx) * lv
    r2 = (cd * cd).sum(-1, keepdim=True)
    valid = (mask_f[mol, i] * mask_f[mol, j]).to(acc)[:, None] * lv
    z1 = (ops._dot(h[mol, i], W1a, cdt) + ops._dot(h[mol, j], W1b, cdt)
          + b1 + r2.to(cdt) * w1r)
    m1 = ops._silu(z1)
    z2 = ops._dot(m1, W2, cdt) + b2
    m2 = ops._silu(z2) * valid.to(cdt)
    z3 = ops._dot(m2, W3, cdt) + b3
    g1 = ops._silu(z3)
    gate = ops._dot(g1, w4, acc)
    return cd, r2, valid, z1, z2, m1, m2, z3, g1, gate


def _tile_sum(n, idx, T):
    """[n, C]: the rows of T summed by their atom idx (one tile's part)."""
    return torch.zeros((n, T.shape[1]), dtype=T.dtype).index_add_(
        0, torch.from_numpy(idx), T)


def f32_fwd(h, pos, box, mask_f, W, fit=None):
    """The forward schedule: ``(agg, f_sum)`` as ``allpairs_edges_plain``
    returns them."""
    Bm, N, _ = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = W[4].shape[1]
    mt, blocks, rows = plan(Bm, N, "fwd", fit)
    agg = torch.zeros((Bm, N, Hd), dtype=cdt)
    fsum = torch.zeros((Bm, N, 3), dtype=cdt)
    for tiles in ops.row_tiles(Bm, N, mt, blocks, rows):
        for b0, nm, g0, nr in tiles:
            if g0 == 0:
                sums = torch.zeros((nm * N, Hd + 3), dtype=acc)
            m, i, j, live = _rows(N, g0, nr)
            cd, _, valid, _, _, _, m2, _, _, gate = _chain(
                h, pos, box, mask_f, W, b0 + m, i, j, live)
            trans = (torch.clamp(cd * gate, -100.0, 100.0) * valid).to(cdt)
            T = torch.cat([m2.to(acc), trans.to(acc)], dim=-1)[:nr]
            sums += _tile_sum(nm * N, (m * N + i)[:nr], T)
            if g0 + nr == nm * N * (N - 1):
                agg[b0:b0 + nm] = sums[:, :Hd].view(nm, N, Hd).to(cdt)
                fsum[b0:b0 + nm] = sums[:, Hd:].view(nm, N, 3).to(cdt)
    return agg, fsum


def f32_bwd_params(h, pos, box, mask_f, W, dagg, dfsum, fit=None):
    """The parameter-gradient backward's schedule: ``(dh, dpos, dW1a,
    dW1b, dw1r, db1, dW2, db2, dW3, db3, dw4)`` as
    ``allpairs_edges_plain_bwd(..., params=True)`` returns them."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    Bm, N, nf = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = W2.shape[1]
    mt, blocks, rows = plan(Bm, N, "bwd_params", fit)
    dh = torch.zeros((Bm, N, nf), dtype=cdt)
    dpos = torch.zeros((Bm, N, 3), dtype=acc)
    shapes = {"dW1a": (nf, Hd), "dW1b": (nf, Hd), "dw1r": (Hd,),
              "db1": (Hd,), "dW2": (Hd, Hd), "db2": (Hd,), "dW3": (Hd, Hd),
              "db3": (Hd,), "dw4": (Hd,)}
    slices = []
    f = lambda t: t.to(acc)
    for tiles in ops.row_tiles(Bm, N, mt, blocks, rows):
        sl = {k: torch.zeros(s, dtype=acc) for k, s in shapes.items()}
        for b0, nm, g0, nr in tiles:
            if g0 == 0:
                si = torch.zeros((nm * N, Hd + 3), dtype=acc)
                sj = torch.zeros((nm * N, Hd + 3), dtype=acc)
            m, i, j, live = _rows(N, g0, nr)
            cd, r2, valid, z1, z2, m1, m2, z3, g1, gate = _chain(
                h, pos, box, mask_f, W, b0 + m, i, j, live)
            mol, it = torch.from_numpy(b0 + m), torch.from_numpy(i)
            d_trans = dfsum.to(cdt).to(acc)[mol, it]
            raw = cd * gate
            inside = ((raw >= -100.0) & (raw <= 100.0)).to(acc)
            d_trans = d_trans * inside * valid
            d_gate = (cd * d_trans).sum(-1, keepdim=True)
            d_cd = gate * d_trans
            dz3 = ops._dot(d_gate.to(cdt), w4.T, cdt) * ops._dsilu(z3)
            d_m2 = ((ops._dot(dz3, W3.T, cdt) + dagg.to(cdt)[mol, it])
                    * valid.to(cdt))
            dz2 = d_m2 * ops._dsilu(z2)
            dz1 = ops._dot(dz2, W2.T, cdt) * ops._dsilu(z1)
            d_r2 = (f(dz1) * f(w1r)).sum(-1, keepdim=True)
            dcd = (d_cd + 2.0 * cd * d_r2).to(cdt)
            # the block's slice: outer products over the tile's nr rows,
            # column sums over its rows (the padding adds zeros)
            sl["dW3"] += f(m2[:nr]).T @ f(dz3[:nr])
            sl["dW2"] += f(m1[:nr]).T @ f(dz2[:nr])
            sl["db3"] += f(dz3).sum(0)
            sl["db2"] += f(dz2).sum(0)
            sl["dw1r"] += (r2 * f(dz1)).sum(0)
            sl["dw4"] += (f(g1) * d_gate).sum(0)
            T = torch.cat([f(dz1), f(dcd)], dim=-1)[:nr]
            si += _tile_sum(nm * N, (m * N + i)[:nr], T)
            sj += _tile_sum(nm * N, (m * N + j)[:nr], T)
            if g0 + nr == nm * N * (N - 1):
                hm = f(h[b0:b0 + nm].reshape(nm * N, nf))
                dh[b0:b0 + nm] = (
                    ops._dot(si[:, :Hd].to(cdt), W1a.T, acc)
                    + ops._dot(sj[:, :Hd].to(cdt), W1b.T, acc)
                ).view(nm, N, nf).to(cdt)
                dpos[b0:b0 + nm] = (si[:, Hd:] - sj[:, Hd:]).view(nm, N, 3)
                sl["dW1a"] += hm.T @ si[:, :Hd]
                sl["dW1b"] += hm.T @ sj[:, :Hd]
                sl["db1"] += si[:, :Hd].sum(0)
        slices.append(sl)
    tot = {k: torch.stack([sl[k] for sl in slices]).sum(0) for k in shapes}
    return (dh, dpos, tot["dW1a"], tot["dW1b"], tot["dw1r"][None],
            tot["db1"][None], tot["dW2"], tot["db2"][None], tot["dW3"],
            tot["db3"][None], tot["dw4"][:, None])


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _inputs(N, seed, dtype):
    """h, pos, box, mask for B molecules: molecule 0 full, 1 with a padded
    tail, 2 with one real atom, 3 with none, the rest ragged at random;
    periodic boxes for odd molecules."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), bool)
    mask[1, N - max(1, N // 3):] = False
    mask[2, 1:] = False
    mask[3, :] = False
    for b in range(4, B):
        mask[b] = rng.uniform(size=N) > 0.25
    h = rng.normal(size=(B, N, NF[N]))
    pos = rng.normal(size=(B, N, 3)) * 1.3
    box = np.full((B, 3), 1e3)
    box[1::2] = 2.5
    pos[1::2] = rng.uniform(-3.0, 3.0, size=pos[1::2].shape)
    h[~mask] = 0.0
    pos[~mask] = 0.0
    return (h.astype(dtype), pos.astype(dtype), box.astype(dtype), mask)


def _weights(nf, seed):
    jp = j_init_egcl(jax.random.PRNGKey(seed), JEGCLConfig(nf, H),
                     jnp.float32)
    return jp, [np.array(x) for x in (
        jp["edge_nn"][0]["w"], jp["edge_nn"][0]["b"], jp["edge_nn"][1]["w"],
        jp["edge_nn"][1]["b"], jp["coord_nn"][0]["w"], jp["coord_nn"][0]["b"],
        jp["coord_nn"][1]["w"])]


def _torch_weights(leaves, nf, dtype):
    W1, b1, W2, b2, W3, b3, w4 = [torch.from_numpy(x).to(dtype)
                                  for x in leaves]
    W1a, W1b, w1r, b1r = ops.split_params(W1, b1, nf)
    return (W1a, W1b, w1r, b1r, W2, b2[None], W3, b3[None], w4)


def _args(N, seed, dtype, wseed):
    h, pos, box, mask = _inputs(N, seed, dtype)
    jp, leaves = _weights(NF[N], wseed)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    t = lambda a: torch.from_numpy(np.asarray(a))
    args = (t(h), t(pos), t(box), t(mask).to(tdt),
            _torch_weights(leaves, NF[N], tdt))
    rng = np.random.default_rng(seed + 1000)
    c_agg = rng.normal(size=(B, N, H)).astype(dtype)
    c_fs = rng.normal(size=(B, N, 3)).astype(dtype)
    return args, (h, pos, box, mask), jp, c_agg, c_fs


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fit", FITS)
@pytest.mark.parametrize("direction", ("fwd", "bwd_params"))
@pytest.mark.parametrize("N", NS)
def test_schedule_visits_each_pair_once(N, direction, fit):
    """Every pair i != j of every molecule once, in i-major order, through
    whole molecule tiles spread over the blocks; row tiles of at most
    ``rows`` rows computed as a multiple of 8 within the kernel's
    largest; at least one molecule tile of several molecules or one row
    tile that a molecule straddles where the shape makes one."""
    mt, blocks, rows = plan(B, N, direction, fit)
    assert rows % 8 == 0 and 8 <= rows <= ops.F32_ROWS_MAX[direction]
    assert blocks == min(math.ceil(B / mt), N_SM)
    E = N * (N - 1)
    seen, straddle = [], False
    tiles = ops.row_tiles(B, N, mt, blocks, rows)
    assert [t[0][0] for t in tiles] == [k * mt for k in range(blocks)]
    for block in tiles:
        for b0, nm, g0, nr in block:
            assert 0 < nr <= rows and g0 % rows == 0
            m, i, j, live = _rows(N, g0, nr)
            assert live.sum() == nr and len(live) <= rows
            seen += list(zip((b0 + m[:nr]).tolist(), i[:nr].tolist(),
                             j[:nr].tolist()))
            straddle |= g0 % E != 0 or (g0 + nr) % E != 0
    want = [(b, a, c) for b in range(B) for a in range(N) for c in range(N)
            if a != c]
    assert sorted(seen) == want and len(seen) == len(want)
    if mt * E > rows and rows % E:
        assert straddle


def test_plan_at_the_committed_shapes():
    """vi_dw4.yaml (B=512, N=4) packs 4 molecules a tile, one tile a
    block, over 128 of 132 multiprocessors; vi_ala2.yaml (B=256, N=22)
    takes one molecule a tile, 462 rows in 40-row tiles (the last 22);
    N=1 is one empty row tile a molecule tile."""
    assert ops.f32_grid(512, 4, 132, "fwd") == (4, 128)
    assert ops.f32_grid(512, 4, 132, "bwd_params") == (4, 128)
    assert ops.tile_rows(72, 48) == 48 and ops.tile_rows(40, 48) == 24
    assert ops.f32_grid(256, 22, 132, "bwd_params") == (1, 132)
    assert ops.tile_rows(40, 462) == 40
    tiles = ops.row_tiles(256, 22, 1, 132, 40)
    assert [len(t) for t in tiles] == [24] * 124 + [12] * 8
    assert tiles[0][:12][-1] == (0, 1, 440, 22)
    assert ops.row_tiles(5, 1, 2, 2, 8) == [[(0, 2, 0, 0), (4, 1, 0, 0)],
                                            [(2, 2, 0, 0)]]


def test_size_rule():
    """float32 at H = 64 / 128: the tiled kernels for K1, K2 and K2 p;
    bf16 there the Hopper kernels; H = 96 the same on the padded width
    128; at 192 / 256 each dtype's block pairs with streamed weights."""
    for H_ in (64, 128):
        assert [ops.kernel_for(0, H_, d) for d in ("fwd", "bwd",
                                                    "bwd_params")] == [
            "f32", "f32", "f32"]
        assert {ops.kernel_for(1, H_, d) for d in ("fwd", "bwd",
                                                    "bwd_params")} == {"sm90"}
    assert [{ops.kernel_for(c, 96, d) for d in ("fwd", "bwd", "bwd_params")}
            for c in (0, 1)] == [{"f32"}, {"sm90"}]
    assert [{ops.kernel_for(c, H_, d) for H_ in (160, 192, 256)
             for d in ("fwd", "bwd", "bwd_params")}
            for c in (0, 1)] == [{"f32_wide"}, {"wide"}]


@pytest.mark.parametrize("fit", FITS)
@pytest.mark.parametrize("N", NS)
def test_f32_tiles_match_plain_f64(N, fit):
    """Forward and parameter-gradient backward schedules against the plain
    version at float64: every output to 1e-10 of its largest value."""
    args, (_, _, _, mask), _, dagg, dfsum = _args(N, 700 + N, np.float64, 3)
    t = lambda a: torch.from_numpy(a)
    got = (f32_fwd(*args, fit=fit)
           + f32_bwd_params(*args, t(dagg), t(dfsum), fit=fit))
    want = (ops.allpairs_edges_plain(*args)
            + ops.allpairs_edges_plain_bwd(*args, t(dagg), t(dfsum),
                                           params=True))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        w = w.numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
    # padded atoms receive nothing; the empty molecule is all zeros
    for g in got[:2] + got[2:4]:
        assert float(g[torch.from_numpy(~mask)].abs().max()) == 0.0
        assert float(g[3].abs().max()) == 0.0


def _pallas(jp, h, pos, box, mask, c_agg, c_fs):
    jh, jpos = jnp.asarray(h), jnp.asarray(pos)
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def run(p, hh, pp):
        a, f, _ = fused_allpairs_edges_v3(p, hh, pp, jbox, jmask, mol_tile=4)
        return a, f

    def loss(p, hh, pp):
        a, f = run(p, hh, pp)
        return (a * c_agg).sum() + (f * c_fs).sum()

    return run(jp, jh, jpos), jax.grad(loss, argnums=(0, 1, 2))(jp, jh, jpos)


@pytest.mark.parametrize("N", NS)
def test_f32_tiles_match_pallas_f32(N):
    """Against K1 and K2 in interpret mode at float32: the forward at rtol
    2e-5 / atol 2e-6 and the input-gradient VJP (dh, dpos of the
    parameter-gradient schedule) at rtol 5e-5 / atol 5e-6, the f32
    tolerances of test_torch_port_egcl.py; the row tiles at 16 rows, so
    that molecules straddle them."""
    args, raw, jp, c_agg, c_fs = _args(N, 800 + N, np.float32, 5)
    (ja, jf), (_, jgh, jgp) = _pallas(jp, *raw, c_agg, c_fs)
    t = lambda a: torch.from_numpy(a)
    agg, fsum = f32_fwd(*args, fit=16)
    dh, dpos = f32_bwd_params(*args, t(c_agg), t(c_fs), fit=16)[:2]
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
    for got, want in ((dh, jgh), (dpos, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("N", NS)
def test_f32_param_tiles_match_pallas_f32(N):
    """The nine parameter gradients of the schedule (the kernel's largest
    row tiles) against the v3 Pallas kernel's VJP in interpret mode at
    float32, at the tolerances of
    test_torch_port_egcl.py::test_param_grads_match_pallas_f32."""
    args, raw, jp, c_agg, c_fs = _args(N, 900 + N, np.float32, 11)
    _, (jg, _, _) = _pallas(jp, *raw, c_agg, c_fs)
    nf = NF[N]
    W1 = np.asarray(jg["edge_nn"][0]["w"])
    want = [W1[:nf], W1[nf:2 * nf], W1[2 * nf:2 * nf + 1],
            np.asarray(jg["edge_nn"][0]["b"])[None],
            np.asarray(jg["edge_nn"][1]["w"]),
            np.asarray(jg["edge_nn"][1]["b"])[None],
            np.asarray(jg["coord_nn"][0]["w"]),
            np.asarray(jg["coord_nn"][0]["b"])[None],
            np.asarray(jg["coord_nn"][1]["w"])]
    t = lambda a: torch.from_numpy(a)
    got = f32_bwd_params(*args, t(c_agg), t(c_fs))[2:]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())

"""Port parity: the row schedule of the bf16 Hopper all-pairs EGCL kernels.

``csrc/egcl_allpairs_sm90.cu`` visits only the N(N-1) edge rows i != j of a
molecule, i-major (row q: i = q // (N-1), j the (q % (N-1))-th atom other
than i), in 64-row tiles, and takes every node sum as a product S T of the
tile's rows T with a 0/1 matrix S that marks which rows belong to which
atom: agg and the force sums on the i side, and in the backward dz1 and
dcd on the i side and on the j side. ``tiled_fwd`` / ``tiled_bwd`` below
emulate that schedule in plain PyTorch (the same rows, tiles, segment
boundaries and sums in the same places), and ``tiled_bwd_params`` that of
the parameter-gradient variant (per-tile outer products, column sums as
rows of ones or of the f32 row weights times a tile, dW1a / dW1b from the
node sums, per-slice partials summed in the wrapper's order); nothing on
the main path uses them. They are held against

- the plain version of the contract (``allpairs_edges_plain`` /
  ``allpairs_edges_plain_bwd``, all edges [B, N, N] with the self-pairs
  masked) at float64, to 1e-10 of each output's largest value: the two
  differ only by the order of the sums;
- the v3 Pallas kernels K1/K2 (``enflow_tpu/ops/egcl_fused_v3.py``) in
  interpret mode at float32, forward, input-gradient VJP and parameter
  gradients, at the tolerances of ``test_torch_port_egcl.py``.

Cases: N in {2, 11, 13, 30} (the parameter gradients at f64 also 55);
B = 7 (not a multiple of any molecule's tile count > 1) with ragged
masks, a molecule with one real atom and one with none. Inputs are made
with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3

from enflow_tpu_torch.ops import egcl_allpairs as ops

NF, H, B = 4, 16, 7
TILE = 64                      # rows per tile (the kernels' wgmma M)
NS = (2, 11, 13, 30)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def schedule(N):
    """Per tile: (row0, nr, i [64], j [64]) for the rows row0 ..
    row0+nr-1 of a molecule; rows past nr are padding (atoms 0)."""
    E = N * (N - 1)
    tiles = []
    for row0 in range(0, E, TILE):
        q = np.arange(row0, row0 + TILE)
        nr = min(TILE, E - row0)
        i = q // (N - 1)
        jj = q - i * (N - 1)
        j = jj + (jj >= i)
        live = q < E
        tiles.append((row0, nr, np.where(live, i, 0), np.where(live, j, 0)))
    return tiles


def _seg_matrix(seg, nr, base, n, dtype):
    """S [n, 64]: S[s, r] = 1 where row r < nr belongs to atom base + s."""
    s = torch.zeros((n, TILE), dtype=dtype)
    for r in range(nr):
        a = int(seg[r]) - base
        if 0 <= a < n:
            s[a, r] = 1.0
    return s


def _rows(h, pos, box, mask_f, weights, i, j, nr=TILE):
    """The forward chain of one tile's rows for every molecule: the
    kernels' rounding points (``_fwd_block``), [B, 64, .]. Rows from nr on
    are padding: geometry and valid 0, as the kernels set them."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    cdt, acc = h.dtype, ops._acc(h.dtype)
    i, j = torch.from_numpy(i), torch.from_numpy(j)
    live = (torch.arange(TILE) < nr).to(acc)[None, :, None]
    cd = pos[:, i] - pos[:, j]
    bx = box[:, None, :]
    cd = (cd - torch.round(cd / bx) * bx) * live
    r2 = (cd * cd).sum(-1, keepdim=True)
    mf = mask_f.to(acc)
    valid = (mf[:, i] * mf[:, j])[..., None] * live
    validc = valid.to(cdt)
    zi = ops._dot(h, W1a, cdt)[:, i]
    zj = ops._dot(h, W1b, cdt)[:, j]
    z1 = zi + zj + b1 + r2.to(cdt) * w1r
    m1 = ops._silu(z1)
    z2 = ops._dot(m1, W2, cdt) + b2
    m2 = ops._silu(z2) * validc
    z3 = ops._dot(m2, W3, cdt) + b3
    gate = ops._dot(ops._silu(z3), w4, acc)
    return cd, valid, validc, z1, z2, m2, z3, gate


def _sum_into(acc, T, seg, nr, base, n):
    """acc[:, base + s] += (S T)[:, s] for the n atoms from base."""
    S = _seg_matrix(seg, nr, base, n, T.dtype)
    acc[:, base:base + n] += torch.einsum("sr,brc->bsc", S, T)


def tiled_fwd(h, pos, box, mask_f, weights):
    """The kernels' forward schedule: ``(agg, f_sum)`` as
    ``allpairs_edges_plain`` returns them."""
    Bm, N, _ = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = weights[4].shape[1]
    sums = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    for row0, nr, i, j in schedule(N):
        cd, valid, _, _, _, m2, _, gate = _rows(h, pos, box, mask_f, weights,
                                                i, j)
        trans = (torch.clamp(cd * gate, -100.0, 100.0) * valid).to(cdt)
        T = torch.cat([m2.to(acc), trans.to(acc)], dim=-1)
        i0 = row0 // (N - 1)
        ns = (row0 + nr - 1) // (N - 1) - i0 + 1
        _sum_into(sums, T, i, nr, i0, ns)
    return sums[..., :Hd].to(cdt), sums[..., Hd:].to(cdt)


def tiled_bwd(h, pos, box, mask_f, weights, dagg, dfsum):
    """The kernels' input-gradient schedule: ``(dh, dpos)`` as
    ``allpairs_edges_plain_bwd`` returns them."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    Bm, N, _ = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = W2.shape[1]
    si = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    sj = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    for row0, nr, i, j in schedule(N):
        cd, valid, validc, z1, z2, _, z3, gate = _rows(
            h, pos, box, mask_f, weights, i, j)
        it = torch.from_numpy(i)
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
        i0 = row0 // (N - 1)
        ns = (row0 + nr - 1) // (N - 1) - i0 + 1
        _sum_into(si, T, i, nr, i0, ns)
        for jb in range(0, N, TILE):
            _sum_into(sj, T, j, nr, jb, min(TILE, N - jb))
    dh = (ops._dot(si[..., :Hd].to(cdt), W1a.T, acc)
          + ops._dot(sj[..., :Hd].to(cdt), W1b.T, acc)).to(cdt)
    return dh, si[..., Hd:] - sj[..., Hd:]


SLICES = 3                     # partial slices (the kernel: one per warpgroup)


def tiled_bwd_params(h, pos, box, mask_f, weights, dagg, dfsum):
    """The parameter-gradient kernel's schedule: ``(dh, dpos, dW1a, dW1b,
    dw1r, db1, dW2, db2, dW3, db3, dw4)`` as ``allpairs_edges_plain_bwd(...,
    params=True)`` returns them. Per tile: the outer products m1^T dz2 and
    m2^T dz3 over its 64 rows, the column sums of dz3, dz2 and dz1 as a row
    of ones times the tile, dw1r and dw4 as the rows of r2 and dgate times
    the dz1 and g1 tiles; per molecule dW1a and dW1b as h times the node
    sums of dz1. Molecule b adds into slice b % SLICES (a warpgroup's
    grid-stride walk), and the slices are summed in order, as the
    wrapper sums them."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    Bm, N, nf = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    Hd = W2.shape[1]
    si = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    sj = torch.zeros((Bm, N, Hd + 3), dtype=acc)
    mol = {k: torch.zeros((Bm,) + shape, dtype=acc) for k, shape in (
        ("dW2", (Hd, Hd)), ("dW3", (Hd, Hd)), ("dw1r", (Hd,)),
        ("db1", (Hd,)), ("db2", (Hd,)), ("db3", (Hd,)), ("dw4", (Hd,)))}
    ones = torch.ones((1, TILE), dtype=acc)
    colsum = lambda w, T: torch.einsum("sr,brc->bc", w, T.to(acc))
    wsum = lambda w, T: torch.einsum("br,brc->bc", w[..., 0], T.to(acc))
    outer = lambda A, T: torch.einsum("brk,brn->bkn", A.to(acc), T.to(acc))
    for row0, nr, i, j in schedule(N):
        cd, valid, validc, z1, z2, m2, z3, gate = _rows(
            h, pos, box, mask_f, weights, i, j, nr)
        it = torch.from_numpy(i)
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
        i0 = row0 // (N - 1)
        ns = (row0 + nr - 1) // (N - 1) - i0 + 1
        _sum_into(si, T, i, nr, i0, ns)
        for jb in range(0, N, TILE):
            _sum_into(sj, T, j, nr, jb, min(TILE, N - jb))
        mol["dW3"] += outer(m2, dz3)
        mol["db3"] += colsum(ones, dz3)
        mol["dw4"] += wsum(d_gate, ops._silu(z3))
        mol["db2"] += colsum(ones, dz2)
        mol["dW2"] += outer(ops._silu(z1), dz2)
        mol["db1"] += colsum(ones, dz1)
        mol["dw1r"] += wsum(r2, dz1)
    hf = h.to(acc)
    mol["dW1a"] = torch.einsum("bik,bic->bkc", hf, si[..., :Hd])
    mol["dW1b"] = torch.einsum("bik,bic->bkc", hf, sj[..., :Hd])
    tot = {}
    for k, v in mol.items():
        part = torch.stack([v[g::SLICES].sum(0) for g in range(SLICES)])
        tot[k] = part.sum(0)
    dh = (ops._dot(si[..., :Hd].to(cdt), W1a.T, acc)
          + ops._dot(sj[..., :Hd].to(cdt), W1b.T, acc)).to(cdt)
    return (dh, si[..., Hd:] - sj[..., Hd:], tot["dW1a"], tot["dW1b"],
            tot["dw1r"][None], tot["db1"][None], tot["dW2"],
            tot["db2"][None], tot["dW3"], tot["db3"][None],
            tot["dw4"][:, None])


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
    h = rng.normal(size=(B, N, NF))
    pos = rng.normal(size=(B, N, 3)) * 1.3
    box = np.full((B, 3), 1e3)
    box[1::2] = 2.5
    pos[1::2] = rng.uniform(-3.0, 3.0, size=pos[1::2].shape)
    h[~mask] = 0.0
    pos[~mask] = 0.0
    return (h.astype(dtype), pos.astype(dtype), box.astype(dtype), mask)


def _weights(seed):
    jp = j_init_egcl(jax.random.PRNGKey(seed), JEGCLConfig(NF, H),
                     jnp.float32)
    return jp, [np.array(x) for x in (
        jp["edge_nn"][0]["w"], jp["edge_nn"][0]["b"], jp["edge_nn"][1]["w"],
        jp["edge_nn"][1]["b"], jp["coord_nn"][0]["w"], jp["coord_nn"][0]["b"],
        jp["coord_nn"][1]["w"])]


def _torch_weights(leaves, dtype):
    W1, b1, W2, b2, W3, b3, w4 = [torch.from_numpy(x).to(dtype)
                                  for x in leaves]
    W1a, W1b, w1r, b1r = ops.split_params(W1, b1, NF)
    return (W1a, W1b, w1r, b1r, W2, b2[None], W3, b3[None], w4)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", NS)
def test_schedule_visits_each_pair_once(N):
    """Every pair i != j once, in i-major order, each tile's i-side
    segments inside the 64 rows of S, padding only in the last tile."""
    tiles = schedule(N)
    seen = []
    for k, (row0, nr, i, j) in enumerate(tiles):
        assert row0 == k * TILE and (nr == TILE or k == len(tiles) - 1)
        seen += list(zip(i[:nr].tolist(), j[:nr].tolist()))
        ns = (row0 + nr - 1) // (N - 1) - row0 // (N - 1) + 1
        assert 1 <= ns <= TILE
        assert set(i[:nr]) == set(range(row0 // (N - 1),
                                         row0 // (N - 1) + ns))
    want = [(a, b) for a in range(N) for b in range(N) if a != b]
    assert seen == want


@pytest.mark.parametrize("N", NS)
def test_tiles_match_plain_f64(N):
    h, pos, box, mask = _inputs(N, seed=N, dtype=np.float64)
    _, leaves = _weights(7)
    W = _torch_weights(leaves, torch.float64)
    t = lambda a: torch.from_numpy(np.asarray(a))
    args = (t(h), t(pos), t(box), t(mask).to(torch.float64), W)
    rng = np.random.default_rng(100 + N)
    dagg = t(rng.normal(size=(B, N, H)))
    dfsum = t(rng.normal(size=(B, N, 3)))
    got = tiled_fwd(*args) + tiled_bwd(*args, dagg, dfsum)
    want = (ops.allpairs_edges_plain(*args)
            + ops.allpairs_edges_plain_bwd(*args, dagg, dfsum))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
    # padded atoms receive nothing; the empty molecule is all zeros
    pad = ~mask
    for g in got:
        assert float(g[torch.from_numpy(pad)].abs().max()) == 0.0
    assert all(float(g[3].abs().max()) == 0.0 for g in got)


@pytest.mark.parametrize("N", NS)
def test_tiles_match_pallas_f32(N):
    """Against K1/K2 in interpret mode: forward at rtol 2e-5 / atol 2e-6,
    the input-gradient VJP at rtol 5e-5 / atol 5e-6 (test_torch_port_egcl's
    f32 tolerances)."""
    h, pos, box, mask = _inputs(N, seed=N, dtype=np.float32)
    jp, leaves = _weights(5)
    rng = np.random.default_rng(200 + N)
    c_agg = rng.normal(size=(B, N, H)).astype(np.float32)
    c_fs = rng.normal(size=(B, N, 3)).astype(np.float32)
    jh, jpos = jnp.asarray(h), jnp.asarray(pos)
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(hh, pp):
        a, f, _ = fused_allpairs_edges_v3(jp, hh, pp, jbox, jmask,
                                          mol_tile=4)
        return (a * c_agg).sum() + (f * c_fs).sum()

    ja, jf, _ = fused_allpairs_edges_v3(jp, jh, jpos, jbox, jmask,
                                        mol_tile=4)
    jgh, jgp = jax.grad(jloss, argnums=(0, 1))(jh, jpos)

    W = _torch_weights(leaves, torch.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    args = (t(h), t(pos), t(box), t(mask).to(torch.float32), W)
    agg, fsum = tiled_fwd(*args)
    dh, dpos = tiled_bwd(*args, t(c_agg), t(c_fs))
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
    for got, want in ((dh, jgh), (dpos, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)


PARAM_NS = (2, 11, 13, 30, 55)


@pytest.mark.parametrize("N", PARAM_NS)
def test_param_tiles_match_plain_f64(N):
    """The parameter-gradient schedule against the plain version at
    float64: every output to 1e-10 of its largest value (the two differ
    only by the order of the sums)."""
    h, pos, box, mask = _inputs(N, seed=300 + N, dtype=np.float64)
    _, leaves = _weights(9)
    W = _torch_weights(leaves, torch.float64)
    t = lambda a: torch.from_numpy(np.asarray(a))
    args = (t(h), t(pos), t(box), t(mask).to(torch.float64), W)
    rng = np.random.default_rng(400 + N)
    dagg = t(rng.normal(size=(B, N, H)))
    dfsum = t(rng.normal(size=(B, N, 3)))
    got = tiled_bwd_params(*args, dagg, dfsum)
    want = ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        w = w.numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())


@pytest.mark.parametrize("N", NS)
def test_param_tiles_match_pallas_f32(N):
    """The nine parameter gradients of the schedule against the v3 Pallas
    kernel's VJP in interpret mode at float32, at the tolerances of
    test_torch_port_egcl.py::test_param_grads_match_pallas_f32."""
    h, pos, box, mask = _inputs(N, seed=500 + N, dtype=np.float32)
    jp, leaves = _weights(11)
    rng = np.random.default_rng(600 + N)
    c_agg = rng.normal(size=(B, N, H)).astype(np.float32)
    c_fs = rng.normal(size=(B, N, 3)).astype(np.float32)
    jh, jpos = jnp.asarray(h), jnp.asarray(pos)
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(p):
        a, f, _ = fused_allpairs_edges_v3(p, jh, jpos, jbox, jmask,
                                          mol_tile=4)
        return (a * c_agg).sum() + (f * c_fs).sum()

    jg = jax.grad(jloss)(jp)
    W1 = np.asarray(jg["edge_nn"][0]["w"])
    want = [W1[:NF], W1[NF:2 * NF], W1[2 * NF:2 * NF + 1],
            np.asarray(jg["edge_nn"][0]["b"])[None],
            np.asarray(jg["edge_nn"][1]["w"]),
            np.asarray(jg["edge_nn"][1]["b"])[None],
            np.asarray(jg["coord_nn"][0]["w"]),
            np.asarray(jg["coord_nn"][0]["b"])[None],
            np.asarray(jg["coord_nn"][1]["w"])]
    W = _torch_weights(leaves, torch.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = tiled_bwd_params(t(h), t(pos), t(box), t(mask).to(torch.float32),
                           W, t(c_agg), t(c_fs))[2:]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())


def test_weight_split_is_exact():
    """The parameter-gradient kernel's row weights: an f32 value is the
    exact sum of three bf16 pieces (rn(v), rn(v - p0), the rest), so the
    products of the pieces with bf16 values sum the unrounded weight's."""
    rng = np.random.default_rng(12)
    v = torch.from_numpy((rng.normal(size=20000)
                          * 10.0 ** rng.uniform(-6, 6, size=20000))
                         .astype(np.float32))
    v = torch.cat([v, torch.tensor([0.0, 1.0, -3.0, 1e-30, 3.0e38],
                                   dtype=torch.float32)])
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32)
    p0 = bf(v)
    v1 = v - p0
    p1 = bf(v1)
    p2 = v1 - p1
    assert torch.equal(bf(p2), p2)
    total = p0.double() + p1.double() + p2.double()
    assert torch.equal(total, v.double())
    # a rounded weight is not: the fault the card's check must catch
    assert not torch.equal(p0.double(), v.double())

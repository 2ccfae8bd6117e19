"""Port parity: the all-pairs EGCL at every hidden width up to 256.

``ops/egcl_allpairs.py`` runs a launch at the padded width
(``ops.padded_width``: the next of 64, 128, 192 and 256), copying the
weights and dagg into zero-padded buffers where the width is another one;
bf16 at 192 and 256 goes to the block-pair kernels of
``csrc/egcl_allpairs_sm90.cu`` with W2 and W3 streamed through a ring of
slabs in shared memory (route ``"wide"``). Here, on the CPU:

- (a) zero-padding is exact: the plain version (``allpairs_edges_plain`` /
  ``_plain_bwd``, with and without the parameter gradients) on padded
  weights, cut back, equals the unpadded call to 1e-12 of each output's
  largest value at float64; and the wrapper's own padding, unpadding and
  counters with its launch replaced by the plain version;
- (b) the port's flow (``reverse_core``) at ``hidden_nf`` 100 and 256
  against the JAX flow at float64, to 1e-10;
- (c) the plain version at H = 256 against the v3 Pallas kernel in
  interpret mode at float32;
- (d) the streamed-slab schedule emulated in plain PyTorch at H = 192 and
  256: the slabs filled as the kernels' ``issue_slab`` fills them (the
  128-byte swizzle), read back at the addresses wgmma's descriptors give
  (``mma_chunk``), used in the stream's order through a ring of two slots,
  one 32-column chunk at a time, over the block-pair schedule at the
  plan's atoms a block (``tiled_block_*`` of
  ``test_torch_port_egcl_blocks.py``), held against the plain version at
  float64;
- (e) the kernels' shared-memory arithmetic mirrored in Python (a stub of
  the library's ``egcl_sm90_blocks_smem_bytes``): the chosen plan at H =
  192 and 256 fits in 232,448 bytes in every direction, and at H = 128 it
  gives the plan the card's library gives.

The route rules (every width up to 256 taken in both dtypes; H > 256
refused, naming ROADMAP B7) are checked too (f32 at 192 / 256 in
``test_torch_port_egcl_f32_wide.py``). The kernels themselves run on the card only
(``chip_smoke.py``, phases kernel and wide). Inputs are made with numpy
from a seed: ragged masks, a molecule with one real atom and one with none.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_egcl_blocks import (_inputs, tiled_block_bwd_params,
                                         tiled_block_fwd)

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.flow import reverse_core as j_reverse_core
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, reverse_core
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import egcl_allpairs as ops
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten

LIMIT = 232448                   # shared memory a block may use
TILE = 64                        # edge rows a tile (wgmma's M)
RING = 2                         # slabs a warpgroup's ring (kRing)


def _weights(nf, H, seed, dtype=torch.float64):
    """The nine weights at hidden width H, from a seed (1/sqrt(fan-in)
    scale, nonzero biases)."""
    rng = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy(
        rng.normal(size=s) / math.sqrt(s[0])).to(dtype)
    b = lambda: torch.from_numpy(rng.normal(size=(1, H)) * 0.1).to(dtype)
    return (w(nf, H), w(nf, H), w(1, H), b(), w(H, H), b(), w(H, H), b(),
            w(H, 1))


def _args(N, Bm, nf, H, seed, dtype=torch.float64):
    """Molecules (ragged masks, molecule 2 with one real atom, 3 with
    none, periodic boxes for the odd ones) with h of nf features, the
    weights at H, dagg and dfsum."""
    h, pos, box, mask = _inputs(N, Bm, seed, np.float64)
    rng = np.random.default_rng(seed + 1)
    h = rng.normal(size=(Bm, N, nf)) * mask[..., None]
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    W = _weights(nf, H, seed + 2, dtype)
    dagg = t(rng.normal(size=(Bm, N, H)))
    dfsum = t(rng.normal(size=(Bm, N, 3)))
    return (t(h), t(pos), t(box), t(mask), W), dagg, dfsum, mask


def _close(got, want, rel):
    """``got`` within ``rel`` of ``want`` and of its largest value (tensors
    or arrays)."""
    as_np = lambda t: (t.detach().double().numpy()
                       if isinstance(t, torch.Tensor)
                       else np.asarray(t, dtype=np.float64))
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# (a) padding is exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nf", [2, 5])
@pytest.mark.parametrize("H", [32, 96, 100, 160, 200])
def test_padding_is_exact(H, nf):
    """Plain forward and backward (input gradients; all nine parameter
    gradients) on weights zero-padded to the padded width, cut back to H,
    against the unpadded call at float64: 1e-12 of each output's largest
    value; the padded columns of agg and of every gradient exact zeros."""
    Hp = ops.padded_width(H)
    assert Hp in ops.PADDED_H and Hp >= H and Hp - H < 64
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(11, 5, nf, H, 3 * H + nf)
    Wp = ops.pad_weights(W, Hp)
    assert [tuple(w.shape) for w in Wp] == [
        (nf, Hp), (nf, Hp), (1, Hp), (1, Hp), (Hp, Hp), (1, Hp), (Hp, Hp),
        (1, Hp), (Hp, 1)]
    for w, wp in zip(W, Wp):
        inner = tuple(slice(0, n) for n in w.shape)
        assert torch.equal(wp[inner], w)
        rest = wp.clone()
        rest[inner] = 0.0
        assert float(rest.abs().max()) == 0.0
    daggp = ops.pad_rows(dagg, Hp)
    want = (ops.allpairs_edges_plain(h, pos, box, mf, W)
            + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum,
                                           params=True)
            + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum))
    agg, fsum = ops.allpairs_edges_plain(h, pos, box, mf, Wp)
    bwd = ops.allpairs_edges_plain_bwd(h, pos, box, mf, Wp, daggp, dfsum,
                                       params=True)
    dh, dpos = ops.allpairs_edges_plain_bwd(h, pos, box, mf, Wp, daggp, dfsum)
    assert float(agg[..., H:].abs().max()) == 0.0
    for g, w in zip(bwd[2:], ops.unpad_grads(bwd[2:], Hp)):
        assert torch.equal(g, w)            # nothing cut at Hp itself
    full = bwd[2:]
    dW1a, dW1b, dw1r, db1, dW2, db2, dW3, db3, dw4 = full
    for g in (dW1a, dW1b, dw1r, db1, db2, db3):
        assert float(g[:, H:].abs().max()) == 0.0
    for g in (dW2, dW3):
        assert float(g[H:].abs().max()) == 0.0
        assert float(g[:, H:].abs().max()) == 0.0
    assert float(dw4[H:].abs().max()) == 0.0
    got = ((agg[..., :H], fsum) + bwd[:2] + ops.unpad_grads(full, H)
           + (dh, dpos))
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and np.abs(w.numpy()).max() > 0
        _close(g, w, 1e-12)


@pytest.mark.parametrize("H", [64, 100])
def test_plain_bwd_terms_bound_the_sums(H):
    """``allpairs_edges_plain_bwd(..., terms=True)`` (the scale chip_smoke.py
    holds the kernels' parameter gradients against): the same dh and dpos,
    each of the nine at least the magnitude of its sum, the same for dagg
    and dfsum negated (which negates every sum), and over a batch the sum
    of each molecule's own, at float64."""
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(9, 4, 5, H, 7 * H)
    args = (h, pos, box, mf, W)
    sums = ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True)
    mags = ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True,
                                        terms=True)
    flipped = ops.allpairs_edges_plain_bwd(*args, -dagg, -dfsum, params=True,
                                           terms=True)
    for g, m in zip(sums[:2], mags[:2]):
        assert torch.equal(g, m)
    parts = [ops.allpairs_edges_plain_bwd(
        *(t[b:b + 1] for t in (h, pos, box, mf)), W, dagg[b:b + 1],
        dfsum[b:b + 1], params=True, terms=True)[2:] for b in range(4)]
    for k, (g, m, f) in enumerate(zip(sums[2:], mags[2:], flipped[2:])):
        scale = float(m.abs().max())
        assert scale > 0
        assert bool((m >= g.abs() - 1e-12 * scale).all())
        _close(f, m, 1e-12)
        _close(sum(part[k] for part in parts), m, 1e-12)


@pytest.mark.parametrize("code,H,route", [
    (0, 96, "f32"), (0, 100, "f32"), (0, 40, "f32"), (0, 160, "f32_wide"),
    (1, 96, "sm90"), (1, 100, "sm90"), (1, 160, "wide"), (1, 200, "wide"),
    (1, 192, "wide"), (0, 128, "f32")])
def test_wrapper_pads_launches_and_cuts_back(monkeypatch, code, H, route):
    """The wrapper's own padding with its launch (``_run``) replaced by
    the plain version: the launch sees the padded width and the route the
    rules name, the outputs come back at H equal to the unpadded plain
    call (float32, 1e-5 of each output's largest value: the matrix
    products sum other zeros), and the launch counts on its route's
    counter and, where the width was padded, on ``padded_launches``."""
    seen = []

    def run(direction, rt, h, pos, box, mask_f, weights, dagg, dfsum):
        seen.append((direction, rt, weights[4].shape[1],
                     None if dagg is None else dagg.shape[-1]))
        f32 = lambda t: t.to(h.dtype).to(torch.float32)
        ww = tuple(f32(w) for w in weights)
        if direction == "fwd":
            return ops.allpairs_edges_plain(f32(h), pos, box, f32(mask_f),
                                            ww)
        return ops.allpairs_edges_plain_bwd(
            f32(h), pos, box, f32(mask_f), ww, f32(dagg), f32(dfsum),
            direction == "bwd_params")

    monkeypatch.setattr(ops, "_run", run)
    monkeypatch.setattr(ops, "largest_molecule", lambda *a: 10 ** 6)
    cdt = {0: torch.float32, 1: torch.bfloat16}[code]
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(9, 4, 5, H, H, torch.float32)
    Hp = ops.padded_width(H)
    hc, mfc = h.to(cdt), mf.to(cdt)
    Wc = tuple(w.to(cdt) for w in W)
    ops.counts.reset()
    got = (ops._launch("fwd", hc, pos, box, mfc, Wc)
           + ops._launch("bwd", hc, pos, box, mfc, Wc, dagg, dfsum)
           + ops._launch("bwd_params", hc, pos, box, mfc, Wc, dagg, dfsum))
    assert seen == [("fwd", route, Hp, None), ("bwd", route, Hp, Hp),
                    ("bwd_params", route, Hp, Hp)]
    f32 = lambda t: t.to(torch.float32)
    Wf = tuple(f32(w) for w in Wc)
    want = (ops.allpairs_edges_plain(f32(hc), pos, box, f32(mfc), Wf)
            + ops.allpairs_edges_plain_bwd(f32(hc), pos, box, f32(mfc), Wf,
                                           f32(dagg.to(cdt)),
                                           f32(dfsum.to(cdt)))
            + ops.allpairs_edges_plain_bwd(f32(hc), pos, box, f32(mfc), Wf,
                                           f32(dagg.to(cdt)),
                                           f32(dfsum.to(cdt)), params=True))
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert got[0].is_contiguous() and got[0].shape[-1] == H
    suffix = {"f32": "", "sm90": "", "wide": "_wide",
              "f32_wide": "_f32_wide"}[route]
    names = ["fwd", "bwd_f32" if route == "f32" else "bwd", "bwd_param"]
    c = {k: v for k, v in vars(ops.counts).items()
         if not k.startswith("_") and v}
    want_c = {f"{n}{suffix}_launches": 1 for n in names}
    if Hp != H:
        want_c["padded_launches"] = 3
    assert c == want_c
    ops.counts.reset()


# ---------------------------------------------------------------------------
# the route rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hp", [(1, 64), (16, 64), (64, 64), (65, 128),
                                  (96, 128), (100, 128), (128, 128),
                                  (129, 192), (160, 192), (192, 192),
                                  (200, 256), (255, 256), (256, 256),
                                  (257, None), (512, None)])
def test_padded_width(H, Hp):
    assert ops.padded_width(H) == Hp


@pytest.mark.parametrize("direction", ["fwd", "bwd", "bwd_params"])
@pytest.mark.parametrize("H", [100, 160, 192, 200, 256])
def test_route_rule_every_bf16_width(H, direction):
    """bf16: H <= 128 the padded one-molecule route while N fits and the
    block pairs past it; 128 < H <= 256 ``"wide"`` at every N."""
    if H <= 128:
        assert ops.route_for(40, 5, H, 1, direction, 40) == "sm90"
        assert ops.route_for(41, 5, H, 1, direction, 40) == "blocks"
        return
    assert ops.kernel_for(1, H, direction) == "wide"
    for N in (1, 13, 55, 147, 5000):
        assert ops.route_for(N, 5, H, 1, direction, 0) == "wide"
        assert ops._check_fits(1, (2, N, 5, H), direction) == "wide"


@pytest.mark.parametrize("code", [0, 1])
def test_past_256_refuses_naming_b7(code):
    """H > 256 in either dtype: refused before any library is asked,
    naming ROADMAP B7 and the bytes such a width would need."""
    for H in (257, 320, 512):
        with pytest.raises(ValueError, match="B7") as e:
            ops.kernel_for(code, H, "bwd_params")
        msg = str(e.value)
        assert ops.WIDE_ITEM in msg and "bytes" in msg and f"H={H}" in msg
        need = int(msg.split("at least ")[1].split(" bytes")[0]
                   .replace(",", ""))
        assert need > LIMIT
        with pytest.raises(ValueError, match="B7"):
            ops._check_fits(code, (2, 13, 5, H), "fwd")


def test_wide_counters():
    ops.counts.reset()
    for direction, name in (("fwd", "fwd_wide_launches"),
                            ("bwd", "bwd_wide_launches"),
                            ("bwd_params", "bwd_param_wide_launches")):
        ops._count(direction, 256, "wide")
        ops._count(direction, 200, "wide")
        assert getattr(ops.counts, name) == 2
    assert ops.counts.padded_launches == 3
    ops.counts.reset()


# ---------------------------------------------------------------------------
# (b) the flow at hidden_nf 100 and 256 against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [100, 256])
def test_flow_at_other_widths_matches_jax_f64(H):
    """The port's flow log-density (reverse, 2 LF steps, all pairs, N=13,
    nf=5) and its gradient in the positions and every parameter at
    ``hidden_nf`` H, against the JAX flow at float64 (1e-10 of each
    array's largest value)."""
    N, Bm, nf = 13, 2, 5
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(nf, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(nf, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(H), jcfg, jnp.float64)
    rng = np.random.default_rng(H)
    mask = np.ones((Bm, N), bool)
    mask[1, -3:] = False
    arrs = {"h": rng.normal(size=(Bm, N, nf)),
            "g": rng.normal(size=(Bm, N, nf)),
            "pos": rng.normal(size=(Bm, N, 3)) * 1.5,
            "vel": rng.normal(size=(Bm, N, 3))}
    for a in arrs.values():
        a[~mask] = 0.0
    box = np.full((Bm, 3), 1e3)
    r_cut = np.full((Bm,), 1e2)
    c_pos = rng.normal(size=(Bm, N, 3))

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

    _close(ldj, jldj, 1e-10)
    _close(pos.grad, jgpos, 1e-10)
    jleaves = jax.tree_util.tree_leaves(jgp)
    assert len(jleaves) == len(leaves)
    assert any(tuple(x.shape[-2:]) == (H, H) for x in leaves)   # W2, W3
    for g, w in zip(leaves, jleaves):
        # a leaf the reverse pass does not read has no gradient (JAX: 0)
        got = g.grad if g.grad is not None else torch.zeros_like(g)
        _close(got, w, 1e-10)


# ---------------------------------------------------------------------------
# (c) the plain version at H = 256 against the Pallas kernel
# ---------------------------------------------------------------------------

def test_plain_at_256_matches_pallas_f32():
    """``allpairs_edges_plain`` at H = 256, B = 2, N = 8 against
    ``fused_allpairs_edges_v3`` in interpret mode at float32 (rtol 2e-5,
    atol 2e-6: test_torch_port_egcl.py's f32 forward tolerances)."""
    nf, H, N, Bm = 5, 256, 8, 2
    jp = j_init_egcl(jax.random.PRNGKey(7), JEGCLConfig(nf, H), jnp.float32)
    rng = np.random.default_rng(8)
    mask = np.ones((Bm, N), bool)
    mask[1, -2:] = False
    h = (rng.normal(size=(Bm, N, nf)) * mask[..., None]).astype(np.float32)
    pos = (rng.normal(size=(Bm, N, 3)) * mask[..., None]).astype(np.float32)
    box = np.full((Bm, 3), 1e3, np.float32)
    box[1] = 4.0
    ja, jf, _ = fused_allpairs_edges_v3(jp, jnp.asarray(h), jnp.asarray(pos),
                                        jnp.asarray(box), jnp.asarray(mask))
    t = lambda a: torch.from_numpy(np.array(a))
    W1, b1 = t(jp["edge_nn"][0]["w"]), t(jp["edge_nn"][0]["b"])
    W1a, W1b, w1r, b1r = ops.split_params(W1, b1, nf)
    W = (W1a, W1b, w1r, b1r, t(jp["edge_nn"][1]["w"]),
         t(jp["edge_nn"][1]["b"])[None], t(jp["coord_nn"][0]["w"]),
         t(jp["coord_nn"][0]["b"])[None], t(jp["coord_nn"][1]["w"]))
    agg, fsum = ops.allpairs_edges_plain(t(h), t(pos), t(box),
                                         t(mask).to(torch.float32), W)
    assert agg.shape == (Bm, N, H)
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# (d) the streamed-slab schedule
# ---------------------------------------------------------------------------

def swz(r, c, R):
    """Byte offset of (r, c) in a swizzled [R, *] bf16 matrix
    (sm90_common.cuh ``swz``)."""
    return ((c // 64) * (128 * R) + 128 * r + 16 * (((c % 64) // 8) ^ (r % 8))
            + 2 * (c % 8))


def phys(addr):
    """The 128-byte swizzle wgmma applies to a byte address inside
    1024-byte-aligned atoms: bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def slab_fill(H, TB):
    """``(dst, rows, cols)``: slab element ``dst`` (bf16 index) takes W[rows,
    64 g + cols] (TB = 1, X W: the 64-column half, R = H rows) or W[64 g +
    rows, cols] (TB = 0, X W^T: 64 of W's rows as a [64, H] tile), as the
    kernels' ``issue_slab`` copies it, 8 elements a 16-byte piece."""
    dst, rows, cols = [], [], []
    for idx in range(8 * H):
        if TB:
            r, c = idx >> 3, 8 * (idx & 7)
            base = swz(r, c, H) // 2
        else:
            r, c = idx // (H // 8), 8 * (idx % (H // 8))
            base = swz(r, c, TILE) // 2
        dst += [base + e for e in range(8)]
        rows += [r] * 8
        cols += [c + e for e in range(8)]
    return np.array(dst), np.array(rows), np.array(cols)


def slab_read(H, TB, n0):
    """[H, 32]: the slab element that wgmma reads as B[k, n] of the chunk
    at ``n0`` (0 or 32) of the slab (``mma_chunk``: TB = 1 MN-major, k-step
    kk at 2048 kk bytes, the chunk 2 n0 bytes into the rows; TB = 0
    K-major, k-step kk at 128 * 64 (kk / 4) + 32 (kk % 4) bytes, the chunk
    128 n0 bytes on)."""
    k = np.arange(H)[:, None]
    n = np.arange(32)[None, :]
    if TB:
        logical = 2 * n0 + 2048 * (k // 16) + 128 * (k % 16) + 2 * n
    else:
        kk = k // 16
        logical = (128 * n0 + 128 * TILE * (kk // 4) + 32 * (kk % 4)
                   + 128 * n + 2 * (k % 16))
    return phys(logical) // 2


class SlabRing:
    """One warpgroup's ring of RING slabs: slab s of the stream is product
    (s / G) % nprod (W2 X W, W3 X W, W3 X W^T, W2 X W^T) and its columns 64
    (s % G) ..; slab s + RING - 1 is issued into slot s + RING - 1 mod RING
    when slab s is taken (which must not be the slot being read)."""

    def slot(self, s):
        """The kernels' ``slot_of``."""
        return s % RING

    def __init__(self, W2, W3, nprod):
        self.W = {0: W2.numpy(), 1: W3.numpy(), 2: W3.numpy(),
                  3: W2.numpy()}
        self.H = W2.shape[0]
        self.G = self.H // 64
        self.nprod = nprod
        self.fill = {TB: slab_fill(self.H, TB) for TB in (0, 1)}
        self.read = {(TB, n0): slab_read(self.H, TB, n0)
                     for TB in (0, 1) for n0 in (0, 32)}
        self.slots = [None] * RING
        self.tags = [None] * RING
        self.s = 0
        self.used = []
        for s in range(RING - 1):
            self.issue(s)

    def issue(self, s):
        prod, g = (s // self.G) % self.nprod, s % self.G
        dst, rows, cols = self.fill[int(prod < 2)]
        buf = np.full(64 * self.H, np.nan)
        W = self.W[prod]
        buf[dst] = (W[rows, 64 * g + cols] if prod < 2
                    else W[64 * g + rows, cols])
        assert not np.isnan(buf).any()          # every element written once
        self.slots[self.slot(s)] = buf
        self.tags[self.slot(s)] = s

    def take(self):
        s = self.s
        assert self.tags[self.slot(s)] == s
        nxt = s + RING - 1
        # the next slab's copy never lands in the slot being read
        assert self.slot(nxt) != self.slot(s) or nxt == s
        self.issue(nxt)
        self.s += 1
        self.used.append(((s // self.G) % self.nprod, s % self.G))
        return self.slots[self.slot(s)]

    def product(self, X, prod, TB):
        """X [.., 64, H] times W (TB = 1) or W^T (TB = 0), slab by slab."""
        out = torch.zeros(X.shape[:-1] + (self.H,), dtype=X.dtype)
        for g in range(self.G):
            want = ((self.s // self.G) % self.nprod, self.s % self.G)
            assert want == (prod, g), (want, prod, g)
            buf = self.take()
            for n0 in (0, 32):
                B = torch.from_numpy(buf[self.read[(TB, n0)]])
                out[..., 64 * g + n0:64 * g + n0 + 32] = X @ B
        return out


@pytest.mark.parametrize("H", [192, 256])
def test_slab_layout_reads_back_w(H):
    """Every slab of both products, read at wgmma's addresses, is the
    chunk's B: W[k, 64 g + n0 + n] (X W) or W[64 g + n0 + n, k] (X W^T),
    every element of W read once over the G slabs and two chunks."""
    W = np.arange(H * H, dtype=np.float64).reshape(H, H)
    for TB in (0, 1):
        dst, rows, cols = slab_fill(H, TB)
        assert sorted(dst.tolist()) == list(range(64 * H))
        seen = np.zeros((H, H), int)
        for g in range(H // 64):
            buf = np.full(64 * H, np.nan)
            buf[dst] = W[rows, 64 * g + cols] if TB else W[64 * g + rows,
                                                            cols]
            for n0 in (0, 32):
                B = buf[slab_read(H, TB, n0)]
                k = np.arange(H)[:, None]
                n = 64 * g + n0 + np.arange(32)[None, :]
                want = W[k, n] if TB else W[n, k]
                np.testing.assert_array_equal(B, want)
                if TB:
                    seen[k, n] += 1
                else:
                    seen[n, k] += 1
        assert (seen == 1).all()


def _streamed_dot(monkeypatch, ring, W2, W3):
    """``ops._dot`` with the products by W2 / W3 (and their transposes)
    taken slab by slab from ``ring``; every other product as before."""
    plain = ops._dot

    def dot(a, b, out_dtype):
        for W, prods in ((W2, (0, 3)), (W3, (1, 2))):
            if b.data_ptr() == W.data_ptr() and b.shape == W.shape:
                TB = int(b.stride() == W.stride())
                prod = prods[0] if TB else prods[1]
                return ring.product(a.to(torch.float64), prod, TB).to(
                    out_dtype)
        return plain(a, b, out_dtype)

    monkeypatch.setattr(ops, "_dot", dot)


def _plan(N, H, direction):
    lib = StubLib()
    return ops.blocks_plan(N, direction, lambda A, nwg: 0 <= (
        lib.egcl_sm90_blocks_smem_bytes(A, 5, H, ops._KIND[direction],
                                        nwg)) <= LIMIT)


@pytest.mark.parametrize("H,N_fwd,N_bwd", [(192, 40, 40), (256, 40, 20)])
def test_streamed_schedule_matches_plain_f64(monkeypatch, H, N_fwd, N_bwd):
    """The block-pair schedule at the plan's atoms a block with every
    W2 / W3 product streamed through the ring (slab order, each chunk
    from its slab as wgmma reads it), against the plain version at
    float64: forward,
    input gradients and the nine parameter gradients to 1e-10 of each
    output's largest value; the stream visits (product, slab) in order,
    tile after tile."""
    for direction, N in (("fwd", N_fwd), ("bwd_params", N_bwd)):
        A, nwg = _plan(N, H, direction)
        assert nwg == 1 and A % 8 == 0 and math.ceil(N / A) > 1
        (h, pos, box, mf, W), dagg, dfsum, _ = _args(N, 4, 5, H, H + N)
        if direction == "fwd":
            want = ops.allpairs_edges_plain(h, pos, box, mf, W)
        else:
            want = ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg,
                                                dfsum, params=True)
        nprod = 2 if direction == "fwd" else 4
        ring = SlabRing(W[4], W[6], nprod)
        with monkeypatch.context() as m:
            _streamed_dot(m, ring, W[4], W[6])
            got = (tiled_block_fwd(h, pos, box, mf, W, A)
                   if direction == "fwd" else
                   tiled_block_bwd_params(h, pos, box, mf, W, dagg, dfsum, A))
        G = H // 64
        assert len(ring.used) % (nprod * G) == 0 and ring.used
        assert ring.used == [(p, g) for p in range(nprod)
                             for g in range(G)] * (len(ring.used)
                                                   // (nprod * G))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.abs(w.numpy()).max() > 0
            _close(g, w, 1e-10)


def test_ring_of_one_slot_overwrites_the_slab_in_use():
    """The emulated ring notices every slab in one slot while the copies
    still run a slab ahead (chip_mutants.py's "a slab ring of one"): the
    next slab's copy would land in the slab being read."""
    class OneSlot(SlabRing):
        def slot(self, s):
            return 0
    W = _weights(5, 192, 1)
    ring = SlabRing(W[4], W[6], 2)
    ring.take()
    ring = OneSlot(W[4], W[6], 2)
    with pytest.raises(AssertionError):
        ring.take()


# ---------------------------------------------------------------------------
# (e) the shared-memory arithmetic
# ---------------------------------------------------------------------------

class StubLib:
    """The library's block-pair shared-memory arithmetic (``carve_blk``,
    ``carve_wg`` with blocks, ``smem_bytes`` of egcl_allpairs_sm90.cu)
    mirrored in Python: the resident widths hold W2 and W3 whole, the
    streamed ones (192, 256) one warpgroup a block with a ring of RING
    slabs of 128 H bytes."""

    def egcl_sm90_smem_limit(self):
        return LIMIT

    def egcl_sm90_blocks_smem_bytes(self, A, nf, H, kind, nwg):
        streamed = H in (192, 256)
        most = 1 if streamed else (3 if kind == 0 else 2)
        if H not in (64, 128, 192, 256) or not 1 <= nwg <= most or A < 1:
            return -1
        off = 0

        def take(n, align=16):
            nonlocal off
            off = (off + align - 1) // align * align + n
        if not streamed:
            take(2 * H * H, 1024)
            take(2 * H * H, 1024)
        for _ in range(5):
            take(2 * H)
        take(4 * nf * H)
        take(4 * nf * H)
        take(4 * H)
        take(4 * H)
        bwd, params = kind != 0, kind == 2
        T, HP, C = 2 * TILE * H, H + 8, H + 4
        for _ in range(nwg):
            if streamed:
                take(RING * T, 1024)
            take(T, 1024)
            take(T, 1024)
            if bwd:
                take(T, 1024)
            take(2 * 8 * TILE, 1024)
            take(2 * A * HP)
            take(2 * A * HP)
            if kind == 1:
                take(2 * A * HP)
            if params:
                take(4 * 2 * TILE)
                take(4 * 9 * H)
            take(2 * TILE)
            take(2 * TILE)
            take(4 * A * C)
            if bwd:
                take(4 * A * C)
            take(4 * A * nf)
            take(4 * A * 3)
            take(4 * A)
            take(16)
            if bwd:
                take(4 * A * 3)
            take(4 * A * nf)
            take(4 * A * 3)
            take(4 * A)
        return off + 1024


@pytest.mark.parametrize("direction", ["fwd", "bwd", "bwd_params"])
@pytest.mark.parametrize("H,want", [(192, {"fwd": 32, "bwd": 32,
                                           "bwd_params": 32}),
                                    (256, {"fwd": 32, "bwd": 8,
                                           "bwd_params": 8})])
def test_wide_plan_fits(H, want, direction):
    """At N=147 the plan at H = 192 / 256 is one warpgroup and the most
    atoms (a multiple of 8, at most 32) whose block, ring included, fits in
    232,448 bytes; 8 more atoms do not fit (at H = 256 backward), and a
    second warpgroup is never offered."""
    lib = StubLib()
    A, nwg = ops._blocks_launch_plan(lib, 147, 5, H, direction)
    fit = want[direction]
    assert nwg == 1 and A == ops.block_atoms(147, fit)
    kind = ops._KIND[direction]
    need = lib.egcl_sm90_blocks_smem_bytes(fit, 5, H, kind, 1)
    assert 0 < need <= LIMIT
    if fit < ops.BLOCK_ATOMS_MAX:
        assert lib.egcl_sm90_blocks_smem_bytes(fit + 8, 5, H, kind,
                                               1) > LIMIT
    assert lib.egcl_sm90_blocks_smem_bytes(8, 5, H, kind, 2) == -1
    # the ring's two slabs are the room a resident copy would not leave
    assert need + 4 * H * H - 2 * 128 * H > LIMIT


def test_stub_gives_the_cards_plan_at_128():
    """At H = 128 the mirror gives the plan that the card's library gives
    (blocks of 32 atoms, 2 warpgroups forward and 1 backward; PERF.md)."""
    lib = StubLib()
    assert ops._blocks_launch_plan(lib, 147, 5, 128, "fwd") == (32, 2)
    assert ops._blocks_launch_plan(lib, 147, 5, 128, "bwd") == (32, 1)
    assert ops._blocks_launch_plan(lib, 147, 5, 128, "bwd_params") == (32, 1)

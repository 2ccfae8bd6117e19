"""Port parity: the all-pairs EGCL past H = 256.

``ops/egcl_allpairs.py`` sends every launch whose padded width
(``ops.padded_width``: past 256 the next multiple of 64) is past 256 to
the kernels of ``csrc/egcl_allpairs_xwide.cu``: route ``"xwide"`` (bf16,
wgmma) and ``"f32_xwide"`` (float32, FMA), at every N and nf. A tile is a
block pair of 8 i atoms x 8 j atoms (64 edge rows); z1 comes from the
per-atom projections [h W1a | h W1b]; every H x H product runs in 64-column
output chunks over 64-row k-chunks of the weight; the H-wide activations
live in global memory, so nothing in a block's shared memory grows with H.
Here, on the CPU:

- (a) the route rule: no H in 257 .. 1024 is refused in either dtype or
  direction, every N and nf goes to the dtype's xwide route, H <= 256
  keeps its route, only a width past ``XWIDE_MAX_H`` is refused (naming
  ROADMAP B7.5 and the bytes); the new counters, and the wrapper's padding
  with its launch replaced by the plain version;
- (b) zero-padding past 256 is exact at float64 (H = 300 at 320, 320 at
  384, 512 at 576);
- (c) the slice as a whole: an LJ flow-VI loss and its parameter gradients
  at ``hidden_nf`` 320 against the JAX package's, float64;
- (d) the plain version at H = 384 against the v3 Pallas kernel in
  interpret mode at float32, with the parameter gradients;
- (e) the kernels' schedule emulated in plain PyTorch, one product a
  chunk: the 8 x 8 tiles of each (molecule, i-block) work item, each H x H
  product one 64 x 64 output chunk at a time summed over 64-row k-chunks,
  the gate and dr2 reduced over the chunks, the i-side sums accumulated
  over the j-blocks and the j-side sums one row a block pair, dpos, dh and
  dW1 from the per-atom dz1 sums, K2 p's outer products chunk by chunk into
  per-block slices, against the plain version at float64 (1e-12), at H =
  320 and 512; and the bf16 K1 / K2's ring schedule: two j-blocks a round
  (one a consumer warpgroup, the second idle in an odd last round, N =
  20), 128-column output chunks (the last 64 wide at H = 320), the round's
  node sums over both tiles in the j-blocks' order;
- (f) the kernels' shared memory mirrored in Python
  (``tests/egcl_smem_mirror.py``'s ``xwide_bytes``, by dtype and kind: the
  ring kernels' stages beside egcl_xwide_kernel's two steps): the same at
  every H and within the card's 232,448 bytes;
- (g) the plain backward's root-sum-square of each parameter gradient's
  terms (``terms="l2"``, the rounding scale of the bf16 checks past 256
  in ``chip_smoke.py``) against the sum of their magnitudes;
- (h) the launch code of the routes on the per-atom projections
  (``"xwide"``, ``"wide_nf"`` and their f32 routes) with stub libraries:
  the copy made of an input that does not start on 16 bytes (a batch
  slice) is still alive when the library's entry point is called.

The kernels themselves run on the card only (``chip_smoke.py``, phase
xwide). Inputs are made with numpy from a seed: ragged masks, a molecule
with one real atom and one with none, periodic boxes.
"""

import math
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egcl_smem_mirror as mirror
from test_torch_port_egcl_wide import _args, _close
from test_torch_port_egcl_wide_nf import StubF32, StubSm90

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3
from enflow_tpu.sample import targets as jtargets
from enflow_tpu.sample.vi import flow_vi_loss as j_flow_vi_loss
from enflow_tpu.sample.vi import make_system_target as j_system_target

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import egcl_allpairs as ops
from enflow_tpu_torch.sample import targets as ttargets
from enflow_tpu_torch.sample.vi import flow_vi_loss, make_system_target
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten
from torch_threads import one_torch_thread  # noqa: F401

LIMIT = 232448                   # shared memory a block may use
DIRECTIONS = ("fwd", "bwd", "bwd_params")
ATOMS = 8                        # atoms an atom block (kAtoms)
COL = 64                         # output columns / k a chunk (kCol)
RING_COL = 128                   # output columns a chunk (RingBf::kNC)


# ---------------------------------------------------------------------------
# (a) the route rule and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", [0, 1])
def test_no_width_past_256_is_refused(code):
    """Every H in 257 .. 1024 pads to the next multiple of 64 and goes to
    the dtype's xwide route in every direction, at every N and nf (no
    library is asked: the route has no molecule or nf limit)."""
    route = ops.XWIDE_ROUTE[code]
    for H in range(257, 1025):
        Hp = ops.padded_width(H)
        assert Hp % 64 == 0 and H <= Hp < H + 64
        for direction in DIRECTIONS:
            assert ops.kernel_for(code, H, direction) == route
    for H in (300, 320, 512, 1024):
        for direction in DIRECTIONS:
            for N in (1, 13, 22, 55, 147, 5000):
                assert ops.route_for(N, 5, H, code, direction, 0) == route
                assert ops._check_fits(code, (2, N, 5, H), direction) == route
                for nf in (1, 5, 300):
                    assert ops.route_of(code, (2, N, nf, H),
                                        direction) == route
            with pytest.raises(ValueError, match="no one-molecule limit"):
                ops._smem(code, 13, 5, ops.padded_width(H), direction)


@pytest.mark.parametrize("code", [0, 1])
def test_widths_up_to_256_keep_their_routes(code):
    """H <= 256 keeps the parent's rule: the padded width one of 64, 128,
    192, 256; the one-molecule route at 64 / 128 and the streamed block
    pairs at 192 / 256."""
    for H in range(1, 257):
        Hp = ops.padded_width(H)
        assert Hp in ops.PADDED_H and Hp >= H and Hp - H < 64
        want = (("sm90" if code else "f32") if Hp in ops.SM90_H
                else ("wide" if code else "f32_wide"))
        for direction in DIRECTIONS:
            assert ops.kernel_for(code, H, direction) == want


@pytest.mark.parametrize("code", [0, 1])
def test_past_the_widest_refuses_naming_b7_5(code):
    """Past XWIDE_MAX_H (11,520, the mirror's rule: a K2 p slice within 1
    GiB) a launch is refused, naming ROADMAP B7.5 and the bytes one slice
    would need; the mirror's widest is the wrapper's."""
    assert mirror.xwide_max_width() == ops.XWIDE_MAX_H
    ops.kernel_for(code, ops.XWIDE_MAX_H, "fwd")
    for H in (ops.XWIDE_MAX_H + 1, 20000):
        with pytest.raises(ValueError, match="B7.5") as e:
            ops.kernel_for(code, H, "bwd_params")
        msg = str(e.value)
        assert ops.XWIDE_ITEM in msg and f"H={H}" in msg and "bytes" in msg
        need = int(msg.split("need ")[1].split(" bytes")[0].replace(",", ""))
        assert need == mirror.xwide_slice_bytes(ops.padded_width(H))
        assert need > ops.XWIDE_SLICE_BYTES


@pytest.mark.parametrize("code", [0, 1])
@pytest.mark.parametrize("direction,name", [
    ("fwd", "fwd_{}_launches"), ("bwd", "bwd_{}_launches"),
    ("bwd_params", "bwd_param_{}_launches")])
def test_xwide_counters(direction, name, code):
    """Each launch on its route's own counter, a padded one on
    ``padded_launches`` too; no other counter moves."""
    route = ops.XWIDE_ROUTE[code]
    ops.counts.reset()
    ops._count(direction, 512, route)
    ops._count(direction, 300, route)
    got = {k: v for k, v in vars(ops.counts).items()
           if not k.startswith("_") and v}
    assert got == {name.format(route): 2, "padded_launches": 1}
    ops.counts.reset()


def test_xwide_launch_failure_names_the_route():
    class Lib:
        def egcl_xwide_error_string(self, err):
            return b"invalid argument"
    for route in ops.XWIDE_ROUTE.values():
        with pytest.raises(RuntimeError, match=f"invalid argument.*{route}"):
            ops._raise_on(Lib(), 1, "forward", (2, 13, 5, 512), route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [300, 320])
def test_wrapper_runs_xwide_at_the_padded_width(monkeypatch, H, dtype):
    """The wrapper with its launch (``_run``) replaced by the plain
    version: every direction reaches the dtype's xwide route at the padded
    width (dagg padded too), the outputs come back at H equal to the
    unpadded plain call, on the new counters; the block-pair routes
    forced past 256 raise."""
    seen = []

    def run(direction, rt, h, pos, box, mask_f, weights, dagg, dfsum):
        seen.append((direction, rt, weights[4].shape[1],
                     None if dagg is None else dagg.shape[-1]))
        if direction == "fwd":
            return ops.allpairs_edges_plain(h, pos, box, mask_f, weights)
        return ops.allpairs_edges_plain_bwd(h, pos, box, mask_f, weights,
                                            dagg, dfsum,
                                            direction == "bwd_params")

    monkeypatch.setattr(ops, "_run", run)
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(9, 4, 5, H, H,
                                                 torch.float32)
    h, mf, dagg, dfsum = (t.to(dtype) for t in (h, mf, dagg, dfsum))
    W = tuple(w.to(dtype) for w in W)
    route = ops.XWIDE_ROUTE[ops._DTYPE_CODE[dtype]]
    Hp = ops.padded_width(H)
    ops.counts.reset()
    got = (ops._launch("fwd", h, pos, box, mf, W)
           + ops._launch("bwd", h, pos, box, mf, W, dagg, dfsum)
           + ops._launch("bwd_params", h, pos, box, mf, W, dagg, dfsum))
    assert seen == [("fwd", route, Hp, None), ("bwd", route, Hp, Hp),
                    ("bwd_params", route, Hp, Hp)]
    want = (ops.allpairs_edges_plain(h, pos, box, mf, W)
            + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum)
            + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum,
                                           params=True))
    if dtype == torch.float32:
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
    else:
        # the padded columns add exact zeros: bf16 values agree bit for
        # bit, the f32 sums to f32 round-off
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g.double(), w.double(), 2e-2)
    c = {k: v for k, v in vars(ops.counts).items()
         if not k.startswith("_") and v}
    want_c = {f"fwd_{route}_launches": 1, f"bwd_{route}_launches": 1,
              f"bwd_param_{route}_launches": 1}
    if Hp != H:
        want_c["padded_launches"] = 3
    assert c == want_c
    ops.counts.reset()
    for forced in ("blocks", "wide_nf"):
        with pytest.raises(ValueError, match="takes H <= 256"):
            ops._launch("fwd", h, pos, box, mf, W, route=forced)


# ---------------------------------------------------------------------------
# (b) zero-padding past 256 is exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hp", [(300, 320), (320, 384), (512, 576)])
def test_padding_past_256_is_exact(H, Hp):
    """Plain forward and backward (input and all nine parameter gradients)
    on weights zero-padded to Hp, cut back to H, against the unpadded call
    at float64: 1e-12 of each output's largest value; the padded columns
    of agg and of every gradient exact zeros. H = 300 pads to the route's
    own padded width."""
    if H == 300:
        assert ops.padded_width(H) == Hp
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(7, 4, 3, H, H + 1)
    Wp = ops.pad_weights(W, Hp)
    daggp = ops.pad_rows(dagg, Hp)
    agg, fsum = ops.allpairs_edges_plain(h, pos, box, mf, W)
    aggp, fsump = ops.allpairs_edges_plain(h, pos, box, mf, Wp)
    assert torch.all(aggp[..., H:] == 0)
    _close(aggp[..., :H], agg, 1e-12)
    _close(fsump, fsum, 1e-12)
    want = ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum,
                                        params=True)
    got = ops.allpairs_edges_plain_bwd(h, pos, box, mf, Wp, daggp, dfsum,
                                       params=True)
    cut = got[:2] + ops.unpad_grads(got[2:], H)
    for g, w in zip(cut, want):
        _close(g, w, 1e-12)
    full = sum(float(g.abs().sum()) for g in got[2:])
    kept = sum(float(g.abs().sum()) for g in cut[2:])
    assert full == pytest.approx(kept, rel=1e-15, abs=0.0)


# ---------------------------------------------------------------------------
# (c) the slice as a whole: flow-VI at hidden_nf 320 against JAX
# ---------------------------------------------------------------------------

def test_flow_vi_loss_at_320_matches_jax_f64():
    """The reverse-KL VI loss of an LJ6 cluster (nf=3, 2 flow steps, two
    particles) and every parameter gradient at ``hidden_nf`` 320, against
    the JAX package at float64 (1e-9)."""
    NF, H, P, N = 3, 320, 2, 6
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(5), jcfg, jnp.float64)
    rng = np.random.default_rng(11)
    ring = np.stack([np.cos(2 * np.pi * np.arange(N) / N),
                     np.sin(2 * np.pi * np.arange(N) / N),
                     np.zeros(N)], -1) * 1.1
    draws = {"h": rng.normal(size=(P, N, NF)),
             "g": rng.normal(size=(P, N, NF)),
             "pos": ring[None] + 0.1 * rng.normal(size=(P, N, 3)),
             "vel": rng.normal(size=(P, N, 3))}
    rest = dict(mask=np.ones((P, N), bool), box=np.full((P, 3), 1e3),
                r_cut=np.full((P,), 1e2))
    jbatch = JSystem(**{k: jnp.asarray(v) for k, v in {**draws,
                                                       **rest}.items()})
    tbatch = System(**{k: torch.from_numpy(v.copy())
                       for k, v in {**draws, **rest}.items()})
    jt = j_system_target(jtargets.lj_cluster(N, kBT=2.0).log_prob)
    tt = make_system_target(ttargets.lj_cluster(N, kBT=2.0).log_prob)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_flow_vi_loss(p, jcfg, jbatch, jt)[0]))(jp)
    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, _ = flow_vi_loss(tp, tcfg, tbatch, tt)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    assert any(tuple(t.shape[-2:]) == (H, H) for t in leaves)   # W2, W3
    assert np.isfinite(float(jl))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-9)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


# ---------------------------------------------------------------------------
# (d) the plain version at H = 384 against the Pallas kernel
# ---------------------------------------------------------------------------

def test_plain_at_384_matches_pallas_f32():
    """``allpairs_edges_plain`` / ``_plain_bwd`` (with the parameter
    gradients) at H = 384, B = 2, N = 6, against ``fused_allpairs_edges_v3``
    in interpret mode and its VJP at float32: forward at rtol 2e-5 / atol
    2e-6, dh / dpos and the nine parameter gradients at rtol 5e-5 / atol
    5e-6 of their largest value (test_torch_port_egcl.py's f32
    tolerances)."""
    nf, N, Bm, H = 4, 6, 2, 384
    jp = j_init_egcl(jax.random.PRNGKey(H), JEGCLConfig(nf, H), jnp.float32)
    rng = np.random.default_rng(H + 1)
    mask = np.ones((Bm, N), bool)
    mask[1, -2:] = False
    f32 = lambda a: np.asarray(a, np.float32)
    h = f32(rng.normal(size=(Bm, N, nf)) * mask[..., None])
    pos = f32(rng.normal(size=(Bm, N, 3)) * mask[..., None])
    box = np.full((Bm, 3), 1e3, np.float32)
    box[1] = 4.0
    c_agg = f32(rng.normal(size=(Bm, N, H)))
    c_fs = f32(rng.normal(size=(Bm, N, 3)))
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(p, hh, pp):
        a, f, _ = fused_allpairs_edges_v3(p, hh, pp, jbox, jmask)
        return (a * c_agg).sum() + (f * c_fs).sum()

    ja, jf, _ = fused_allpairs_edges_v3(jp, jnp.asarray(h), jnp.asarray(pos),
                                        jbox, jmask)
    jg, jgh, jgp = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(h), jnp.asarray(pos))
    t = lambda a: torch.from_numpy(np.array(a))
    W1, b1 = t(jp["edge_nn"][0]["w"]), t(jp["edge_nn"][0]["b"])
    W1a, W1b, w1r, b1r = ops.split_params(W1, b1, nf)
    W = (W1a, W1b, w1r, b1r, t(jp["edge_nn"][1]["w"]),
         t(jp["edge_nn"][1]["b"])[None], t(jp["coord_nn"][0]["w"]),
         t(jp["coord_nn"][0]["b"])[None], t(jp["coord_nn"][1]["w"]))
    args = (t(h), t(pos), t(box), t(mask).to(torch.float32), W)
    agg, fsum = ops.allpairs_edges_plain(*args)
    dh, dpos, *pgrads = ops.allpairs_edges_plain_bwd(
        *args, t(c_agg), t(c_fs), params=True)
    assert agg.shape == (Bm, N, H)
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)
    for got, want in ((dh, jgh), (dpos, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                                   atol=5e-6)
    jW1 = np.asarray(jg["edge_nn"][0]["w"])
    jparams = [jW1[:nf], jW1[nf:2 * nf], jW1[2 * nf:2 * nf + 1],
               np.asarray(jg["edge_nn"][0]["b"])[None],
               np.asarray(jg["edge_nn"][1]["w"]),
               np.asarray(jg["edge_nn"][1]["b"])[None],
               np.asarray(jg["coord_nn"][0]["w"]),
               np.asarray(jg["coord_nn"][0]["b"])[None],
               np.asarray(jg["coord_nn"][1]["w"])]
    for g, w in zip(pgrads, jparams):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())


# ---------------------------------------------------------------------------
# (e) the kernels' schedule, one product a chunk
# ---------------------------------------------------------------------------

def _silu(x):
    return x * torch.sigmoid(x)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def chunked(X, Y, mode, width=COL):
    """The product of EngBf::run / EngF32::run, one 64 x 64 output chunk
    at a time, each summed over its k-chunks in order: mode 0 X Y, 1 X
    Y^T, 2 X^T Y (the tile's 64 rows the k). ``width`` RING_COL: RingBf's
    (the ring kernels') 128-column output chunks, the last one 64 wide
    where H / 64 is odd (mode 0 and 1)."""
    H = Y.shape[1]
    G = H // COL
    out = torch.zeros((H if mode == 2 else X.shape[0], H), dtype=X.dtype)
    if mode == 2:
        for o in range(G * G):
            m0, n0 = COL * (o // G), COL * (o % G)
            out[m0:m0 + COL, n0:n0 + COL] = (X[:, m0:m0 + COL].T
                                             @ Y[:, n0:n0 + COL])
        return out
    for n0 in range(0, H, width):
        n1 = min(H, n0 + width)
        acc = torch.zeros((X.shape[0], n1 - n0), dtype=X.dtype)
        for k in range(G):
            k0 = COL * k
            w = (Y[k0:k0 + COL, n0:n1] if mode == 0
                 else Y[n0:n1, k0:k0 + COL].T)
            acc = acc + X[:, k0:k0 + COL] @ w
        out[:, n0:n1] = acc
    return out


def xwide_schedule(direction, h, pos, box, mask_f, W, dagg=None, dfsum=None,
                   blocks=3, ring=False):
    """The xwide kernels' work at float64 in their order: ``blocks``
    persistent blocks over the (molecule, i-block) items, each walking the
    j-blocks with one tile (8 x 8 atoms, 64 rows: i = 8 ib + r / 8, j = 8 jb
    + r % 8) each; returns the outputs of :func:`ops.allpairs_edges_plain`
    / ``_plain_bwd`` (with the parameter gradients for ``"bwd_params"``).
    ``ring``: the bf16 K1 / K2's ring kernels (``"fwd"``, ``"bwd"``): a
    round takes two j-blocks, one a consumer warpgroup (the second idle in
    an odd last round), their products in RING_COL-column output chunks
    (the gate and dr2 summed over them), and the round's node sums over
    both tiles after both are done, the j-blocks in order."""
    assert not (ring and direction == "bwd_params")
    width = RING_COL if ring else COL
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    B, N, nf = h.shape
    H = W2.shape[1]
    nI = -(-N // ATOMS)
    dt = h.dtype
    proj = torch.cat([h @ W1a, h @ W1b], -1).reshape(B * N, 2 * H)
    bwd, params = direction != "fwd", direction == "bwd_params"
    agg = torch.zeros((B, N, H), dtype=dt)
    fsum = torch.zeros((B, N, 3), dtype=dt)
    si = torch.full((B, N, H + 4), float("nan"), dtype=dt)
    pj = torch.full((B, nI, N, H + 4), float("nan"), dtype=dt)
    items = B * nI
    grid = min(blocks, items)
    P = 2 * H * H + 5 * H
    part = torch.zeros((grid, P), dtype=dt)
    for blk in range(grid):
        sl = part[blk]
        dW2, dW3 = sl[:H * H].view(H, H), sl[H * H:2 * H * H].view(H, H)
        dw1r, db1, db2, db3, dw4 = sl[2 * H * H:].view(5, H)
        for it in range(blk, items, grid):
            b, ib = divmod(it, nI)
            acci = torch.zeros((ATOMS, H), dtype=dt)
            fs = torch.zeros((ATOMS, 3), dtype=dt)
            step = 2 if ring else 1

            def tile(jb):
                """One tile's work: its node-sum terms (the forward's m2
                and forces, the backward's dz1 | dcd rows)."""
                r = torch.arange(64)
                i, j = ib * ATOMS + r // ATOMS, jb * ATOMS + r % ATOMS
                inb = (i < N) & (j < N)
                ic, jc = i.clamp(max=N - 1), j.clamp(max=N - 1)
                cd = torch.where(inb[:, None], pos[b, ic] - pos[b, jc], 0.0)
                cd = cd - torch.round(cd / box[b]) * box[b]
                r2 = (cd * cd).sum(-1)
                valid = torch.where(inb & (i != j),
                                    mask_f[b, ic] * mask_f[b, jc], 0.0)
                ha = torch.where(inb[:, None], proj[b * N + ic, :H], 0.0)
                hb = torch.where(inb[:, None], proj[b * N + jc, H:], 0.0)
                z1 = ha + hb + b1 + r2[:, None] * w1r
                X3 = _silu(z1)                                  # m1
                z2 = chunked(X3, W2, 0, width) + b2
                X0 = _silu(z2) * valid[:, None]                 # m2
                z3 = chunked(X0, W3, 0, width) + b3
                g1 = _silu(z3)
                gate = torch.zeros(64, dtype=dt)
                for c0 in range(0, H, width):                   # per chunk
                    c = slice(c0, c0 + width)
                    gate = gate + g1[:, c] @ w4[c, 0]
                if not bwd:
                    tr = torch.clamp(cd * gate[:, None], -100.0, 100.0) \
                        * valid[:, None]
                    return torch.cat([X0, tr], -1).view(ATOMS, ATOMS, H + 3)
                raw = cd * gate[:, None]
                inside = ((raw >= -100.0) & (raw <= 100.0)).to(dt)
                dt_ = torch.where(inb[:, None], dfsum[b, ic], 0.0) * inside \
                    * valid[:, None]
                dgate = (cd * dt_).sum(-1)
                dcd = gate[:, None] * dt_
                X2 = (dgate[:, None] * w4[:, 0]) * _dsilu(z3)   # dz3
                if params:
                    dW3.add_(chunked(X0, X2, 2))
                    db3.add_(X2.sum(0))
                    dw4.add_((g1 * dgate[:, None]).sum(0))
                da = torch.where(inb[:, None], dagg[b, ic], 0.0)
                X1 = (chunked(X2, W3, 1, width) + da) * valid[:, None] \
                    * _dsilu(z2)
                if params:
                    dW2.add_(chunked(X3, X1, 2))
                    db2.add_(X1.sum(0))
                dz1 = chunked(X1, W2, 1, width) * _dsilu(z1)
                dr2 = torch.zeros(64, dtype=dt)
                for c0 in range(0, H, width):
                    c = slice(c0, c0 + width)
                    dr2 = dr2 + dz1[:, c] @ w1r[0, c]
                dcd = dcd + 2.0 * cd * dr2[:, None]
                if params:
                    db1.add_(dz1.sum(0))
                    dw1r.add_((dz1 * r2[:, None]).sum(0))
                return torch.cat([dz1, dcd, torch.zeros((64, 1), dtype=dt)],
                                 -1).view(ATOMS, ATOMS, H + 4)

            for jb0 in range(0, nI, step):
                # a round: every tile's products, then the node sums over
                # its tiles, the j-blocks in order
                tiles = [(jb, tile(jb)) for jb in range(jb0, min(jb0 + step,
                                                                 nI))]
                for jb, rows in tiles:
                    if not bwd:
                        sums = rows.sum(1)
                        acci = (0.0 if jb == 0 else acci) + sums[:, :H]
                        fs = (0.0 if jb == 0 else fs) + sums[:, H:]
                        continue
                    for l in range(ATOMS):
                        if ib * ATOMS + l < N:
                            a = ib * ATOMS + l
                            si[b, a] = (0.0 if jb == 0 else si[b, a]) \
                                + rows[l].sum(0)
                        if jb * ATOMS + l < N:
                            pj[b, ib, jb * ATOMS + l] = rows[:, l].sum(0)
            if not bwd:
                n = min(ATOMS, N - ib * ATOMS)
                agg[b, ib * ATOMS:ib * ATOMS + n] = acci[:n]
                fsum[b, ib * ATOMS:ib * ATOMS + n] = fs[:n]
    if not bwd:
        return agg, fsum
    assert not torch.isnan(si).any() and not torch.isnan(pj).any()
    sj = pj.sum(1)                                  # egcl_nf_jsum_kernel
    dpos = si[..., H:H + 3] - sj[..., H:H + 3]
    dh = si[..., :H] @ W1a.T + sj[..., :H] @ W1b.T  # egcl_nf_dh_kernel
    if not params:
        return dh, dpos
    hf = h.reshape(B * N, nf)
    dW1a = hf.T @ si[..., :H].reshape(B * N, H)     # egcl_nf_dw1_kernel
    dW1b = hf.T @ sj[..., :H].reshape(B * N, H)
    tot = part.sum(0)
    dW2, dW3 = tot[:H * H].view(H, H), tot[H * H:2 * H * H].view(H, H)
    dw1r, db1, db2, db3, dw4 = tot[2 * H * H:].view(5, H)
    return (dh, dpos, dW1a, dW1b, dw1r[None], db1[None], dW2, db2[None],
            dW3, db3[None], dw4[:, None])


def _schedule_vs_plain(N, H, ring, directions):
    """:func:`xwide_schedule` at N atoms and width H (ragged molecules,
    periodic boxes, three blocks over the items, so a block walks several
    and adds them into one slice) against the plain version at float64:
    every output of each direction within 1e-12 of its largest value."""
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(N, 4, 3, H, 5 * H)
    for direction in directions:
        if direction == "fwd":
            want = ops.allpairs_edges_plain(h, pos, box, mf, W)
            got = xwide_schedule("fwd", h, pos, box, mf, W, ring=ring)
        else:
            want = ops.allpairs_edges_plain_bwd(
                h, pos, box, mf, W, dagg, dfsum,
                params=direction == "bwd_params")
            got = xwide_schedule(direction, h, pos, box, mf, W, dagg, dfsum,
                                 ring=ring)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w, 1e-12)


@pytest.mark.parametrize("H", [320, 512])
def test_chunked_schedule_matches_plain_f64(H):
    """The emulated schedules at H and 10 atoms (two i-blocks, the second
    short): egcl_xwide_kernel's (K2 p and float32) in every direction, and
    the ring kernels' (bf16 K1 and K2: two j-blocks a round, 128-column
    output chunks, the last 64 wide at H = 320) forward and backward."""
    _schedule_vs_plain(10, H, False, DIRECTIONS)
    _schedule_vs_plain(10, H, True, ("fwd", "bwd"))


@pytest.mark.parametrize("N", [13, 20])
def test_ring_schedule_odd_j_blocks_f64(N):
    """The ring kernels' schedule where an item's j-blocks come out even (N
    = 13: two, one round) and odd (N = 20: three, the second consumer idle
    in the last round), at H = 320 (a last output chunk of 64 columns),
    against the plain version at float64 (1e-12)."""
    assert -(-N // ATOMS) % 2 == (N == 20)
    _schedule_vs_plain(N, 320, True, ("fwd", "bwd"))


def test_chunked_product_orders():
    """Each of the three chunked products equals its full product (X Y
    and X Y^T also in the ring kernels' 128-column chunks, the last of 64
    at 320), and a k-chunk left out (the first of a chunk's sums) is
    seen."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(size=(64, 320)))
    Y = torch.from_numpy(rng.normal(size=(320, 320)))
    Z = torch.from_numpy(rng.normal(size=(64, 320)))
    _close(chunked(X, Y, 0), X @ Y, 1e-12)
    _close(chunked(X, Y, 1), X @ Y.T, 1e-12)
    _close(chunked(X, Z, 2), X.T @ Z, 1e-12)
    _close(chunked(X, Y, 0, RING_COL), X @ Y, 1e-12)
    _close(chunked(X, Y, 1, RING_COL), X @ Y.T, 1e-12)
    Y0 = Y.clone()
    Y0[:COL] = 0.0
    assert not torch.allclose(chunked(X, Y0, 0), X @ Y)


# ---------------------------------------------------------------------------
# (f) shared memory that does not grow with H
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", [0, 1])
def test_xwide_smem_does_not_grow_with_h(code):
    """The mirror of ``egcl_xwide_smem_bytes``: one value for every H from
    64 to the widest, in every direction, within 232,448 bytes; -1 for a
    width the kernels do not take. The bf16 K1 / K2 (the ring kernels)
    hold six 32 KiB stages, K2 p and float32 two steps; the scratch tiles
    a block (``xwide_tiles``) follow the kernel."""
    for kind in mirror.KIND.values():
        sizes = {mirror.xwide_bytes(code, H, kind)
                 for H in range(64, ops.XWIDE_MAX_H + 1, 64)}
        assert len(sizes) == 1
        (size,) = sizes
        assert 0 < size <= LIMIT
        for H in (300, 0, ops.XWIDE_MAX_H + 64):
            assert mirror.xwide_bytes(code, H, kind) == -1
    for kind in mirror.KIND.values():
        ring = code == 1 and kind != mirror.KIND["bwd_params"]
        assert mirror.xwide_on_ring(code, kind) == ring
        assert mirror.xwide_tiles(code, kind) == (10 if ring else 5)
        assert (mirror.xwide_bytes(code, 512, kind) > 6 * 32768) == ring
    # the bf16 block pairs' K2 p at 8 atoms, one warpgroup, at H = 256
    # already takes most of a block: it grows with H, the new route not
    assert mirror.sm90_bytes(8, 5, 256, 2, 1, True) > \
        3 * mirror.xwide_bytes(1, 256, 2)


# ---------------------------------------------------------------------------
# (g) the terms' root-sum-square
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [64, 320])
def test_plain_bwd_l2_terms(H):
    """``allpairs_edges_plain_bwd(..., terms="l2")`` (the root-sum-square
    of each parameter gradient's terms, the rounding scale chip_smoke.py
    reads the bf16 kernels past 256 with): the same dh and dpos; each of
    the nine at most the sum of its terms' magnitudes and at least that
    sum over the root of the number of terms (B N^2 edges); unchanged
    when dagg and dfsum are negated; over a batch the root of the sum of
    each molecule's own squared, at float64."""
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(9, 4, 5, H, 3 * H)
    args = (h, pos, box, mf, W)
    l1 = ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True,
                                      terms=True)
    l2 = ops.allpairs_edges_plain_bwd(*args, dagg, dfsum, params=True,
                                      terms="l2")
    flipped = ops.allpairs_edges_plain_bwd(*args, -dagg, -dfsum, params=True,
                                           terms="l2")
    for g, m in zip(l1[:2], l2[:2]):
        assert torch.equal(g, m)
    parts = [ops.allpairs_edges_plain_bwd(
        *(t[b:b + 1] for t in (h, pos, box, mf)), W, dagg[b:b + 1],
        dfsum[b:b + 1], params=True, terms="l2")[2:] for b in range(4)]
    edges = 4 * 9 * 9
    for k, (a, m, f) in enumerate(zip(l1[2:], l2[2:], flipped[2:])):
        scale = float(a.abs().max())
        assert scale > 0 and a.shape == m.shape
        assert bool((m <= a + 1e-12 * scale).all())
        assert bool((m * math.sqrt(edges) >= a - 1e-12 * scale).all())
        _close(f, m, 1e-12)
        _close(sum(part[k] ** 2 for part in parts).sqrt(), m, 1e-12)


# ---------------------------------------------------------------------------
# (h) copies of misaligned inputs outlive the launch
# ---------------------------------------------------------------------------

class _Entries:
    """A library's entry points on the CPU: each call records its name and
    whether every copy made by ``ops._aligned`` so far is still alive,
    and succeeds; the size functions the launch code reads."""

    def __init__(self, made, calls):
        self.made, self.calls = made, calls

    def egcl_part_size(self, nf, H):
        return 2 * H * H + 2 * nf * H + 5 * H

    def egcl_sm90_slice_floats(self, nf, H):
        return self.egcl_part_size(nf, H) + 64

    def egcl_sm90_blocks_param_slices(self, B, N, A, nwg, blocks):
        return 3

    def egcl_xwide_grid(self, B, N, H, kind, blocks):
        return 2

    def egcl_xwide_tiles(self, code, kind):
        return mirror.xwide_tiles(code, kind)

    def __getattr__(self, name):
        if name.endswith("_splits"):
            return lambda *args: 2
        if name.endswith(("_fwd", "_bwd", "_bwd_params")):
            def entry(*args):
                self.calls.append(
                    (name, all(r() is not None for r in self.made)))
                return 0
            return entry
        raise AttributeError(name)


class _Sm90(_Entries, StubSm90):
    pass


class _F32(_Entries, StubF32):
    pass


@pytest.mark.parametrize("direction", ["fwd", "bwd", "bwd_params"])
@pytest.mark.parametrize("route,H", [("xwide", 320), ("f32_xwide", 320),
                                     ("wide_nf", 128),
                                     ("f32_wide_nf", 128)])
def test_misaligned_input_copies_outlive_the_launch(monkeypatch, route, H,
                                                     direction):
    """h, pos and the mask as batch slices (13 atoms of 5 bf16 / f32
    features, 3 f32 coordinates, one mask value: 130 / 260, 156 and 26 /
    52 bytes a molecule, so none starts on 16 bytes): ``_aligned`` copies
    them, and every copy is
    still referenced when the entry point is called (a copy freed before
    could hand its memory to the launch's scratch). The outputs have the
    contract's shapes."""
    made, calls = [], []
    sm90, f32 = _Sm90(made, calls), _F32(made, calls)
    for name, lib in (("_sm90_library", sm90), ("_f32_library", f32),
                      ("_xwide_library", sm90)):
        monkeypatch.setattr(ops, name, lambda lib=lib: lib)
    monkeypatch.setattr(ops, "_plans", {})
    monkeypatch.setattr(ops, "multiprocessors", lambda device: 4)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    aligned = ops._aligned

    def tracking(t):
        out = aligned(t)
        if out is not t:
            made.append(weakref.ref(out))
        return out

    monkeypatch.setattr(ops, "_aligned", tracking)
    dtype = torch.float32 if route.startswith("f32") else torch.bfloat16
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(13, 4, 5, H, 3,
                                                 torch.float32)
    h, mf, dagg, dfsum = (t.to(dtype) for t in (h, mf, dagg, dfsum))
    W = tuple(w.to(dtype) for w in W)
    # each batch-shaped input a slice from its second molecule on
    cut = lambda t: torch.cat([t[:1], t])[1:]
    h, pos, mf = (cut(t) for t in (h, pos, mf))
    assert all(t.data_ptr() % 16 for t in (h, pos, mf))
    out = ops._run(direction, route, h, pos, box, mf, W, dagg, dfsum)
    entry = ("egcl_xwide_" if "xwide" in route else
             "egcl_f32_wide_nf_" if route.startswith("f32") else
             "egcl_sm90_wide_nf_") + direction
    assert calls == [(entry, True)]
    assert len(made) == 3
    B, N, nf = h.shape
    want = [(B, N, H), (B, N, 3)] if direction == "fwd" else \
        [(B, N, nf), (B, N, 3)]
    if direction == "bwd_params":
        want += [tuple(w.shape) for w in W]
    assert [tuple(t.shape) for t in out] == want


@pytest.mark.parametrize("route,H", [("xwide", 320), ("f32_xwide", 320),
                                     ("wide_nf", 128),
                                     ("f32_wide_nf", 128)])
def test_empty_batch_gives_zero_parameter_gradients(monkeypatch, route, H):
    """K2 p of no molecules on the routes on the per-atom projections: no
    entry point is called and each of the nine parameter gradients is
    zero (dW1's one split and the slices are zeroed, not left as they
    were allocated)."""
    calls = []
    sm90, f32 = _Sm90([], calls), _F32([], calls)
    for name, lib in (("_sm90_library", sm90), ("_f32_library", f32),
                      ("_xwide_library", sm90)):
        monkeypatch.setattr(ops, name, lambda lib=lib: lib)
    monkeypatch.setattr(ops, "_plans", {})
    monkeypatch.setattr(ops, "multiprocessors", lambda device: 4)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    dtype = torch.float32 if route.startswith("f32") else torch.bfloat16
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(13, 4, 5, H, 5,
                                                 torch.float32)
    h, mf, dagg, dfsum = (t[:0].to(dtype) for t in (h, mf, dagg, dfsum))
    W = tuple(w.to(dtype) for w in W)
    out = ops._run("bwd_params", route, h, pos[:0], box[:0], mf, W, dagg,
                   dfsum)
    assert calls == []
    assert [tuple(t.shape) for t in out[2:]] == [tuple(w.shape) for w in W]
    for g in out[2:]:
        assert not bool(g.any())

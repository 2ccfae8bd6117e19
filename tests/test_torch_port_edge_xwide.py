"""Port parity: the gathered-edge EGCL (K5/K6) past H = 256, and at every C.

``ops/edge_pipeline.py`` sends every launch whose padded width
(``padded_width``: past 256 the next multiple of 64) is past 256, and every
launch at 64 .. 256 whose C edge features the block of that width's route
does not hold, to the kernels of ``csrc/edge_pipeline_xwide.cu``: route
``"xwide"`` (bf16, wgmma) and ``"f32_xwide"`` (float32, FMA). A tile is 64
edge rows (whole atoms where K <= 64, else an atom over several tiles);
every product, the first layer e W1 and the backward's de and dW1 among
them, runs in 64 x 64 output chunks over k-chunks, so H and C enter only as
loop counts; the H-wide activations live in global memory. Here, on the
CPU:

- (a) zero-padding is exact at float64 (H = 300 at 320, 512 at 576);
- (b) the plain version at H = 384 against the Pallas K5/K6 of
  ``enflow_tpu/ops/edge_kernel.py`` in interpret mode, float32, with all
  seven parameter gradients;
- (c) the slice as a whole against the JAX package at float64, parameters
  carried across by ``utils/jax_params``: train.yaml's NLL (images mode)
  and its parameter gradients at ``hidden_nf`` 320, and a top-k flow-VI
  loss with its gradients at 320;
- (d) the kernels' schedule emulated in plain PyTorch at float64 against
  the plain version (1e-12): the Hopper kernels' tile plan at one block a
  work item's owner, every product one 64 x 64 chunk at a time (the
  C-chunked e W1, de and dW1 too), the K-sums of an atom carried across its
  tiles, one f32 slice a block summed in order; at H = 320 and 512, K =
  12, 24, 56, 80 and C = 3, 11, 33, 129;
- (e) the kernels' shared memory mirrored in Python
  (``tests/egcl_smem_mirror.py``): the same at every H and C, within the
  card's 232,448 bytes;
- (f) the route rule and the launch code on stub libraries: every H in
  257 .. 1024 on the xwide routes, no C refused up to the widest H, the
  old routes where they hold C, only a width past 11,520 refused (naming
  ROADMAP B7.5 and the bytes); a misaligned batch slice's copy alive when
  the entry point is called; seven zero gradients at A = 0; the counters.

The kernels themselves run on the card only (``chip_smoke.py``, phase
edge_xwide). Inputs are made with numpy from a seed.
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
from test_torch_port_edge_widths import SizeLib, _f64, _scaled_inputs

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow.integrators import FlowConfig as JFlowConfig
from enflow_tpu.flow.integrators import forward as j_forward
from enflow_tpu.flow.integrators import init_flow as j_init_flow
from enflow_tpu.flow.loss import alchemical_nll as j_nll
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.ops.edge_kernel import fused_edge_pipeline as j_pipeline
from enflow_tpu.sample import targets as jtargets
from enflow_tpu.sample.vi import flow_vi_loss as j_flow_vi_loss
from enflow_tpu.sample.vi import make_system_target as j_system_target

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, forward
from enflow_tpu_torch.flow.loss import alchemical_nll
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import edge_pipeline as ops
from enflow_tpu_torch.sample import targets as ttargets
from enflow_tpu_torch.sample.vi import flow_vi_loss, make_system_target
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten
from torch_threads import one_torch_thread  # noqa: F401

LIMIT = 232448                   # shared memory a block may use
ROWS = 64                        # edge rows a tile (kRows)
COL = 64                         # output columns / k a chunk (kCol)
OUT = ("agg", "F_sum", "de", "dcd", "dW1", "db1", "dW2", "db2", "dW3",
       "db3", "dw4")


def _close(got, want, tol):
    """|got - want| within ``tol`` of want's largest magnitude."""
    assert got.shape == want.shape
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got - want).abs().max())
    assert diff <= tol * max(scale, 1e-300), diff / max(scale, 1e-300)


def _plain_all(e, cd, em, W, dagg, dfs):
    return (ops.edge_pipeline_plain(e, cd, em, *W)
            + ops.edge_pipeline_plain_bwd(e, cd, em, *W, dagg, dfs))


def _f64_case(A, K, C, H, seed):
    e, cd, em, ws, dagg, dfs = _scaled_inputs(A, K, C, H, seed)
    return (_f64(e), _f64(cd), torch.from_numpy(em).double(),
            [_f64(w) for w in ws], _f64(dagg), _f64(dfs))


# ---------------------------------------------------------------------------
# (a) zero-padding past 256 is exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,Hp", [(300, 320), (512, 576)])
def test_padding_past_256_is_exact_f64(H, Hp):
    """The plain forward and backward on weights (and dagg) zero-padded to
    Hp, cut back, equal the unpadded call at float64 (1e-12 of each
    output's largest value); the padded columns of agg and of every
    gradient are exact zeros. H = 300 pads to its launch width 320."""
    if H == 300:
        assert ops.padded_width(H) == Hp
    e, cd, em, W, dagg, dfs = _f64_case(6, 7, 5, H, H + 3)
    Wp = ops.pad_weights(W, Hp)
    want = _plain_all(e, cd, em, W, dagg, dfs)
    fwd = ops.edge_pipeline_plain(e, cd, em, *Wp)
    bwd = ops.edge_pipeline_plain_bwd(e, cd, em, *Wp, ops.pad_rows(dagg, Hp),
                                      dfs)
    assert float(fwd[0][:, H:].abs().max()) == 0.0
    for g in bwd[2:]:
        pad = g[..., H:] if g.shape[-1] == Hp else g[H:]
        assert not bool(pad.any())
    got = (fwd[0][:, :H], fwd[1]) + bwd[:2] + ops.unpad_grads(bwd[2:], H)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


# ---------------------------------------------------------------------------
# (b) the plain version at H = 384 against the Pallas kernels
# ---------------------------------------------------------------------------

def test_plain_at_384_matches_pallas_f32():
    """``fused_edge_pipeline`` on the CPU (the plain version that
    chip_smoke.py holds the xwide kernels against) and the Pallas K5/K6 in
    interpret mode with their VJP at float32, H = 384: forward at rtol
    2e-5 / atol 2e-6, de and dcd at rtol 5e-5 / atol 5e-6, the seven
    parameter gradients at rtol 5e-5 / atol 5e-6 of their largest value
    (summation order only; test_torch_port_egcl_xwide.py's form at 384)."""
    H = 384
    e, cd, em, ws, dagg, dfs = _scaled_inputs(5, 8, 5, H, H)
    J = lambda a: jnp.asarray(np.asarray(a, np.float32))
    jargs = [J(e), J(cd)] + [J(w) for w in ws]
    jem = jnp.asarray(em)
    jout, vjp = jax.vjp(lambda a, b, *w: j_pipeline(a, b, jem, *w), *jargs)
    jgrads = vjp((J(dagg), J(dfs)))
    T = lambda a: torch.from_numpy(np.array(a, np.float32)).requires_grad_()
    targs = [T(a) for a in jargs]
    ops.counts.reset()
    tout = ops.fused_edge_pipeline(targs[0], targs[1], torch.from_numpy(em),
                                   *targs[2:])
    tgrads = torch.autograd.grad(tout, targs, (T(dagg), T(dfs)))
    assert (ops.counts.plain_fwd_calls, ops.counts.plain_bwd_calls) == (1, 1)
    assert tout[0].shape == (5, H)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=2e-5, atol=2e-6)
    for name, j, t in zip(OUT[2:], jgrads, tgrads):
        j = np.asarray(j)
        scale = 1.0 if name in ("de", "dcd") else np.abs(j).max()
        np.testing.assert_allclose(t.numpy(), j, rtol=5e-5,
                                   atol=5e-6 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# (c) the slice as a whole against JAX at hidden_nf 320
# ---------------------------------------------------------------------------

def test_nll_value_and_grad_at_320_matches_jax_f64():
    """train.yaml's objective at hidden_nf 320: one NLL value and gradient
    (images mode, 2 flow steps, 4 molecules of 5 atoms, a padded atom and
    a dummy molecule) through the kernel contract's plain version, against
    ``jax.value_and_grad`` of the JAX flow's NLL (rel 1e-9)."""
    from test_torch_port_train import KBT, SOFT, _batch
    H = 320
    d = _batch(2)
    kw = dict(n_iter=2, dt=0.1, nbr_mode="images", nbr_capacity=40,
              track_overflow=True)
    jcfg = JFlowConfig(egcl=JEGCLConfig(2, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(2, H, use_pallas=True), **kw)
    jp = j_init_flow(jax.random.PRNGKey(5), jcfg, jnp.float64)
    jb = JSystem(**{k: jnp.asarray(v) for k, v in d.items()})
    key = jax.random.PRNGKey(9)

    def nll_fn(p):
        out, ldj, ovf = j_forward(p, jcfg, jb, key)
        return j_nll(out, ldj, KBT, SOFT, num_log_gaussian_calls=3), ovf

    (jloss, _), jgrads = jax.value_and_grad(nll_fn, has_aux=True)(jp)
    eps = np.array(jax.random.normal(key, d["h"].shape, jnp.float64))
    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = System(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    ops.counts.reset()
    out, ldj, _ = forward(tp, tcfg, tb, eps=torch.from_numpy(eps))
    loss = alchemical_nll(out, ldj, KBT, SOFT, num_log_gaussian_calls=3)
    grads = torch.autograd.grad(loss, leaves)
    assert ops.counts.plain_fwd_calls > 0 and ops.counts.plain_bwd_calls > 0
    assert any(tuple(t.shape[-2:]) == (H, H) for t in leaves)   # W2, W3
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-9)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for want, got in zip(jl, grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_topk_flow_vi_loss_at_320_matches_jax_f64():
    """The reverse-KL VI loss of an LJ6 cluster in top-k mode (capacity 4
    of 5 neighbours, so the gathered rows drop one; nf=3, 2 flow steps,
    two particles) and every parameter gradient at ``hidden_nf`` 320,
    through the gathered EGCL's plain version, against the JAX package's
    XLA path at float64 (1e-9)."""
    NF, H, P, N = 3, 320, 2, 6
    kw = dict(n_iter=2, dt=0.05, nbr_mode="topk", nbr_capacity=4)
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, H, use_pallas=True), **kw)
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
    ops.counts.reset()
    tl, _ = flow_vi_loss(tp, tcfg, tbatch, tt)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    assert ops.counts.plain_fwd_calls > 0 and ops.counts.plain_bwd_calls > 0
    assert any(tuple(t.shape[-2:]) == (H, H) for t in leaves)   # W2, W3
    assert np.isfinite(float(jl))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-9)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


# ---------------------------------------------------------------------------
# (d) the kernels' schedule, one product a chunk
# ---------------------------------------------------------------------------

def _silu(x):
    return x * torch.sigmoid(x)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def chunked(X, Y, mode, K=None):
    """The product of the engines (xwide_engine.cuh), one 64 x 64 output
    chunk at a time, each summed over its k-chunks of 64 in order: mode 0
    X [64, K] Y [K, N], 1 X [64, K] Y^T for Y [N, K], 2 X^T Y for X [64,
    M], Y [64, N] (the tile's rows the k). ``K``: the k a product covers
    (the rest of X's and Y's k is zero)."""
    if mode == 2:
        M, N = X.shape[1], Y.shape[1]
        out = torch.zeros((M, N), dtype=X.dtype)
        for m0 in range(0, M, COL):
            for n0 in range(0, N, COL):
                out[m0:m0 + COL, n0:n0 + COL] = (X[:, m0:m0 + COL].T
                                                 @ Y[:, n0:n0 + COL])
        return out
    K = X.shape[1] if K is None else K
    N = Y.shape[1] if mode == 0 else Y.shape[0]
    out = torch.zeros((X.shape[0], N), dtype=X.dtype)
    for n0 in range(0, N, COL):
        acc = torch.zeros((X.shape[0], COL), dtype=X.dtype)
        for k0 in range(0, K, COL):
            w = (Y[k0:k0 + COL, n0:n0 + COL] if mode == 0
                 else Y[n0:n0 + COL, k0:k0 + COL].T)
            acc = acc + X[:, k0:k0 + COL] @ w
        out[:, n0:n0 + COL] = acc
    return out


def xwide_schedule(direction, e, cd, em, W, dagg=None, dfs=None, n_sm=3):
    """The xwide kernels' work at float64 in their order: the tile plan of
    ``ops.sm90_plan`` at one warpgroup a block (``n_sm`` blocks at most),
    each block's work items (a tile of whole atoms, or an atom's tiles)
    walked in turn, e copied into a [64, Cp] tile (Cp: C rounded up to
    64) and W1 zero-padded to [Cp, H]; returns the outputs of
    ``edge_pipeline_plain`` / ``_plain_bwd``."""
    W1, b1, W2, b2, W3, b3, w4 = W
    A, K, C = e.shape
    H = W2.shape[1]
    dt = e.dtype
    Cp = COL * math.ceil(C / COL)
    W1p = torch.cat([W1, torch.zeros((Cp - C, H), dtype=dt)])
    apt, tpa, units, blocks = ops.sm90_plan(A, K, 1, n_sm)
    bwd = direction == "bwd"
    rows_e, rows_cd = e.reshape(A * K, C), cd.reshape(A * K, 3)
    rows_em = em.reshape(A * K)
    agg = torch.full((A, H), float("nan"), dtype=dt)
    fs = torch.full((A, 3), float("nan"), dtype=dt)
    de = torch.full((A * K, C), float("nan"), dtype=dt)
    dcd = torch.full((A * K, 3), float("nan"), dtype=dt)
    P = C * H + 2 * H * H + 4 * H
    part = torch.full((blocks, P), float("nan"), dtype=dt)
    for b in range(blocks):
        sl = part[b]
        sl.zero_()
        dW1 = sl[:C * H].view(C, H)
        dW2 = sl[C * H:C * H + H * H].view(H, H)
        dW3 = sl[C * H + H * H:C * H + 2 * H * H].view(H, H)
        dw4, db1, db2, db3 = sl[C * H + 2 * H * H:].view(4, H)
        for u in range(b, units, blocks):
            tiles = ([(u * apt, min(apt, A - u * apt), u * apt * K,
                       min(apt, A - u * apt) * K)] if apt else
                     [(u, 1, u * K + ROWS * t, min(ROWS, K - ROWS * t))
                      for t in range(tpa)])
            acc = torch.zeros(H + 3, dtype=dt)
            for t, (a0, na, g0, nr) in enumerate(tiles):
                ep = torch.zeros((ROWS, Cp), dtype=dt)
                ep[:nr, :C] = rows_e[g0:g0 + nr]
                cdt = torch.zeros((ROWS, 3), dtype=dt)
                cdt[:nr] = rows_cd[g0:g0 + nr]
                emt = torch.zeros(ROWS, dtype=dt)
                emt[:nr] = rows_em[g0:g0 + nr]
                atom = torch.full((ROWS,), -1)
                atom[:nr] = (a0 + torch.arange(nr) // K if apt
                             else torch.full((nr,), a0))
                pre1 = chunked(ep, W1p, 0, 16 * math.ceil(C / 16)) + b1
                m1 = _silu(pre1)
                pre2 = chunked(m1, W2, 0) + b2
                m = _silu(pre2) * emt[:, None]
                pre3 = chunked(m, W3, 0) + b3
                g1 = _silu(pre3)
                gate = torch.zeros(ROWS, dtype=dt)
                for o in range(H // COL):                  # per chunk
                    c = slice(COL * o, COL * o + COL)
                    gate = gate + g1[:, c] @ w4[c, 0]
                tr = torch.clamp(cdt * gate[:, None], -100.0, 100.0) \
                    * emt[:, None]
                if not bwd:
                    rows = torch.cat([m, tr], -1)
                    if apt:
                        sums = rows[:na * K].view(na, K, H + 3).sum(1)
                        agg[a0:a0 + na], fs[a0:a0 + na] = sums[:, :H], \
                            sums[:, H:]
                    else:
                        acc = (0.0 if t == 0 else acc) + rows[:nr].sum(0)
                        if t == len(tiles) - 1:
                            agg[a0], fs[a0] = acc[:H], acc[H:]
                    continue
                inb = atom >= 0
                ai = atom.clamp(min=0)
                raw = cdt * gate[:, None]
                inside = ((raw > -100.0) & (raw < 100.0)).to(dt)
                dtr = torch.where(inb[:, None], dfs[ai], 0.0) * inside \
                    * emt[:, None]
                dg = (cdt * dtr).sum(-1)
                dcd[g0:g0 + nr] = (gate[:, None] * dtr)[:nr]
                dpre3 = (dg[:, None] * w4[:, 0]) * _dsilu(pre3)
                db3 += dpre3.sum(0)
                dw4 += (g1 * dg[:, None]).sum(0)
                dW3 += chunked(m, dpre3, 2)
                da = torch.where(inb[:, None], dagg[ai], 0.0)
                dpre2 = (da + chunked(dpre3, W3, 1)) * emt[:, None] \
                    * _dsilu(pre2)
                db2 += dpre2.sum(0)
                dW2 += chunked(m1, dpre2, 2)
                dpre1 = chunked(dpre2, W2, 1) * _dsilu(pre1)
                db1 += dpre1.sum(0)
                dW1 += chunked(ep, dpre1, 2)[:C]
                de[g0:g0 + nr] = chunked(dpre1, W1p, 1)[:nr, :C]
    if not bwd:
        return agg, fs
    assert not torch.isnan(part).any()
    tot = part.sum(0)
    return (de.view(A, K, C), dcd.view(A, K, 3), tot[:C * H].view(C, H),
            tot[C * H + 2 * H * H + H:C * H + 2 * H * H + 2 * H],
            tot[C * H:C * H + H * H].view(H, H),
            tot[C * H + 2 * H * H + 2 * H:C * H + 2 * H * H + 3 * H],
            tot[C * H + H * H:C * H + 2 * H * H].view(H, H),
            tot[C * H + 2 * H * H + 3 * H:],
            tot[C * H + 2 * H * H:C * H + 2 * H * H + H].view(H, 1))


@pytest.mark.parametrize("H,K,C", [(320, 12, 3), (320, 24, 11),
                                   (320, 56, 33), (320, 80, 129),
                                   (512, 12, 129), (512, 24, 33),
                                   (512, 56, 11), (512, 80, 3)])
def test_chunked_schedule_matches_plain_f64(H, K, C):
    """The emulated schedule (:func:`xwide_schedule`) at every H of 320 and
    512, K of 12, 24, 56 (whole atoms a tile: 5, 2 and 1) and 80 (an atom
    over two tiles), C of 3, 11, 33 and 129 (e W1, de and dW1 over one to
    three 64-chunks of features) against the plain version at float64:
    every output within 1e-12 of its largest value. Three blocks over the
    work items, so a block adds several into its slice; A leaves the last
    tile short."""
    A = 2 * (ROWS // K) + 1 if K <= ROWS else 4
    e, cd, em, W, dagg, dfs = _f64_case(A, K, C, H, H + K + C)
    want = _plain_all(e, cd, em, W, dagg, dfs)
    got = (xwide_schedule("fwd", e, cd, em, W)
           + xwide_schedule("bwd", e, cd, em, W, dagg, dfs))
    assert len(got) == len(want) == len(OUT)
    for name, g, w in zip(OUT, got, want):
        assert g.shape == w.shape, name
        _close(g, w, 1e-12)


def test_chunked_products_see_each_chunk():
    """The chunked products equal the full ones, and a k-chunk of e past
    the first (C = 129: three chunks) or a column chunk of the output left
    out is seen."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(size=(64, 192)))
    Y = torch.from_numpy(rng.normal(size=(192, 320)))
    Z = torch.from_numpy(rng.normal(size=(64, 320)))
    _close(chunked(X, Y, 0), X @ Y, 1e-12)
    X0 = X.clone()
    X0[:, 144:] = 0.0                       # e's features past C are zero
    _close(chunked(X0, Y, 0, K=144), X0 @ Y, 1e-12)
    _close(chunked(Z, Y, 1), Z @ Y.T, 1e-12)
    _close(chunked(X, Z, 2), X.T @ Z, 1e-12)
    X1 = X.clone()
    X1[:, 64:128] = 0.0
    assert not torch.allclose(chunked(X1, Y, 0), X @ Y)


# ---------------------------------------------------------------------------
# (e) shared memory that grows with neither H nor C
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", [0, 1])
def test_edge_xwide_smem_does_not_grow(code):
    """The mirror of ``edge_xwide_smem_bytes``: one value for every H from
    64 to the widest and every C, in both directions, within 232,448
    bytes; -1 for a width or C the kernels do not take. The Hopper
    kernels' block at H = 256 grows with C; the new one does not."""
    sizes = {mirror.edge_xwide_bytes(code, C, H, bwd)
             for H in range(64, ops.XWIDE_MAX_H + 1, 64)
             for C in (1, 3, 11, 33, 64, 65, 129, 1000) for bwd in (0, 1)}
    assert len(sizes) == 1
    (size,) = sizes
    assert 0 < size <= LIMIT
    for C, H in ((3, 300), (3, 0), (3, ops.XWIDE_MAX_H + 64), (0, 320)):
        assert mirror.edge_xwide_bytes(code, C, H, 0) == -1
    lib = SizeLib()
    assert lib.edge_sm90_smem_bytes(48, 256, 1, 1) > 6 * size


# ---------------------------------------------------------------------------
# (f) the route rule and the launch code on stub libraries
# ---------------------------------------------------------------------------

DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture
def size_libs(monkeypatch):
    """The libraries' size entry points on the CPU (test_torch_port_edge_
    widths.SizeLib, mirrors of the kernels' carves)."""
    lib = SizeLib()
    monkeypatch.setattr(ops, "_sm90_library", lambda: lib)
    monkeypatch.setattr(ops, "_library", lambda: lib)
    monkeypatch.setattr(ops, "_held", {})
    return lib


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_width_past_256_takes_the_xwide_route(dtype, size_libs):
    """Every H in 257 .. 1024 pads to the next multiple of 64 and goes to
    the dtype's xwide route, with or without C, in both directions."""
    route = ops.XWIDE_ROUTE[dtype]
    for H in range(257, 1025):
        Hp = ops.padded_width(H)
        assert Hp % 64 == 0 and H <= Hp < H + 64
        assert ops.kernel_for(dtype, H) == route
        for direction in ("fwd", "bwd"):
            assert ops.kernel_for(dtype, H, 3, direction) == route


@pytest.mark.parametrize("dtype", DTYPES)
def test_no_c_is_refused_up_to_the_widest(dtype, size_libs):
    """At every width up to XWIDE_MAX_H and every C, a launch has a route;
    where the route of 64 .. 256 holds C it keeps it (bf16 C <= 64 and the
    block fits, f32 a block of 1 atom and 8 rows fits), else the xwide
    route at the same padded width."""
    xw = ops.XWIDE_ROUTE[dtype]
    code = ops._DTYPE_CODE[dtype]
    for H in (1, 20, 64, 100, 128, 160, 192, 256, 257, 1024, 11520):
        Hp = ops.padded_width(H)
        old = ops.kernel_for(dtype, H)
        for C in (1, 3, 11, 33, 48, 49, 64, 65, 79, 129, 160, 1000):
            for direction in ("fwd", "bwd"):
                bwd = int(direction == "bwd")
                got = ops.kernel_for(dtype, H, C, direction)
                if Hp > 256:
                    assert got == xw
                elif dtype == torch.bfloat16:
                    holds = (C <= size_libs.edge_sm90_c_max() and
                             size_libs.edge_sm90_warpgroups(C, Hp, bwd) > 0)
                    assert got == (old if holds else xw), (H, C, direction)
                else:
                    holds = size_libs.edge_tiled_smem_bytes(
                        code, C, Hp, 1, 8, bwd) <= LIMIT
                    assert got == (old if holds else xw), (H, C, direction)


@pytest.mark.parametrize("dtype,H,C,direction,want", [
    (torch.bfloat16, 128, 11, "bwd", "sm90"),
    (torch.bfloat16, 128, 64, "fwd", "sm90"),
    (torch.bfloat16, 128, 65, "fwd", "xwide"),
    (torch.bfloat16, 256, 48, "bwd", "wide"),
    (torch.bfloat16, 256, 49, "bwd", "xwide"),
    (torch.bfloat16, 256, 49, "fwd", "wide"),
    (torch.float32, 128, 78, "bwd", "tiled"),
    (torch.float32, 128, 79, "bwd", "f32_xwide"),
    (torch.float32, 128, 160, "fwd", "f32_xwide"),
    (torch.float32, 256, 32, "bwd", "f32_wide"),
    (torch.float32, 256, 33, "bwd", "f32_xwide")])
def test_c_limits_route_to_xwide(dtype, H, C, direction, want, size_libs):
    """The old C limits (ROADMAP B7.3): the last C each route of 64 .. 256
    holds keeps its route, the next goes to the xwide route of the dtype
    at the same padded width (the cases chip_smoke.py launches)."""
    assert ops.kernel_for(dtype, H, C, direction) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_past_the_widest_refuses_naming_b7_5(dtype):
    """Past XWIDE_MAX_H a launch is refused at every C, naming ROADMAP B7.5
    and the bytes one slice of the parameter gradients would need at C =
    1 (more than 1 GiB); the widest is taken."""
    assert mirror.xwide_max_width() == ops.XWIDE_MAX_H
    assert ops.kernel_for(dtype, ops.XWIDE_MAX_H) == ops.XWIDE_ROUTE[dtype]
    for H in (ops.XWIDE_MAX_H + 1, 20000):
        with pytest.raises(ValueError, match="B7.5") as e:
            ops.kernel_for(dtype, H, 3, "bwd")
        msg = str(e.value)
        assert ops.XWIDE_ITEM in msg and f"H={H}" in msg
        need = int(msg.split("need at least ")[1].split(" bytes")[0]
                   .replace(",", ""))
        Hp = ops.padded_width(H)
        assert need == 4 * (1 * Hp + 2 * Hp * Hp + 4 * Hp)
        assert need > ops.XWIDE_SLICE_BYTES


class _StubXwide:
    """edge_pipeline_xwide.cu's entry points on the CPU: each launch
    records its name and whether every copy made by ``ops._aligned`` so
    far is still alive, and succeeds; the size functions the launch code
    reads."""

    def __init__(self, made, calls):
        self.made, self.calls = made, calls

    def edge_xwide_grid(self, units, C, H, bwd, blocks):
        return min(units, blocks)

    def edge_xwide_part_floats(self, C, H):
        return C * H + 2 * H * H + 4 * H

    def edge_xwide_error_string(self, err):
        return b"invalid argument"

    def _launch(self, name):
        self.calls.append((name, all(r() is not None for r in self.made)))
        return 0

    def edge_xwide_fwd(self, *args):
        return self._launch("edge_xwide_fwd")

    def edge_xwide_bwd(self, *args):
        return self._launch("edge_xwide_bwd")


@pytest.fixture
def stub_xwide(monkeypatch):
    """The xwide library replaced by :class:`_StubXwide`, 4
    multiprocessors, a stream of the CPU, and ``ops._aligned``'s copies
    tracked: returns (the copies' weak references, the calls)."""
    from enflow_tpu_torch.ops import build
    made, calls = [], []
    lib = _StubXwide(made, calls)
    monkeypatch.setattr(ops, "_xwide_library", lambda: lib)
    monkeypatch.setattr(build, "multiprocessors", lambda device: 4)
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
    return made, calls


def _inputs(A, K, C, H, dtype, seed=5):
    e, cd, em, ws, dagg, dfs = _scaled_inputs(A, K, C, H, seed)
    c = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return (c(e), c(cd), torch.from_numpy(em).to(dtype),
            tuple(c(w) for w in ws), c(dagg), c(dfs))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_misaligned_input_copies_outlive_the_launch(stub_xwide, dtype,
                                                    direction):
    """e, cd and the mask as batch slices (5 slots of 3 features, 3
    coordinates and one mask value an atom: 30 / 60, 30 / 60 and 10 / 20
    bytes, so none starts on 16 bytes): ``_aligned`` copies them, and every
    copy is still referenced when the entry point is called (a copy freed
    before could hand its memory to the launch's scratch); the outputs
    have the contract's shapes."""
    made, calls = stub_xwide
    A, K, C, H = 7, 5, 3, 320
    e, cd, em, W, dagg, dfs = _inputs(A + 1, K, C, H, dtype)
    e, cd, em, dagg, dfs = (t[1:] for t in (e, cd, em, dagg, dfs))
    assert all(t.data_ptr() % 16 for t in (e, cd, em))
    out = ops._run(direction, ops.XWIDE_ROUTE[dtype], e, cd, em, W, dagg,
                   dfs)
    assert calls == [(f"edge_xwide_{direction}", True)]
    assert len(made) >= 3
    want = ([(A, H), (A, 3)] if direction == "fwd" else
            [(A, K, C), (A, K, 3)] + [tuple(w.shape) for w in W])
    assert [tuple(t.shape) for t in out] == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_batch_gives_zero_parameter_gradients(stub_xwide, dtype):
    """K6 of no atoms on the xwide route (H = 320): no entry point is
    called, no launch is counted, and each of the seven parameter
    gradients is zero in its weight's shape."""
    made, calls = stub_xwide
    e, cd, em, W, dagg, dfs = _inputs(4, 12, 11, 320, dtype)
    e, cd, em, dagg, dfs = (t[:0] for t in (e, cd, em, dagg, dfs))
    ops.counts.reset()
    out = ops._launch("fwd", e, cd, em, W) + ops._launch(
        "bwd", e, cd, em, W, dagg, dfs)
    assert calls == []
    assert [tuple(t.shape) for t in out] == [(0, 320), (0, 3), (0, 12, 11),
                                             (0, 12, 3)] + [
        tuple(w.shape) for w in W]
    for g in out[4:]:
        assert not bool(g.any())
    assert not any(v for k, v in vars(ops.counts).items()
                   if not k.startswith("_"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", [300, 512])
def test_counters_move_on_the_xwide_route(stub_xwide, dtype, H):
    """One K5 and one K6 through the wrapper at H (300 runs at its padded
    320): each on the dtype's xwide counter and the totals, a padded one
    on ``padded_*`` too; the entry points see the padded width; no other
    counter moves."""
    made, calls = stub_xwide
    e, cd, em, W, dagg, dfs = _inputs(6, 12, 11, H, dtype)
    route = ops.XWIDE_ROUTE[dtype]
    ops.counts.reset()
    agg, fs = ops._launch("fwd", e, cd, em, W)
    grads = ops._launch("bwd", e, cd, em, W, dagg, dfs)
    assert agg.shape == (6, H) and grads[2].shape == (11, H)
    assert [c[0] for c in calls] == ["edge_xwide_fwd", "edge_xwide_bwd"]
    got = {k: v for k, v in vars(ops.counts).items()
           if not k.startswith("_") and v}
    want = {f"{route}_fwd_launches": 1, f"{route}_bwd_launches": 1,
            "fwd_launches": 1, "bwd_launches": 1}
    if ops.padded_width(H) != H:
        want.update(padded_fwd_launches=1, padded_bwd_launches=1)
    assert got == want
    ops.counts.reset()

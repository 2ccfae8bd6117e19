"""The gathered-edge EGCL (K5/K6) at every hidden width up to 256: what of
it runs on the CPU.

- The port's gathered ``apply_egcl`` with ``use_pallas`` on (the kernel
  contract's plain version) at hidden_nf 192, 256, 96 and 160 against the
  JAX XLA path at float64 (rtol 1e-10 / atol 1e-12, float64 round-off),
  the parameters carried across by ``utils/jax_params``; one NLL
  value-and-grad at hidden_nf 256 (images mode, 2 flow steps, 4 x 5
  atoms) against ``enflow_tpu`` at float64 (rel 1e-9, as
  ``test_nll_step_matches_jax_f64``).
- The plain version at float32, H = 192 and 256, against the Pallas
  kernels of ``enflow_tpu/ops/edge_kernel.py`` in interpret mode (rtol
  2e-5 / atol 2e-6 forward, 5e-5 / 5e-6 backward: summation order only).
- The zero-padded route: the plain version on zero-padded weights, cut
  back, equals the unpadded call to 1e-12 at float64; the wrapper pads,
  counts and cuts back (``_run`` replaced by the plain version).
- The streamed kernels' weight slabs emulated at float64, slab by slab in
  the kernels' stream order: the f32 K-split slabs (64 of a product's k,
  X W and X W^T) with dW2 / dW3 read, added to and written back in the
  block's slice once a row tile; the bf16 64-column slabs through a ring
  of two slots (pass E taking both), against the plain version to 1e-12;
  a ring of one slot gives other numbers.
- The plans on stand-ins for the libraries' size entry points (mirrors of
  the kernels' shared-memory carves): the f32 rows a tile at 192 / 256,
  rows first; every row in one tile, each atom one owner; the bf16
  kernels' one warpgroup and C limits.
- The size rule: the routes at 64 / 128 / 192 / 256, the padded widths
  20 / 96 / 160 / 200, the refusals past 256 (ROADMAP B7.2) and past each
  kernel's C (B7.3).

Inputs are made with numpy from a seed and fed to both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.neighbors import neighbors_with_diffs as j_nbrs
from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow.integrators import FlowConfig as JFlowConfig
from enflow_tpu.flow.integrators import forward as j_forward
from enflow_tpu.flow.integrators import init_flow as j_init_flow
from enflow_tpu.flow.loss import alchemical_nll as j_nll
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import apply_egcl as j_apply_egcl
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.edge_kernel import fused_edge_pipeline as j_pipeline

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, forward
from enflow_tpu_torch.flow.loss import alchemical_nll
from enflow_tpu_torch.nn.egcl import EGCLConfig, apply_egcl
from enflow_tpu_torch.ops import edge_pipeline as ops
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten

from test_torch_port_edge import _cap, _images_state

LIMIT = 232448
NF = 3
NEW_H = (192, 256, 96, 160)


def _f64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# against the JAX package at float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", NEW_H)
def test_gathered_egcl_at_other_widths_matches_jax_f64(H):
    """The kernel contract's plain version (``use_pallas``) at hidden_nf
    192, 256 (the streamed routes' widths) and 96, 160 (padded on the
    card) against the JAX XLA path on the same images neighbors."""
    h, pos, box, mask, r_cut = _images_state(3)
    cap = _cap(pos, box, mask, r_cut)
    jn, jd = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                    jnp.asarray(r_cut), capacity=cap, mode="images")
    jp = j_init_egcl(jax.random.PRNGKey(H), JEGCLConfig(NF, H), jnp.float64)
    want = j_apply_egcl(jp, JEGCLConfig(NF, H), jnp.asarray(h), jd, jn.idx,
                        jn.mask, jnp.asarray(mask))
    ops.counts.reset()
    got = apply_egcl(from_jax_params(jp, device="cpu"),
                     EGCLConfig(NF, H, use_pallas=True), _f64(h), _f64(jd),
                     torch.from_numpy(np.asarray(jn.idx)),
                     torch.from_numpy(np.asarray(jn.mask)),
                     torch.from_numpy(mask))
    assert ops.counts.plain_fwd_calls == 1
    for g, w, name in zip(got, want, "QFG"):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_nll_value_and_grad_at_256_matches_jax_f64():
    """train.yaml's objective at hidden_nf 256: one NLL value and gradient
    (images mode, 2 flow steps, 4 molecules of 5 atoms, a padded atom and
    a dummy molecule) through the kernel contract's plain version, against
    ``jax.value_and_grad`` of the JAX flow's NLL."""
    from test_torch_port_train import KBT, SOFT, _batch
    H = 256
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
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-9)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for want, got in zip(jl, grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def _scaled_inputs(A, K, C, H, seed):
    """Edge rows, a clipped row, masked slots and a fully masked atom; the
    weights scaled by 1/sqrt(2 fan-in), as init_egcl scales them (at these
    widths unscaled weights drive every gate past the clip)."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(A, K, C))
    cd = rng.normal(size=(A, K, 3)) * 2.0
    cd[0, 0] = [3e3, -3e3, 1.0]
    em = rng.random((A, K)) > 0.25
    em[1] = False
    em[0, 0] = True
    shapes = [(C, H), (H,), (H, H), (H,), (H, H), (H,), (H, 1)]
    fan_in = (C, 1, H, 1, H, 1, H)
    ws = [rng.normal(size=s) / math.sqrt(2.0 * n)
          for s, n in zip(shapes, fan_in)]
    return e, cd, em, ws, rng.normal(size=(A, H)), rng.normal(size=(A, 3))


@pytest.mark.parametrize("H", [192, 256])
def test_plain_at_the_streamed_widths_matches_pallas_f32(H):
    """The plain version (what chip_smoke.py holds the streamed kernels
    against) and the Pallas K5/K6 in interpret mode at float32."""
    e, cd, em, ws, dagg, dfs = _scaled_inputs(5, 8, 5, H, H)
    J = lambda a: jnp.asarray(np.asarray(a, np.float32))
    jargs = [J(e), J(cd)] + [J(w) for w in ws]
    jem = jnp.asarray(em)
    jout, vjp = jax.vjp(lambda a, b, *w: j_pipeline(a, b, jem, *w), *jargs)
    jgrads = vjp((J(dagg), J(dfs)))
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).requires_grad_()
    targs = [T(a) for a in jargs]
    tout = ops.fused_edge_pipeline(targs[0], targs[1], torch.from_numpy(em),
                                   *targs[2:])
    tgrads = torch.autograd.grad(tout, targs, (T(dagg), T(dfs)))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=2e-5, atol=2e-6)
    for name, j, t in zip(("de", "dcd", "dW1", "db1", "dW2", "db2", "dW3",
                           "db3", "dw4"), jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-5,
                                   atol=5e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the zero-padded route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [20, 96, 160, 200])
def test_padding_is_exact_f64(H):
    """Every padded pre-activation is 0 and silu(0) = 0: the plain forward
    and backward on the zero-padded weights (and dagg), cut back, equal
    the unpadded call at float64."""
    A, K, C = 6, 7, 5
    e, cd, em, ws, dagg, dfs = _scaled_inputs(A, K, C, H, H + 1)
    args = [_f64(e), _f64(cd), torch.from_numpy(em).double()]
    W = [_f64(w) for w in ws]
    Hp = ops.padded_width(H)
    assert Hp in (64, 128, 192, 256) and Hp > H
    Wp = ops.pad_weights(W, Hp)
    assert all(w.is_contiguous() for w in Wp)
    want = (ops.edge_pipeline_plain(*args, *W)
            + ops.edge_pipeline_plain_bwd(*args, *W, _f64(dagg), _f64(dfs)))
    fwd = ops.edge_pipeline_plain(*args, *Wp)
    bwd = ops.edge_pipeline_plain_bwd(*args, *Wp, ops.pad_rows(_f64(dagg), Hp),
                                      _f64(dfs))
    got = ((fwd[0][:, :H], fwd[1]) + bwd[:2] + ops.unpad_grads(bwd[2:], H))
    assert float(fwd[0][:, H:].abs().max()) == 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype,H,route", [
    (torch.float32, 96, "tiled"), (torch.float32, 160, "f32_wide"),
    (torch.bfloat16, 20, "sm90"), (torch.bfloat16, 200, "wide"),
    (torch.float32, 256, "f32_wide"), (torch.bfloat16, 192, "wide")])
def test_wrapper_pads_counts_and_cuts_back(monkeypatch, dtype, H, route):
    """``_launch`` with ``_run`` replaced by the plain version: the route
    the size rule names gets the padded weights (and dagg), the outputs
    come back at H equal to the unpadded plain call, and the launch
    counts on its route's counter and, padded, on ``padded_*``."""
    seen = []

    def plain_run(direction, rt, e, cd, em, weights, dagg, dfs):
        seen.append((direction, rt, weights[2].shape[1]))
        if direction == "fwd":
            return ops.edge_pipeline_plain(e, cd, em, *weights)
        assert dagg.shape[1] == weights[2].shape[1]
        return ops.edge_pipeline_plain_bwd(e, cd, em, *weights, dagg, dfs)

    monkeypatch.setattr(ops, "_run", plain_run)
    e, cd, em, ws, dagg, dfs = _scaled_inputs(4, 6, 3, H, 7)
    c = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    args = (c(e), c(cd), torch.from_numpy(em).to(dtype))
    W = tuple(c(w) for w in ws)
    ops.counts.reset()
    got = (ops._launch("fwd", *args, W)
           + ops._launch("bwd", *args, W, c(dagg), c(dfs)))
    want = (ops.edge_pipeline_plain(*args, *W)
            + ops.edge_pipeline_plain_bwd(*args, *W, c(dagg), c(dfs)))
    Hp = ops.padded_width(H)
    assert seen == [("fwd", route, Hp), ("bwd", route, Hp)]
    padded = int(Hp != H)
    c_ = ops.counts
    assert (getattr(c_, f"{route}_fwd_launches"),
            getattr(c_, f"{route}_bwd_launches"), c_.fwd_launches,
            c_.bwd_launches, c_.padded_fwd_launches,
            c_.padded_bwd_launches) == (1, 1, 1, 1, padded, padded)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0.02,
                                   atol=0.02)


# ---------------------------------------------------------------------------
# the streamed kernels' slabs, emulated at float64
# ---------------------------------------------------------------------------

SLAB = 64


def _chain(e, cd, em, W, dagg, dfs, mm, mmT, outer):
    """K5/K6 at float64 with the weight products and the outer products
    dW2 / dW3 given as functions: ``mm(X, name)`` = X W, ``mmT(X, name)``
    = X W^T, ``outer(L, G, name)`` = L^T G. The order of the products is
    the kernels' (pre2, pre3, dm_gate, dm1)."""
    W1, b1, W2, b2, W3, b3, w4 = W
    sig = torch.sigmoid
    ds = lambda x: sig(x) * (1 + x * (1 - sig(x)))
    emf = em[:, None]
    pre1 = e @ W1 + b1
    m1 = pre1 * sig(pre1)
    pre2 = mm(m1, "W2") + b2
    m = pre2 * sig(pre2) * emf
    pre3 = mm(m, "W3") + b3
    g1 = pre3 * sig(pre3)
    gate = g1 @ w4
    pre = cd * gate
    dtr = dfs * ((pre > -100) & (pre < 100)) * emf
    dgate = (cd * dtr).sum(-1, keepdim=True)
    dpre3 = (dgate @ w4.T) * ds(pre3)
    dW3 = outer(m, dpre3, "W3")
    dm = (dagg + mmT(dpre3, "W3")) * emf
    dpre2 = dm * ds(pre2)
    dW2 = outer(m1, dpre2, "W2")
    dpre1 = mmT(dpre2, "W2") * ds(pre1)
    return m, torch.clamp(pre, -100, 100) * emf, dW2, dW3, dpre1


def _rows(A=9, K=7, C=3, H=256, seed=0):
    """Flattened rows (each with its atom's dagg and dfs) and weights."""
    e, cd, em, ws, dagg, dfs = _scaled_inputs(A, K, C, H, seed)
    r = lambda a: _f64(a).reshape(A * K, -1)
    rep = lambda a: _f64(a).repeat_interleave(K, 0)
    return (r(e), r(cd), _f64(em).reshape(-1), tuple(_f64(w) for w in ws),
            rep(dagg), rep(dfs))


def _dense(e, cd, em, W, dagg, dfs):
    Wd = {"W2": W[2], "W3": W[4]}
    return _chain(e, cd, em, W, dagg, dfs, lambda X, n: X @ Wd[n],
                  lambda X, n: X @ Wd[n].T, lambda L, G, n: L.T @ G)


class F32Ring:
    """The f32 kernels' ring (csrc/edge_pipeline.cu issue_slab /
    next_slab): slab s of the stream is product (s / G) % nprod of a row
    tile (W2, W3, W3^T, W2^T), its k 64 (s % G) ..; it lands in slot
    s % kRing, the next slab issued ahead into the other slot."""

    kRing = 2

    def __init__(self, W2, W3, nprod):
        self.W = {"W2": W2, "W3": W3}
        self.H, self.nprod = W2.shape[0], nprod
        self.slots = [None] * self.kRing
        self.s = 0
        self.issue(0)

    def issue(self, s):
        G = self.H // SLAB
        prod, g = (s // G) % self.nprod, s % G
        W = self.W["W2" if prod in (0, 3) else "W3"]
        k = slice(SLAB * g, SLAB * g + SLAB)
        # X W: 64 of W's rows; X W^T: 64 of W's columns
        self.slots[self.slot(s)] = (W[k, :] if prod < 2 else W[:, k]).clone()

    def slot(self, s):
        return s % self.kRing

    def next(self):
        self.issue(self.s + self.kRing - 1)
        out = self.slots[self.slot(self.s)]
        self.s += 1
        return out

    def product(self, X, trans):
        """The register tiles' sums kept across the product's slabs."""
        acc = torch.zeros(X.shape[0], self.H, dtype=X.dtype)
        for g in range(self.H // SLAB):
            S = self.next()
            x = X[:, SLAB * g:SLAB * g + SLAB]
            acc = acc + (x @ S.T if trans else x @ S)
        return acc


def _f32_streamed(e, cd, em, W, dagg, dfs, R, ring_cls=F32Ring):
    """The f32 streamed K6 over row tiles of R rows: each tile's four
    products from the ring in the stream's order, dW2 / dW3 read from the
    block's slice, added to over the tile's rows and written back."""
    H = W[2].shape[0]
    ring = ring_cls(W[2], W[4], 4)
    part = {"W2": torch.zeros(H, H, dtype=e.dtype),
            "W3": torch.zeros(H, H, dtype=e.dtype)}
    order = iter(())

    def mm(X, name):
        assert next(order) == (name, False)
        return ring.product(X, False)

    def mmT(X, name):
        assert next(order) == (name, True)
        return ring.product(X, True)

    def outer(L, G, name):
        old = part[name].clone()                     # read
        part[name] = old + L.T @ G                   # add, write back
        return part[name]

    outs = []
    for g0 in range(0, e.shape[0], R):
        sl = slice(g0, g0 + R)
        order = iter([("W2", False), ("W3", False), ("W3", True),
                      ("W2", True)])
        outs.append(_chain(e[sl], cd[sl], em[sl], W, dagg[sl], dfs[sl], mm,
                           mmT, outer))
    cat = lambda i: torch.cat([o[i] for o in outs])
    return cat(0), cat(1), part["W2"], part["W3"], cat(4)


@pytest.mark.parametrize("H,R", [(192, 40), (256, 24), (256, 40)])
def test_f32_slab_stream_matches_plain_f64(H, R):
    """The f32 K-split slabs (X W from 64 of W's rows, X W^T from 64 of its
    columns) and the slices' read-add-write of dW2 / dW3 per row tile give
    the plain version's m, tr, dW2, dW3 and dpre1 to 1e-12."""
    args = _rows(H=H, seed=H + R)
    for got, want in zip(_f32_streamed(*args, R=R), _dense(*args)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)


class Bf16Ring:
    """The bf16 kernels' ring (csrc/edge_pipeline_sm90.cu slab_of /
    ring_take): slab x is slab x % per of a tile's stream, forward m1 W2,
    m W3; backward those, m W3 again, then (W3^T, W2) pairs a 64-column
    group, then W2^T; slot x % kRing. A take of n slabs waits for them
    (copying those not yet copied), then issues every later slab whose
    slot no slab in use holds."""

    kRing = 2

    def __init__(self, W2, W3, bwd):
        self.W = {"W2": W2, "W3": W3}
        self.H = W2.shape[0]
        self.G = self.H // SLAB
        self.per = (6 if bwd else 2) * self.G
        self.slots = [None] * self.kRing
        self.s = self.issued = 0
        self.issue()

    def slab_of(self, j):
        G = self.G
        if j < G:
            return "W2", False, j
        if j < 3 * G:
            return "W3", False, j % G
        if j < 5 * G:
            u = j - 3 * G
            return ("W2", False, u >> 1) if u & 1 else ("W3", True, u >> 1)
        return "W2", True, j - 5 * G

    def issue(self):
        name, kmajor, g = self.slab_of(self.issued % self.per)
        cols = slice(SLAB * g, SLAB * g + SLAB)
        W = self.W[name]
        # MN-major: W's 64 columns; K-major: W's 64 rows (W^T's columns)
        self.slots[self.issued % self.kRing] = (
            (name, kmajor, g), (W[cols, :].T if kmajor else W[:, cols]).clone())
        self.issued += 1

    def take(self, n):
        while self.issued < self.s + n:
            self.issue()
        got = [self.slots[(self.s + k) % self.kRing] for k in range(n)]
        while self.issued < self.s + self.kRing:
            self.issue()
        self.s += n
        return got


def _bf16_streamed(e, cd, em, W, dagg, dfs, ring):
    """One 64-row tile's K5/K6 chain with every weight product's 64-column
    groups taken from the ring in the stream's order (pass E: dpre3 W3^T
    with m1 W2's recompute, both slabs at once)."""
    H = W[2].shape[0]
    G = H // SLAB
    pending = {}

    def by_groups(X, name, kmajor, n=1):
        out = torch.zeros(X.shape[0], H, dtype=X.dtype)
        for g in range(G):
            slabs = ring.take(n)
            (nm, km, gg), S = slabs[0]
            assert (nm, km, gg) == (name, kmajor, g)
            out[:, SLAB * g:SLAB * g + SLAB] = X @ S
            if n == 2:                                   # pass E's pair
                (nm2, km2, g2), S2 = slabs[1]
                assert (nm2, km2, g2) == ("W2", False, g)
                pending.setdefault("pre2", []).append(S2)
        return out

    calls = []

    def mm(X, name):
        calls.append(name)
        if name == "W3" and ring.per == 6 * G:
            # the backward: the gate's pass, then dpre3's pass again
            by_groups(X, "W3", False)
        return by_groups(X, name, False)

    def mmT(X, name):
        if name == "W3":
            return by_groups(X, "W3", True, n=2)
        return by_groups(X, "W2", True)

    Wd = {"W2": W[2], "W3": W[4]}
    return _chain(e, cd, em, W, dagg, dfs, mm, mmT,
                  lambda L, G_, n: L.T @ G_), pending, Wd


@pytest.mark.parametrize("H", [192, 256])
def test_bf16_slab_ring_matches_plain_f64(H):
    """The bf16 kernels' 64-column slabs through a ring of two slots, the
    backward's stream of 6 H / 64 slabs a tile (pass E's W2 slabs the
    recompute of pre2 reads, equal to m1 W2's columns), over two tiles in
    a row: the plain version's outputs to 1e-12."""
    args = _rows(A=16, K=8, H=H, seed=H)
    want = _dense(*args)
    ring = Bf16Ring(args[3][2], args[3][4], bwd=True)
    for tile in range(2):
        rows = slice(64 * tile, 64 * tile + 64)
        a = [x[rows] for x in args[:3]] + [args[3]] + [x[rows]
                                                    for x in args[4:]]
        got, pending, Wd = _bf16_streamed(*a, ring)
        assert ring.s == 6 * (H // SLAB) * (tile + 1)
        pre2 = torch.cat(pending["pre2"], dim=1)
        m1 = torch.nn.functional.silu(a[0] @ a[3][0] + a[3][1])
        np.testing.assert_allclose((m1 @ pre2).numpy(), (m1 @ Wd["W2"]).numpy(),
                                   rtol=0, atol=1e-12)
        for i in (0, 1, 4):
            np.testing.assert_allclose(got[i].numpy(), want[i][rows].numpy(),
                                       rtol=0, atol=1e-12)
    # a forward ring: 2 H / 64 slabs a tile
    fwd = Bf16Ring(args[3][2], args[3][4], bwd=False)
    assert [fwd.take(1)[0][0][:2] for _ in range(2 * (H // SLAB))] == (
        [("W2", False)] * (H // SLAB) + [("W3", False)] * (H // SLAB))


def test_a_ring_of_one_slot_overwrites_the_slab_in_use():
    """The fault chip_mutants.py's edge_wide group writes into the f32
    kernel: with one slot the slab issued ahead lands on the slab in use,
    and the forward's products read the next k's weights."""
    class OneSlot(F32Ring):
        def slot(self, s):
            return 0

    e, _, _, W, _, _ = _rows(H=192, seed=5)
    X = e @ W[0]
    for ring_cls, close in ((F32Ring, True), (OneSlot, False)):
        ring = ring_cls(W[2], W[4], 2)
        got = (ring.product(X, False), ring.product(X, False))
        err = max(float((g - X @ w).abs().max())
                  for g, w in zip(got, (W[2], W[4])))
        assert (err < 1e-12) == close


# ---------------------------------------------------------------------------
# the plans, on stand-ins for the libraries' size entry points
# ---------------------------------------------------------------------------

def a16(n):
    return (n + 15) & ~15


class SizeLib:
    """Mirrors of edge_pipeline.cu's ``tcarve`` (f32; W2 + W3 whole at 64
    and 128, a ring of two [64, H] f32 slabs at 192 and 256) and of
    edge_pipeline_sm90.cu's ``carve_blk`` / ``carve_wg`` (bf16; a ring of
    two [64, H] bf16 slabs a warpgroup at 192 and 256)."""

    def edge_pipeline_smem_limit(self):
        return LIMIT

    def edge_tiled_smem_bytes(self, code, C, H, ta, R, bwd):
        off = 0

        def take(n):
            nonlocal off
            off = a16(off) + n
        if H in (64, 128):
            take(4 * H * H)
            take(4 * H * H)
        else:
            take(4 * H * SLAB * 2)
        take(4 * H * C)
        for _ in range(4):
            take(4 * H)
        for _ in range(3 if bwd else 2):
            take(4 * R * (H + 4))
        if not bwd:
            take(4 * R * 3)
        take(4 * R * (H // 32))
        if not bwd:
            take(4 * H * ta)
            take(4 * ta * 3)
        else:
            take(4 * H * C)
        take(2 * (a16(R * C * 4 + 8) + a16(R * 12 + 8) + a16(R * 4 + 8)))
        if bwd:
            take(2 * (a16(ta * H * 4) + a16(ta * 12 + 8)))
        return off

    def edge_sm90_c_max(self):
        return 64

    def edge_sm90_smem_bytes(self, C, H, bwd, nwg):
        KC, off = -(-C // 16), 0

        def take(n, align=16):
            nonlocal off
            off = -(-off // align) * align + n
        resident = H in (64, 128)
        if resident:
            take(2 * H * H, 1024)
            take(2 * H * H, 1024)
        take(2 * 16 * KC * H, 1024)
        for _ in range(4):
            take(4 * H)
        for _ in range(nwg):
            tile = 2 * 64 * H
            if not resident:
                take(2 * tile, 1024)
            for _ in range(3 if bwd else 2):
                take(tile, 1024)
            take(2 * 64 * 64, 1024)
            take(2 * (2048 * KC + 560))
            if bwd:
                take(4 * 16 * H)
            else:
                take(4 * 64 * 3)
                take(4 * (H + 3))
        return off + 1024

    def edge_sm90_warpgroups(self, C, H, bwd):
        top = (2 if bwd else 3) if H in (64, 128) else 1
        return next((n for n in range(top, 0, -1)
                     if self.edge_sm90_smem_bytes(C, H, bwd, n) <= LIMIT), 0)


@pytest.mark.parametrize("H,direction,C,ta,want", [
    # the training shape (C = 3, 3 atoms a tile at K = 24 on 132 SMs)
    (256, "fwd", 3, 3, (40, 3)), (256, "bwd", 3, 3, (24, 3)),
    (192, "fwd", 3, 3, (72, 3)), (192, "bwd", 3, 3, (40, 3)),
    # generate's forward (16 atoms a tile): rows first, then the atoms
    (256, "fwd", 3, 16, (40, 6)), (192, "fwd", 3, 16, (72, 11)),
    (256, "bwd", 11, 8, (16, 8))])
def test_f32_wide_plan_takes_rows_first(H, direction, C, ta, want):
    lib = SizeLib()
    ops._plans.clear()
    route, rows, got_ta = ops._plan(lib, 0, C, H, 24, ta, direction)
    fit = want[0]
    assert route == "f32_wide" and got_ta == want[1]
    assert rows == ops.tile_rows(fit, got_ta, 24)
    bwd = int(direction == "bwd")
    assert lib.edge_tiled_smem_bytes(0, C, H, got_ta, fit, bwd) <= LIMIT
    # no more rows fit at one atom, and no more atoms at these rows
    if fit < ops.ROWS_MAX[direction]:
        assert lib.edge_tiled_smem_bytes(0, C, H, 1, fit + 8, bwd) > LIMIT
    if got_ta < ta:
        assert lib.edge_tiled_smem_bytes(0, C, H, got_ta + 1, fit,
                                         bwd) > LIMIT
    ops._plans.clear()


@pytest.mark.parametrize("A,K,ta,H,direction", [
    (390, 24, 3, 256, "bwd"), (390, 24, 3, 256, "fwd"),
    (2944, 56, 16, 256, "fwd"), (390, 24, 3, 192, "bwd"),
    (37, 5, 4, 256, "bwd")])
def test_wide_plan_tiles_cover_rows_once(A, K, ta, H, direction):
    """The plan's row tiles: every row in one tile, each atom's rows in one
    block (its K-sums in order, carried across row tiles where an atom
    spans them)."""
    lib = SizeLib()
    ops._plans.clear()
    _, rows, t = ops._plan(lib, 0, 3, H, K, ta, direction)
    ops._plans.clear()
    blocks = min(math.ceil(A / t), 132)
    owner, seen = {}, []
    for b, block in enumerate(ops.row_tiles(A, K, t, blocks, rows)):
        for a0, na, g0, nr, computed in block:
            assert nr <= rows <= ops.ROWS_MAX[direction]
            for a in range(a0, a0 + na):
                assert owner.setdefault(a, b) == b
            seen += range(g0, g0 + nr)
    assert sorted(owner) == list(range(A))
    assert sorted(seen) == list(range(A * K))


@pytest.mark.parametrize("H", [192, 256])
def test_bf16_wide_one_warpgroup_and_its_tiles(H):
    """At 192 and 256 a block holds one warpgroup (its ring and tiles); the
    sampler's shape (K = 8: 8 atoms a 64-row tile) walks every row once,
    each atom with one owner."""
    lib = SizeLib()
    for direction in ("fwd", "bwd"):
        assert ops.sm90_warpgroups(lib, 11, H, direction) == 1
    A, K = 2048, 8
    apt, tpa, units, blocks = ops.sm90_plan(A, K, 1, 132)
    tiles = ops.sm90_tiles(A, K, apt, tpa, units, blocks)
    rows = sorted(r for walk in tiles for _, _, g0, nr in walk
                  for r in range(g0, g0 + nr))
    assert rows == list(range(A * K)) and len(tiles) == blocks == 132


# ---------------------------------------------------------------------------
# the size rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,bf16,f32", [(64, "sm90", "tiled"),
                                        (128, "sm90", "tiled"),
                                        (192, "wide", "f32_wide"),
                                        (256, "wide", "f32_wide")])
def test_route_at_each_kernel_width(H, bf16, f32):
    assert ops.padded_width(H) == H
    assert ops.kernel_for(torch.bfloat16, H) == bf16
    assert ops.kernel_for(torch.float32, H) == f32


@pytest.mark.parametrize("H,Hp", [(20, 64), (96, 128), (160, 192),
                                  (200, 256)])
def test_other_widths_run_padded(H, Hp):
    assert ops.padded_width(H) == Hp
    assert ops.kernel_for(torch.bfloat16, H) == ops.kernel_for(
        torch.bfloat16, Hp)
    assert ops.kernel_for(torch.float32, H) == ops.kernel_for(
        torch.float32, Hp)


@pytest.mark.parametrize("H", [257, 320, 512])
def test_past_256_refuses_naming_b7_2(H):
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="B7.2") as e:
            ops.kernel_for(dt, H)
        assert "232,448" in str(e.value)


def test_past_each_kernels_c_refuses_naming_b7_3():
    """bf16 at 256: e W1 in 4 k16 steps (C = 49) does not fit the
    backward's block beside the ring; f32 at 256: C = 33 does not fit
    even at 1 atom and 8 rows. Each names the bytes and B7.3; C = 48 and
    32 fit."""
    lib = SizeLib()
    assert ops.sm90_warpgroups(lib, 48, 256, "bwd") == 1
    with pytest.raises(ValueError, match="C=49 needs 2[0-9]{5} bytes") as e:
        ops.sm90_warpgroups(lib, 49, 256, "bwd")
    assert "B7.3" in str(e.value)
    assert ops.sm90_warpgroups(lib, 64, 256, "fwd") == 1
    ops._plans.clear()
    assert ops._plan(lib, 0, 32, 256, 24, 1, "bwd")[0] == "f32_wide"
    with pytest.raises(ValueError, match="C=33, H=256 needs") as e:
        ops._plan(lib, 0, 33, 256, 24, 1, "bwd")
    assert "B7.3" in str(e.value)
    ops._plans.clear()


@pytest.mark.parametrize("name", [f"{r}_{d}_launches"
                                  for r in ("wide", "f32_wide", "padded")
                                  for d in ("fwd", "bwd")])
def test_new_counters_reset(name):
    setattr(ops.counts, name, 3)
    ops.counts.reset()
    assert getattr(ops.counts, name) == 0

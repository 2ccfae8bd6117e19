"""Port parity: the all-pairs EGCL at every node-feature width.

Every all-pairs route keeps W1a and W1b [nf, H] whole in shared memory, so
past a seam in nf no block of 8 atoms fits and its plan raises. Exactly
those launches go to route ``"wide_nf"`` (bf16) or ``"f32_wide_nf"``
(float32): a projection kernel computes P = [h W1a | h W1b] once per atom
(``csrc/egcl_wide_nf.cuh``), the block pairs built with their PROJ flag
read hA / hB rows from it, and the backward's per-atom dz1 sums give dh and
dW1a / dW1b in that header's kernels. Here, on the CPU:

- (a) the port's plain all-pairs EGCL at nf = 48, H = 32 (B = 2, N = 5,
  one padded atom) against JAX's ``fused_allpairs_edges_v3`` in interpret
  mode and its VJP at float32, values and gradients;
- (b) the port's flow (``reverse_core``) at ``node_nf`` 48 against the JAX
  flow at float64, through ``utils/jax_params``, to 1e-10;
- (c) a float64 model of the route's schedule (W1 in k-chunks of 16 for P
  and dh, the block pairs' per-atom dz1 sums with the j side in partials
  per i-block summed in order, dW1 per atom in row splits) against the
  plain version, to 1e-12 of each output's largest value;
- (d) the kernels' shared-memory arithmetic mirrored in Python
  (``egcl_smem_mirror.py``): the seam nf per (dtype, H, direction) at N=13
  is the library's on the card (``chip_smoke.py`` phase wide_nf prints
  both), and with stub libraries built on the mirror the route rule sends
  exactly the sizes past the seam to the new route, at every N;
- (e) the new route's refusal message and counters.

The kernels themselves run on the card only (``chip_smoke.py`` phase
wide_nf, ``chip_mutants.py wide_nf``). Inputs are made with numpy from a
seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egcl_smem_mirror as mirror

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

DIRECTIONS = ("fwd", "bwd", "bwd_params")
# the seam at N=13 as the card's libraries give it (K1, K2, K2 p;
# chip_smoke.py's phase wide_nf prints them beside the mirror's): the
# largest nf a route before the wide-nf one takes
SEAM_13 = {(1, 64): (333, 311, 307), (1, 128): (110, 89, 86),
           (1, 192): (71, 50, 47), (1, 256): (36, 14, 12),
           (0, 64): (332, 232, 324), (0, 128): (78, 60, 70),
           (0, 192): (69, 55, 61), (0, 256): (33, 28, 25)}
KC = 16                          # the header's k-chunk (kBK)


def _close(got, want, rel):
    """``got`` within ``rel`` of ``want``'s largest value."""
    as_np = lambda t: (t.detach().double().numpy()
                       if isinstance(t, torch.Tensor)
                       else np.asarray(t, dtype=np.float64))
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# (a) the plain version at a wide nf against the Pallas kernel
# ---------------------------------------------------------------------------

def test_plain_at_wide_nf_matches_pallas_f32():
    """``allpairs_edges_plain`` / ``_plain_bwd`` (with the parameter
    gradients) at nf = 48, H = 32, B = 2, N = 5 (molecule 1 with a padded
    atom, a periodic box) against ``fused_allpairs_edges_v3`` in interpret
    mode and its VJP at float32: forward at rtol 2e-5 / atol 2e-6, dh /
    dpos and the nine parameter gradients at rtol 5e-5 / atol 5e-6 of their
    largest value (test_torch_port_egcl.py's f32 tolerances)."""
    nf, H, N, Bm = 48, 32, 5, 2
    jp = j_init_egcl(jax.random.PRNGKey(48), JEGCLConfig(nf, H), jnp.float32)
    rng = np.random.default_rng(49)
    mask = np.ones((Bm, N), bool)
    mask[1, -1] = False
    f32 = lambda a: np.asarray(a, np.float32)
    h = f32(rng.normal(size=(Bm, N, nf)) * mask[..., None])
    pos = f32(rng.normal(size=(Bm, N, 3)) * mask[..., None])
    box = np.full((Bm, 3), 1e3, np.float32)
    box[1] = 3.0
    c_agg = f32(rng.normal(size=(Bm, N, H)))
    c_fs = f32(rng.normal(size=(Bm, N, 3)))
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(p, hh, pp):
        a, f, _ = fused_allpairs_edges_v3(p, hh, pp, jbox, jmask)
        return (a * c_agg).sum() + (f * c_fs).sum(), (a, f)

    (_, (ja, jf)), (jg, jgh, jgp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
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
    assert dh.shape == (Bm, N, nf)
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
# (b) the flow at node_nf 48 against JAX
# ---------------------------------------------------------------------------

def test_flow_at_wide_nf_matches_jax_f64():
    """The port's flow log-density (reverse, 1 LF step, all pairs, N=5,
    node_nf 48, hidden_nf 32) and its gradient in the positions and every
    parameter, against the JAX flow at float64 (1e-10 of each array's
    largest value)."""
    N, Bm, nf, H = 5, 2, 48, 32
    kw = dict(n_iter=1, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(nf, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(nf, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(nf), jcfg, jnp.float64)
    rng = np.random.default_rng(nf)
    mask = np.ones((Bm, N), bool)
    mask[1, -2:] = False
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

    (_, jldj), (jgp, jgpos) = jax.jit(jax.value_and_grad(
        jlog_density, argnums=(0, 1), has_aux=True))(
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
    assert any(tuple(x.shape[-2:]) == (2 * nf + 1, H) for x in leaves)  # W1
    for g, w in zip(leaves, jleaves):
        got = g.grad if g.grad is not None else torch.zeros_like(g)
        _close(got, w, 1e-10)


# ---------------------------------------------------------------------------
# (c) the route's schedule at float64
# ---------------------------------------------------------------------------

def _inputs(Bm, N, nf, H, seed):
    """Float64 h, pos, box, mask (molecule 1 with a padded tail, 2 with one
    real atom, odd molecules periodic), the nine weights, dagg, dfsum."""
    rng = np.random.default_rng(seed)
    mask = np.ones((Bm, N), bool)
    mask[1, N - 3:] = False
    mask[2, 1:] = False
    h = rng.normal(size=(Bm, N, nf)) * mask[..., None]
    pos = rng.normal(size=(Bm, N, 3)) * 2.0 * mask[..., None]
    box = np.full((Bm, 3), 1e3)
    box[1::2] = 4.0
    w = lambda *s: rng.normal(size=s) / math.sqrt(s[0])
    b = lambda: rng.normal(size=(1, H)) * 0.1
    W = (w(nf, H), w(nf, H), w(1, H), b(), w(H, H), b(), w(H, H), b(),
         w(H, 1))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    return (t(h), t(pos), t(box), t(mask), tuple(t(x) for x in W),
            t(rng.normal(size=(Bm, N, H))), t(rng.normal(size=(Bm, N, 3))))


def _chunked(X, Y):
    """X [M, K] Y [K, N] with K in chunks of KC, one running sum an output
    (the header's tile loop)."""
    out = torch.zeros((X.shape[0], Y.shape[1]), dtype=X.dtype)
    for k0 in range(0, X.shape[1], KC):
        out = out + X[:, k0:k0 + KC] @ Y[k0:k0 + KC]
    return out


def wide_nf_schedule(h, pos, box, mask, W, dagg, dfsum, A, splits):
    """The wide-nf route's arithmetic at float64, kernel by kernel: P (the
    projection kernel), the block pairs' rows on hA / hB from P with the
    i-side dz1 and dcd sums of each (molecule, i-block) item and the j-side
    ones of each block pair in pj [B, nI, N, H + 3], the j-side sums over
    the i-blocks in order (jsum), dh (K = 2H in chunks), dW1 in row splits
    summed in order. Returns agg, f_sum, dh, dpos, dW1a, dW1b, db1."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    B, N, nf = h.shape
    H = W2.shape[0]
    silu = lambda x: x * torch.sigmoid(x)
    dsilu = lambda x: torch.sigmoid(x) * (1 + x * (1 - torch.sigmoid(x)))
    rows = h.reshape(B * N, nf)
    P = _chunked(rows, torch.cat([W1a, W1b], 1)).reshape(B, N, 2 * H)
    nI = math.ceil(N / A)
    agg = torch.zeros((B, N, H), dtype=h.dtype)
    fsum = torch.zeros((B, N, 3), dtype=h.dtype)
    si = torch.zeros((B, N, H + 3), dtype=h.dtype)
    pj = torch.zeros((B, nI, N, H + 3), dtype=h.dtype)
    for b in range(B):
        for ib in range(nI):
            I = range(ib * A, min(N, ib * A + A))
            for jb in range(nI):
                for i in I:
                    for j in range(jb * A, min(N, jb * A + A)):
                        if i == j:
                            continue
                        cd = pos[b, i] - pos[b, j]
                        cd = cd - torch.round(cd / box[b]) * box[b]
                        r2 = (cd * cd).sum()
                        v = mask[b, i] * mask[b, j]
                        z1 = P[b, i, :H] + P[b, j, H:] + b1[0] + r2 * w1r[0]
                        z2 = silu(z1) @ W2 + b2[0]
                        m2 = silu(z2) * v
                        z3 = m2 @ W3 + b3[0]
                        gate = silu(z3) @ w4[:, 0]
                        tr = torch.clamp(cd * gate, -100, 100) * v
                        agg[b, i] += m2
                        fsum[b, i] += tr
                        raw = cd * gate
                        inside = ((raw >= -100) & (raw <= 100)).to(h.dtype)
                        dtr = dfsum[b, i] * inside * v
                        dgate = (cd * dtr).sum()
                        dz3 = (dgate * w4[:, 0]) * dsilu(z3)
                        dz2 = ((dz3 @ W3.T + dagg[b, i]) * v) * dsilu(z2)
                        dz1 = (dz2 @ W2.T) * dsilu(z1)
                        dcd = gate * dtr + 2 * cd * (dz1 * w1r[0]).sum()
                        row = torch.cat([dz1, dcd])
                        si[b, i] += row
                        pj[b, ib, j] += row
    sj = torch.zeros((B, N, H + 3), dtype=h.dtype)
    for ib in range(nI):                     # jsum: the i-blocks in order
        sj = sj + pj[:, ib]
    dpos = si[..., H:] - sj[..., H:]
    S = torch.cat([si[..., :H], sj[..., :H]], -1).reshape(B * N, 2 * H)
    dh = _chunked(S, torch.cat([W1a.T, W1b.T], 0)).reshape(B, N, nf)
    per = math.ceil(B * N / (splits * KC)) * KC
    dW1 = torch.zeros((2, nf, H), dtype=h.dtype)
    for s in range(splits):                  # the splits, summed in order
        r = slice(s * per, min(B * N, s * per + per))
        for side in range(2):
            dW1[side] += _chunked(rows[r].T, S[r, side * H:(side + 1) * H])
    db1 = si[..., :H].sum((0, 1))[None]
    return agg, fsum, dh, dpos, dW1[0], dW1[1], db1


@pytest.mark.parametrize("A,splits", [(4, 3), (16, 1)])
def test_schedule_matches_plain_f64(A, splits):
    """The route's schedule (``wide_nf_schedule``) at nf = 40 (three
    k-chunks, the last short), H = 32, N = 11 (blocks of A atoms: 3 blocks,
    or one), against the plain version at float64: agg, f_sum, dh, dpos,
    dW1a, dW1b and db1 to 1e-12 of each output's largest value."""
    h, pos, box, mask, W, dagg, dfsum = _inputs(3, 11, 40, 32, seed=A)
    got = wide_nf_schedule(h, pos, box, mask, W, dagg, dfsum, A, splits)
    grads = ops.allpairs_edges_plain_bwd(h, pos, box, mask, W, dagg, dfsum,
                                         params=True)
    plain = (ops.allpairs_edges_plain(h, pos, box, mask, W)
             + grads[:4] + grads[5:6])                 # dh .. dW1b, db1
    for g, p in zip(got, plain):
        _close(g, p, 1e-12)


# ---------------------------------------------------------------------------
# (d) the shared-memory arithmetic and the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code,H", sorted(SEAM_13))
def test_mirror_seam_is_the_cards(code, H):
    """The mirror's seam at N=13 (K1, K2, K2 p) is the one the card's
    libraries gave (SEAM_13); one nf more no route before the wide-nf one
    takes."""
    want = SEAM_13[(code, H)]
    for direction, nf in zip(DIRECTIONS, want):
        assert mirror.seam_nf(code, 13, H, direction) == nf
        assert mirror.parent_takes(code, 13, nf, H, direction)
        assert not mirror.parent_takes(code, 13, nf + 1, H, direction)


class StubSm90:
    """egcl_allpairs_sm90's byte functions on the mirror."""

    def egcl_sm90_smem_limit(self):
        return mirror.LIMIT

    def egcl_sm90_smem_bytes(self, N, nf, H, kind):
        return mirror.sm90_bytes(N, nf, H, kind) if H in (64, 128) else -1

    def egcl_sm90_blocks_smem_bytes(self, A, nf, H, kind, nwg):
        most = 1 if H in (192, 256) else (3 if kind == 0 else 2)
        return mirror.sm90_bytes(A, nf, H, kind, nwg, True) \
            if 1 <= nwg <= most else -1

    def egcl_sm90_wide_nf_smem_bytes(self, A, H, kind, nwg):
        return self.egcl_sm90_blocks_smem_bytes(A, 0, H, kind, nwg)


class StubF32:
    """egcl_allpairs_f32's byte functions on the mirror."""

    ROWS = {0: 72, 1: 72, 2: 40}

    def egcl_f32_smem_limit(self):
        return mirror.LIMIT

    def egcl_f32_smem_bytes(self, N, nf, H, MT, R, kind):
        ok = H in (64, 128) and 8 <= R <= self.ROWS[kind] and R % 8 == 0
        return mirror.f32_tiled_bytes(N, nf, H, kind, MT, R) if ok else -1

    def egcl_f32_blocks_smem_bytes(self, A, nf, H, R, kind):
        ok = 8 <= R <= self.ROWS[kind] and R % 8 == 0
        return mirror.f32_pairs_bytes(A, nf, H, R, kind) if ok else -1

    def egcl_f32_wide_nf_smem_bytes(self, A, H, R, kind):
        ok = 8 <= R <= self.ROWS[kind] and R % 8 == 0
        return mirror.f32_pairs_bytes(A, 0, H, R, kind, proj=True) \
            if ok else -1


@pytest.fixture
def stub_libs(monkeypatch):
    """The wrapper's libraries replaced by the mirror's stubs (fresh plan
    caches)."""
    sm90, f32 = StubSm90(), StubF32()
    monkeypatch.setattr(ops, "_sm90_library", lambda: sm90)
    monkeypatch.setattr(ops, "_f32_library", lambda: f32)
    monkeypatch.setattr(ops, "_largest", {})
    monkeypatch.setattr(ops, "_plans", {})
    return sm90, f32


@pytest.mark.parametrize("H", [64, 128, 192, 256])
@pytest.mark.parametrize("code", [0, 1])
def test_route_rule_sends_exactly_the_refused_sizes(stub_libs, code, H):
    """At N = 13, 55 and 147, every direction: the largest nf that the
    parent's routes take keeps its route (the one-molecule kernels or the
    block pairs, never the new one), one nf more goes to the wide-nf route
    of the dtype, and the wide-nf route has a plan there."""
    lib = stub_libs[1 - code]
    for N in (13, 55, 147):
        for direction in DIRECTIONS:
            nf = mirror.seam_nf(code, N, H, direction)
            keep = ops.route_of(code, (2, N, nf, H), direction)
            assert keep == ops._check_fits(code, (2, N, nf, H), direction)
            assert keep not in ops.WIDE_NF_ROUTE.values()
            assert ops.route_of(code, (2, N, nf + 1, H), direction) == \
                ops.WIDE_NF_ROUTE[code]
            A, _ = ops.wide_nf_plan(lib, code, N, nf + 1, H, direction)
            assert 8 <= A <= 32


@pytest.mark.parametrize("code", [0, 1])
def test_no_nf_up_to_256_refused(stub_libs, code):
    """Every nf up to 256 (and 1024) at every width up to 256 has a route
    and a plan, in either dtype and direction; H > 256 still raises naming
    B7."""
    lib = stub_libs[1 - code]
    for H in (32, 64, 100, 128, 160, 192, 256):
        Hp = ops.padded_width(H)
        for direction in DIRECTIONS:
            for nf in (1, 5, 48, 128, 200, 256, 1024):
                route = ops.route_of(code, (4, 13, nf, H), direction)
                if route in ops.WIDE_NF_ROUTE.values():
                    ops.wide_nf_plan(lib, code, 13, nf, Hp, direction)
    with pytest.raises(ValueError, match="B7"):
        ops.route_of(code, (2, 13, 256, 257), "fwd")


def test_refusal_names_nf_bytes_and_item(stub_libs):
    """Where no wide-nf block of 8 atoms fits (a library whose blocks are
    all too large), the plan raises naming nf, the width, the bytes and
    ROADMAP B7.4."""

    class Full(StubSm90):
        def egcl_sm90_wide_nf_smem_bytes(self, A, H, kind, nwg):
            return mirror.LIMIT + 64 * A

    with pytest.raises(ValueError) as e:
        ops.wide_nf_plan(Full(), 1, 13, 300, 256, "bwd")
    msg = str(e.value)
    assert "nf=300" in msg and "H=256" in msg and "B7.4" in msg
    assert f"{mirror.LIMIT + 64 * 8:,} bytes" in msg and ops.NF_ITEM in msg


def test_cpu_tensors_are_refused_by_the_forced_route():
    h, pos, box, mask, W, dagg, dfsum = _inputs(3, 5, 4, 32, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.allpairs_edges_wide_nf("fwd", h.float(), pos.float(),
                                   box.float(), mask.float(),
                                   tuple(w.float() for w in W))


# ---------------------------------------------------------------------------
# (e) the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,suffix", [("wide_nf", "_wide_nf"),
                                          ("f32_wide_nf", "_f32_wide_nf")])
def test_wide_nf_counters_count_and_reset(route, suffix):
    """Each direction on its own counter (a padded width also on
    ``padded_launches``); ``reset`` zeroes them."""
    ops.counts.reset()
    for direction, name in (("fwd", "fwd"), ("bwd", "bwd"),
                            ("bwd_params", "bwd_param")):
        ops._count(direction, 256, route)
        ops._count(direction, 100, route)
        assert getattr(ops.counts, f"{name}{suffix}_launches") == 2
    assert ops.counts.padded_launches == 3
    ops.counts.reset()
    assert all(v == 0 for k, v in vars(ops.counts).items()
               if not k.startswith("_"))

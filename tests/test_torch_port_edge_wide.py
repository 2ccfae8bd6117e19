"""Port parity: the gathered-edge EGCL (K5/K6) at 8 or more node features,
C = 2 nf + 1 > 16 edge features.

- The bf16 Hopper kernels (``csrc/edge_pipeline_sm90.cu``) take e W1 as
  ``KC = ceil(C / 16)`` k16 steps over e and W1 zero-padded to ``16 KC``
  columns / rows, de = dpre1 W1^T as KC m64n16 products (each a 16-column
  chunk of de, cut to C), and dW1^T = dpre1^T e chunk by chunk; at KC = 1
  dW1^T stays in registers across a warpgroup's tiles, at KC > 1 each
  tile's chunk products are stored into (first tile) or added to the
  warpgroup's slice. ``chunked_first_layer`` / ``chunked_de_dw1`` emulate
  that in plain PyTorch on the wrapper's tile walk (``sm90_plan``,
  ``sm90_tiles``) and are held against the plain version at float64 (1e-10
  of each output's largest value) at C = 17 and 33.
- The f32 tiled kernels' plan (``ops._plan``) halves the atoms a tile
  until a block fits: at H = 128 the backward takes C <= 63 at 16 atoms a
  tile and C <= 78 at 1 (a stub library mirrors ``tcarve``'s bytes).
- The port's gathered EGCL at nf = 8 and 16 (the kernel's plain version,
  what a CPU tensor runs) against the JAX XLA path at float64, and the
  plain version against the Pallas kernels in interpret mode at bf16.

Inputs are made with numpy from a seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.neighbors import neighbors_with_diffs as j_nbrs
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import apply_egcl as j_apply_egcl
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl

from enflow_tpu_torch.data.neighbors import (image_edge_max,
                                             neighbors_with_diffs)
from enflow_tpu_torch.nn.egcl import EGCLConfig, apply_egcl
from enflow_tpu_torch.ops import edge_pipeline as ops
from enflow_tpu_torch.utils.jax_params import from_jax_params

from test_torch_port_edge import NAMES, _pipeline_inputs
from test_torch_port_edge_sm90 import ATOL_BF16, RTOL_BF16, _bf16_case
from torch_threads import one_torch_thread  # noqa: F401

KC_STEP = 16                     # e's columns a k16 step
SLOTS = 3                        # warpgroups (parameter slices)
LIMIT = 232448                   # shared memory a block may use


# ---------------------------------------------------------------------------
# the chunked first layer and its backward
# ---------------------------------------------------------------------------

def _pad(t, n, dim):
    """``t`` zero-padded to ``n`` along ``dim``."""
    shape = list(t.shape)
    shape[dim] = n - shape[dim]
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype)], dim=dim)


def chunked_first_layer(e, W1):
    """pre1 - b1 = e W1 as the kernels take it: e [rows, C] and W1 [C, H]
    zero-padded to 16 KC, one k16 step a chunk, summed in chunk order."""
    C = e.shape[-1]
    kc = math.ceil(C / KC_STEP)
    ep, Wp = _pad(e, KC_STEP * kc, -1), _pad(W1, KC_STEP * kc, 0)
    out = 0.0
    for cc in range(kc):
        s = slice(KC_STEP * cc, KC_STEP * (cc + 1))
        out = out + ep[..., s] @ Wp[s]
    return out


def chunked_de_dw1(dpre1, e, W1, A, K, slots=SLOTS):
    """de [A*K, C] and dW1 [C, H] as the kernels make them from dpre1 [A*K,
    H] (the rounded one in bf16) on the wrapper's tile walk: de chunk cc =
    dpre1 W1p[chunk]^T, cut to C; dW1^T per tile and chunk = dpre1^T
    e[chunk], held across a warpgroup's tiles at KC = 1 and stored into /
    added to its slice tile by tile at KC > 1; the slices summed in
    order."""
    C, H = W1.shape
    kc = math.ceil(C / KC_STEP)
    ep, Wp = _pad(e, KC_STEP * kc, -1), _pad(W1, KC_STEP * kc, 0)
    de = torch.cat([dpre1 @ Wp[KC_STEP * cc:KC_STEP * (cc + 1)].T
                    for cc in range(kc)], dim=-1)[:, :C]
    apt, tpa, units, blocks = ops.sm90_plan(A, K, 1, slots)
    walks = ops.sm90_tiles(A, K, apt, tpa, units, slots)
    parts = []
    for tiles in walks:
        regs = torch.zeros((KC_STEP * kc, H), dtype=e.dtype)
        part = torch.zeros((KC_STEP * kc, H), dtype=e.dtype)
        for n, (_, _, g0, nr) in enumerate(tiles):
            rows = slice(g0, g0 + nr)
            tile = torch.cat([ep[rows, KC_STEP * cc:KC_STEP * (cc + 1)].T
                              @ dpre1[rows] for cc in range(kc)])
            if kc == 1:
                regs = regs + tile
            else:
                part = tile if n == 0 else part + tile
        parts.append(regs if kc == 1 else part)
    return de, torch.stack(parts).sum(0)[:C]


def _chain_f64(e, cd, em, W, dagg, dfs, first_layer):
    """The plain backward's chain at float64 up to dpre1, with the first
    layer taken by ``first_layer``."""
    W1, b1, W2, b2, W3, b3, w4 = W
    emf = em.to(e.dtype)[..., None]
    silu = lambda x: x * torch.sigmoid(x)
    dsilu = lambda x: torch.sigmoid(x) * (1 + x * (1 - torch.sigmoid(x)))
    pre1 = first_layer(e, W1) + b1
    m1 = silu(pre1)
    pre2 = m1 @ W2 + b2
    m = silu(pre2) * emf
    pre3 = m @ W3 + b3
    gate = silu(pre3) @ w4
    dtr = dfs[:, None, :] * (((cd * gate) > -100) & ((cd * gate) < 100)) * emf
    dgate = (cd * dtr).sum(-1, keepdim=True)
    dpre3 = (dgate @ w4.T) * dsilu(pre3)
    dpre2 = (dagg[:, None, :] + dpre3 @ W3.T) * emf * dsilu(pre2)
    dpre1 = (dpre2 @ W2.T) * dsilu(pre1)
    return pre1, dpre1


@pytest.mark.parametrize("A,K,C,H", [(11, 12, 17, 64), (7, 80, 17, 128),
                                     (11, 12, 33, 128), (5, 24, 33, 64),
                                     (9, 8, 11, 64)])
def test_chunked_first_layer_and_backward_match_plain_f64(A, K, C, H):
    """e W1, de and dW1 over ceil(C / 16) zero-padded k16 chunks (and at C
    = 11 the one step of C <= 16) against the plain version at float64, to
    1e-10 of each output's largest value; atoms spanning tiles (K = 80)
    and several tiles a warpgroup."""
    e, cd, em, ws, dagg, dfs = _pipeline_inputs(A, K, C, H, C + H)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    e, cd, em_t, dagg, dfs = t(e), t(cd), torch.from_numpy(em), t(dagg), t(dfs)
    W = [t(w) for w in ws]
    pre1, dpre1 = _chain_f64(e, cd, em_t, W, dagg, dfs, chunked_first_layer)
    want_pre1, want_dpre1 = _chain_f64(e, cd, em_t, W, dagg, dfs,
                                       lambda x, w: x @ w)
    close = lambda g, w: np.testing.assert_allclose(
        g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10 * np.abs(w.numpy()).max())
    close(pre1, want_pre1)
    de, dW1 = chunked_de_dw1(dpre1.reshape(A * K, H), e.reshape(A * K, C),
                             W[0], A, K)
    plain = ops.edge_pipeline_plain_bwd(e, cd, em_t, *W, dagg, dfs)
    assert de.shape == (A * K, C) and dW1.shape == (C, H)
    close(de.reshape(A, K, C), plain[0])
    close(dW1, plain[2])


@pytest.mark.parametrize("C,kc", [(1, 1), (11, 1), (16, 1), (17, 2),
                                  (32, 2), (33, 3), (48, 3), (64, 4)])
def test_k_steps_cover_c_and_pad_with_zeros(C, kc):
    """ceil(C / 16) k16 steps; the padding contributes exact zeros."""
    rng = np.random.default_rng(C)
    e = torch.from_numpy(rng.normal(size=(64, C)))
    W1 = torch.from_numpy(rng.normal(size=(C, 8)))
    assert math.ceil(C / KC_STEP) == kc
    padded = _pad(e, KC_STEP * kc, -1)
    assert float(padded[:, C:].abs().sum()) == 0.0
    np.testing.assert_allclose(chunked_first_layer(e, W1).numpy(),
                               (e @ W1).numpy(), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the wrapper's sizes: the Hopper kernels' warpgroups, the tiled plan
# ---------------------------------------------------------------------------

def a16(n):
    return (n + 15) & ~15


class TiledLib:
    """A stand-in for edge_pipeline.cu's tiled size entry points: the f32
    bytes of ``tcarve`` (csrc/edge_pipeline.cu) for a block of ta atoms
    and R rows."""

    def edge_pipeline_smem_limit(self):
        return LIMIT

    def edge_tiled_smem_bytes(self, code, C, H, ta, R, bwd):
        off = 0

        def take(n):
            nonlocal off
            off = a16(off) + n
        take(4 * H * H)
        take(4 * H * H)
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
        st = a16(R * C * 4 + 8)
        st += a16(R * 12 + 8)
        st += a16(R * 4 + 8)
        take(2 * st)
        if bwd:
            take(2 * (a16(ta * H * 4) + a16(ta * 12 + 8)))
        return off


@pytest.mark.parametrize("C,ta,want_ta", [(11, 16, 16), (63, 16, 16),
                                          (65, 16, 8), (71, 16, 8),
                                          (75, 16, 4), (78, 16, 1),
                                          (65, 3, 3)])
def test_tiled_plan_halves_the_atom_tile(C, ta, want_ta):
    """The H = 128 backward (dW1 and W1 grow with C): the plan keeps the
    atoms a tile while a block of 8 rows fits and halves them until one
    does; the rows are the most that fit there."""
    lib = TiledLib()
    ops._plans.clear()
    route, rows, got = ops._plan(lib, 0, C, 128, 24, ta, "bwd")
    assert route == "tiled" and got == want_ta
    assert lib.edge_tiled_smem_bytes(0, C, 128, got, rows, 1) <= LIMIT
    assert rows % 8 == 0 and rows <= ops.ROWS_MAX["bwd"]
    if got < ta:           # the tile before the last halving did not fit
        assert lib.edge_tiled_smem_bytes(0, C, 128, 2 * got, 8, 1) > LIMIT
    ops._plans.clear()


def test_tiled_plan_refuses_past_one_atom():
    """C = 79 at H = 128 does not fit the backward even at 1 atom and 8
    rows a tile: refused, naming C and the bytes."""
    ops._plans.clear()
    with pytest.raises(ValueError, match=r"C=79, H=128 needs 233312 bytes"):
        ops._plan(TiledLib(), 0, 79, 128, 24, 16, "bwd")
    ops._plans.clear()


# ---------------------------------------------------------------------------
# the gathered EGCL at nf = 8 and 16 against JAX
# ---------------------------------------------------------------------------

B, N, H = 3, 6, 16


def _state(nf, seed):
    rng = np.random.default_rng(seed)
    box = np.full((B, 3), 3.0)
    pos = rng.uniform(-1.5, 1.5, size=(B, N, 3))
    h = np.eye(nf)[rng.integers(0, nf, size=(B, N))]      # one-hot elements
    mask = np.ones((B, N), bool)
    mask[1, -2:] = False
    pos[~mask] = 0.0
    h[~mask] = 0.0
    r_cut = np.full((B,), 2.5)
    return h, pos, box, mask, r_cut


@pytest.mark.parametrize("nf", [8, 16])
def test_gathered_egcl_wide_matches_jax_f64(nf):
    """The port's gathered EGCL through the kernel's contract (on the CPU
    its plain version) at C = 2 nf + 1 = 17 and 33 against the JAX XLA
    path at float64 (1e-10), the parameters through
    ``utils/jax_params``."""
    h, pos, box, mask, r_cut = _state(nf, nf)
    cap = max(image_edge_max(pos[b][mask[b]], box[b], r_cut[b])
              for b in range(B)) + 2
    jn, jd = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                    jnp.asarray(r_cut), capacity=cap, mode="images")
    jp = j_init_egcl(jax.random.PRNGKey(nf), JEGCLConfig(nf, H), jnp.float64)
    want = j_apply_egcl(jp, JEGCLConfig(nf, H), jnp.asarray(h), jd, jn.idx,
                        jn.mask, jnp.asarray(mask))
    t = lambda a: torch.from_numpy(np.asarray(a))
    ops.counts.reset()
    got = apply_egcl(from_jax_params(jp, device="cpu"),
                     EGCLConfig(nf, H, use_pallas=True), t(h), t(jd),
                     t(jn.idx), t(jn.mask), t(mask))
    assert ops.counts.plain_fwd_calls == 1
    for g, w, name in zip(got, want, "QFG"):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    # the same through the port's own neighbour build (images mode)
    nb, cd = neighbors_with_diffs(t(pos), t(box), t(mask), t(r_cut), cap,
                                  "images")
    got2 = apply_egcl(from_jax_params(jp, device="cpu"),
                      EGCLConfig(nf, H, use_pallas=True), t(h), cd, nb.idx,
                      nb.mask, t(mask))
    for g, w in zip(got2, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("A,K,C,H_", [(6, 8, 17, 64), (5, 12, 33, 64)])
def test_plain_matches_pallas_bf16_wide(A, K, C, H_):
    """The plain version the card's kernels are held against, at C = 17
    and 33, against the Pallas kernels in interpret mode at bf16 (the
    tolerance of test_pipeline_matches_pallas_bf16: rtol 0.15, atol
    0.05)."""
    fwd, bwd = _bf16_case(A, K, C, H_, A + K + C)
    for (want, got), name in zip(fwd + bwd, ("agg", "F_sum") + NAMES):
        assert got.dtype == torch.bfloat16, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16, err_msg=name)

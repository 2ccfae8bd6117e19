"""Port parity: the EGCL and the fused all-pairs edge contract.

- The port's plain EGCL against ``enflow_tpu.nn.egcl.apply_egcl`` in
  ``all_pairs`` mode at float64, outputs and every parameter gradient
  (tolerance: float64 round-off).
- The plain PyTorch version of the CUDA kernel's contract
  (``enflow_tpu_torch.ops.egcl_allpairs``, which is what a CPU tensor runs)
  against the Pallas kernels K1/K2 of ``enflow_tpu/ops/egcl_fused_v3.py`` in
  interpret mode, forward and input-gradient VJP, at the tolerances of
  ``tests/test_egcl_fused.py`` (f32) and its bf16 tolerance; and against
  K3/K4, the v2 kernels of ``enflow_tpu/ops/egcl_fused.py``, which compute
  the same function (the port's counterpart of both is the one CUDA
  kernel), at the same f32 tolerances.
- K2's parameter gradients: the plain version's nine gradients, through
  the autograd Function into the EGCL pytree (W1 ``[2nf+1, H]``, b1, W2,
  b2, W3, b3, w4), against ``jax.grad`` through the Pallas kernel in
  interpret mode: f32 at both ``mol_tile``s and both PBC settings (5e-5
  relative, 5e-6 of each array's max absolute: f32 sums over the edges in
  another order), bf16 at 1e-2 of each array's max (see the test).

Inputs are made with numpy from a seed and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.neighbors import neighbors_with_diffs as j_nbrs
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import apply_egcl as j_apply_egcl
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.egcl_fused import fused_allpairs_edges as fused_v2
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3

from enflow_tpu_torch.data.neighbors import neighbors_with_diffs
from enflow_tpu_torch.nn.egcl import (EGCLConfig, apply_egcl,
                                      apply_egcl_fused_allpairs)
from enflow_tpu_torch.ops import egcl_allpairs as ops
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten

N, NF, H = 5, 4, 16


def _inputs(B, pbc, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, NF))
    if pbc:
        box = np.full((B, 3), 2.5)
        pos = rng.uniform(-3.0, 3.0, size=(B, N, 3))
    else:
        box = np.full((B, 3), 1e3)
        pos = rng.normal(size=(B, N, 3))
    mask = np.ones((B, N), bool)
    mask[0, -1] = False
    if B > 3:
        mask[3, -2:] = False
    h[~mask] = 0.0
    pos[~mask] = 0.0
    return h.astype(dtype), pos.astype(dtype), box.astype(dtype), mask


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _egcl_leaves(tree):
    """The all-pairs kernel's weights of an EGCL pytree, in one order."""
    return [tree["edge_nn"][0]["w"], tree["edge_nn"][0]["b"],
            tree["edge_nn"][1]["w"], tree["edge_nn"][1]["b"],
            tree["coord_nn"][0]["w"], tree["coord_nn"][0]["b"],
            tree["coord_nn"][1]["w"]]


@pytest.mark.parametrize("pbc", [False, True])
def test_plain_egcl_param_grads_match_jax_f64(pbc):
    """Every parameter gradient of the plain all-pairs EGCL against
    ``jax.grad`` of the XLA path, float64 (1e-9 of each array's max)."""
    B = 4
    h, pos, box, mask = _inputs(B, pbc)
    cfg = JEGCLConfig(NF, H)
    jp = j_init_egcl(jax.random.PRNGKey(3), cfg, jnp.float64)
    rng = np.random.default_rng(4)
    cts = [rng.normal(size=(B, N, k)) for k in (1, 3, NF)]
    r_cut = np.full((B,), 1e2)
    nb, cd = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                    jnp.asarray(r_cut), mode="all_pairs")

    def jloss(p):
        out = j_apply_egcl(p, cfg, jnp.asarray(h), cd, nb.idx, nb.mask,
                           jnp.asarray(mask), all_pairs=True)
        return sum((o * c).sum() for o, c in zip(out, cts))

    jg = jax.grad(jloss)(jp)
    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    tnb, tcd = neighbors_with_diffs(_t(pos), _t(box), _t(mask))
    out = apply_egcl(tp, EGCLConfig(NF, H), _t(h), tcd, tnb.idx, tnb.mask,
                     _t(mask), all_pairs=True)
    loss = sum((o * _t(c)).sum() for o, c in zip(out, cts))
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jg)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


@pytest.mark.parametrize("pbc", [False, True])
def test_plain_egcl_matches_jax_f64(pbc):
    B = 4
    h, pos, box, mask = _inputs(B, pbc)
    jp = j_init_egcl(jax.random.PRNGKey(3), JEGCLConfig(NF, H), jnp.float64)
    r_cut = np.full((B,), 1e2)
    nb, cd = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                    jnp.asarray(r_cut), mode="all_pairs")
    want = j_apply_egcl(jp, JEGCLConfig(NF, H), jnp.asarray(h), cd, nb.idx,
                        nb.mask, jnp.asarray(mask), all_pairs=True)

    tnb, tcd = neighbors_with_diffs(_t(pos), _t(box), _t(mask))
    got = apply_egcl(from_jax_params(jp, device="cpu"), EGCLConfig(NF, H),
                     _t(h), tcd, tnb.idx, tnb.mask, _t(mask), all_pairs=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


def _contract_case(B, pbc, cdt_j, cdt_t, mol_tile,
                   kernel=fused_allpairs_edges_v3):
    h, pos, box, mask = _inputs(B, pbc, seed=1, dtype=np.float32)
    jp = j_init_egcl(jax.random.PRNGKey(5), JEGCLConfig(NF, H), jnp.float32)
    jp = jax.tree_util.tree_map(lambda x: x.astype(cdt_j), jp)
    rng = np.random.default_rng(2)
    c_agg = rng.normal(size=(B, N, H)).astype(np.float32)
    c_fs = rng.normal(size=(B, N, 3)).astype(np.float32)
    jh = jnp.asarray(h).astype(cdt_j)
    jpos, jbox, jmask = jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask)

    def jloss(hh, pp):
        a, f, _ = kernel(jp, hh, pp, jbox, jmask, mol_tile=mol_tile)
        return ((a.astype(jnp.float32) * c_agg).sum()
                + (f.astype(jnp.float32) * c_fs).sum())

    ja, jf, jc = kernel(jp, jh, jpos, jbox, jmask, mol_tile=mol_tile)
    jgh, jgp = jax.grad(jloss, argnums=(0, 1))(jh, jpos)

    tp = from_jax_params(jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jp), dtype=cdt_t,
        device="cpu")
    th = _t(np.asarray(jh.astype(jnp.float32)), cdt_t).requires_grad_(True)
    tpos = _t(pos).requires_grad_(True)
    ta, tf, tc = ops.fused_allpairs_edges(tp, th, tpos, _t(box), _t(mask))
    loss = ((ta.float() * _t(c_agg)).sum() + (tf.float() * _t(c_fs)).sum())
    tgh, tgp = torch.autograd.grad(loss, (th, tpos))

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return ((f32(ja), ta), (f32(jf), tf), (f32(jgh), tgh), (f32(jgp), tgp),
            np.asarray(jc), tc)


def _check_f32(fwd_a, fwd_f, g_h, g_pos, jc, tc):
    for want, got in (fwd_a, fwd_f):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                                   atol=2e-6)
    np.testing.assert_array_equal(tc.numpy(), jc)
    for want, got in (g_h, g_pos):
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("B,mol_tile", [(6, 16), (7, 4)])
@pytest.mark.parametrize("pbc", [False, True])
def test_contract_matches_pallas_f32(B, mol_tile, pbc):
    _check_f32(*_contract_case(B, pbc, jnp.float32, torch.float32, mol_tile))


@pytest.mark.parametrize("pbc", [False, True])
def test_contract_matches_v2_pallas_f32(pbc):
    """K3/K4 (``ops/egcl_fused.py``) against the same plain contract."""
    _check_f32(*_contract_case(7, pbc, jnp.float32, torch.float32, 4,
                               fused_v2))


def test_contract_matches_pallas_bf16():
    fwd_a, fwd_f, g_h, g_pos, _, _ = _contract_case(
        7, True, jnp.bfloat16, torch.bfloat16, 4)
    assert fwd_a[1].dtype == torch.bfloat16 and g_h[1].dtype == torch.bfloat16
    assert g_pos[1].dtype == torch.float32
    for want, got in (fwd_a, fwd_f, g_h, g_pos):
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0.15, atol=0.05)


def _param_case(B, pbc, cdt_j, cdt_t, mol_tile):
    """K2's parameter gradients: ``jax.grad`` through the Pallas kernel and
    autograd through the port's contract, with h and pos requiring grad
    too (as in training)."""
    h, pos, box, mask = _inputs(B, pbc, seed=1, dtype=np.float32)
    jp = j_init_egcl(jax.random.PRNGKey(5), JEGCLConfig(NF, H), jnp.float32)
    jp = jax.tree_util.tree_map(lambda x: x.astype(cdt_j), jp)
    rng = np.random.default_rng(2)
    c_agg = rng.normal(size=(B, N, H)).astype(np.float32)
    c_fs = rng.normal(size=(B, N, 3)).astype(np.float32)
    jh = jnp.asarray(h).astype(cdt_j)
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(p):
        a, f, _ = fused_allpairs_edges_v3(p, jh, jnp.asarray(pos), jbox,
                                          jmask, mol_tile=mol_tile)
        return ((a.astype(jnp.float32) * c_agg).sum()
                + (f.astype(jnp.float32) * c_fs).sum())

    jg = jax.grad(jloss)(jp)
    tp = from_jax_params(jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), jp), dtype=cdt_t,
        device="cpu")
    leaves = _egcl_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    th = _t(np.asarray(jh.astype(jnp.float32)), cdt_t).requires_grad_(True)
    tpos = _t(pos).requires_grad_(True)
    ops.counts.reset()
    ta, tf, _ = ops.fused_allpairs_edges(tp, th, tpos, _t(box), _t(mask))
    loss = ((ta.float() * _t(c_agg)).sum() + (tf.float() * _t(c_fs)).sum())
    grads = torch.autograd.grad(loss, leaves)
    assert (ops.counts.plain_bwd_param_calls, ops.counts.plain_bwd_calls) \
        == (1, 0)
    want = [np.asarray(w.astype(jnp.float32)) for w in _egcl_leaves(jg)]
    return want, grads


@pytest.mark.parametrize("B,mol_tile", [(6, 16), (7, 4)])
@pytest.mark.parametrize("pbc", [False, True])
def test_param_grads_match_pallas_f32(B, mol_tile, pbc):
    want, got = _param_case(B, pbc, jnp.float32, torch.float32, mol_tile)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())


def test_param_grads_match_pallas_bf16():
    """1e-2 of each gradient's max: the sound plain version reads <= 4.9e-3
    (dW2), a molecule dropped from dW2 3.8e-1, dw1r from r2's square root
    2.3e-1. Faults of one bf16 rounding point (dw4 from the rounded dgate
    6.0e-3, dw1r from the rounded r2 2.1e-3) sit inside the bf16 noise
    between two implementations; the card's kernel-vs-plain check, which
    shares the rounding points, holds those."""
    want, got = _param_case(7, True, jnp.bfloat16, torch.bfloat16, 4)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=1e-2 * np.abs(w).max())


def test_plain_path_counts_and_padded_atoms():
    h, pos, box, mask = _inputs(5, False, dtype=np.float32)
    jp = j_init_egcl(jax.random.PRNGKey(5), JEGCLConfig(NF, H), jnp.float32)
    tp = from_jax_params(jp, device="cpu")
    ops.counts.reset()
    th = _t(h).requires_grad_(True)
    tpos = _t(pos).requires_grad_(True)
    agg, fsum, _ = ops.fused_allpairs_edges(tp, th, tpos, _t(box), _t(mask))
    (agg.sum() + fsum.sum()).backward()
    assert (ops.counts.plain_fwd_calls, ops.counts.plain_bwd_calls) == (1, 1)
    assert (ops.counts.fwd_launches, ops.counts.bwd_launches) == (0, 0)
    pad = ~_t(mask)
    for t in (agg, fsum, th.grad, tpos.grad):
        assert float(t.detach()[pad].abs().max()) == 0.0


def test_contract_rejects_f64_and_attention():
    h, pos, box, mask = _inputs(3, False, dtype=np.float32)
    jp = j_init_egcl(jax.random.PRNGKey(5), JEGCLConfig(NF, H), jnp.float32)
    tp = from_jax_params(jp, device="cpu")
    tp64 = from_jax_params(jp, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        apply_egcl_fused_allpairs(tp64, EGCLConfig(NF, H),
                                  _t(h, torch.float64), _t(pos, torch.float64),
                                  _t(box, torch.float64), _t(mask))
    with pytest.raises(ValueError, match="attention"):
        apply_egcl_fused_allpairs(tp, EGCLConfig(NF, H, attention=True),
                                  _t(h), _t(pos), _t(box), _t(mask))

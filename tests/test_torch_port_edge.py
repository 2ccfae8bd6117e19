"""Port parity: the gathered-edge EGCL pipeline (K5/K6) and the ``images``
neighbor mode.

- The plain PyTorch version of the CUDA kernel's contract
  (``enflow_tpu_torch.ops.edge_pipeline``, what a CPU tensor runs) against
  the Pallas kernels of ``enflow_tpu/ops/edge_kernel.py`` in interpret
  mode: forward ``agg``/``F_sum`` and the VJP for ``de``, ``dcd`` and all
  seven parameter gradients, with masked slots, fully masked atoms, K not a
  multiple of 8 and rows beyond the +-100 clip. f32 at rtol 2e-5 / atol
  2e-6 forward and 5e-5 / 5e-6 backward (summation order only); bf16 at
  rtol 0.15 / atol 0.05 (a bf16 ulp where the orders round differently).
- The port's gathered ``apply_egcl`` against the JAX XLA path at float64
  on the same images neighbors (float64 round-off, 1e-10), and the images
  neighbor build itself: valid slots as sets (``torch.topk`` and ``lax.top_k``
  may order tied slots differently), their displacements, the excess.

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
from enflow_tpu.ops.edge_kernel import fused_edge_pipeline as j_pipeline

from enflow_tpu_torch.data.neighbors import (image_edge_max,
                                             neighbors_with_diffs)
from enflow_tpu_torch.nn.egcl import EGCLConfig, apply_egcl
from enflow_tpu_torch.ops import edge_pipeline as ops
from enflow_tpu_torch.utils.jax_params import from_jax_params

NAMES = ("de", "dcd", "dW1", "db1", "dW2", "db2", "dW3", "db3", "dw4")


def _pipeline_inputs(A, K, C, H, seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(A, K, C))
    cd = rng.normal(size=(A, K, 3)) * 2.0
    cd[0, 0] = [3e3, -3e3, 1.0]            # |cd * gate| > 100: clipped
    em = rng.random((A, K)) > 0.25
    em[1] = False                          # a fully masked atom
    em[0, 0] = True
    shapes = [(C, H), (H,), (H, H), (H,), (H, H), (H,), (H, 1)]
    ws = [rng.normal(size=s) * 0.5 for s in shapes]
    dagg = rng.normal(size=(A, H))
    dfs = rng.normal(size=(A, 3))
    return e, cd, em, ws, dagg, dfs


def _pipeline_case(A, K, C, H, seed, jdt, tdt):
    e, cd, em, ws, dagg, dfs = _pipeline_inputs(A, K, C, H, seed)
    J = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(jdt)
    jargs = [J(e), J(cd)] + [J(w) for w in ws]
    jem = jnp.asarray(em)
    jout, vjp = jax.vjp(lambda a, b, *w: j_pipeline(a, b, jem, *w), *jargs)
    jgrads = vjp((J(dagg), J(dfs)))
    to32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    T = lambda a: torch.from_numpy(to32(a).copy()).to(tdt)
    targs = [T(a).requires_grad_(True) for a in jargs]
    tout = ops.fused_edge_pipeline(targs[0], targs[1], torch.from_numpy(em),
                                   *targs[2:])
    tgrads = torch.autograd.grad(tout, targs, (T(J(dagg)), T(J(dfs))))
    return ([(to32(j), t.detach()) for j, t in zip(jout, tout)],
            [(to32(j), t) for j, t in zip(jgrads, tgrads)])


@pytest.mark.parametrize("A,K,C,H", [(7, 5, 5, 16), (9, 8, 3, 8),
                                     (4, 13, 7, 12)])
def test_pipeline_matches_pallas_f32(A, K, C, H):
    fwd, bwd = _pipeline_case(A, K, C, H, A, jnp.float32, torch.float32)
    for (want, got), name in zip(fwd, ("agg", "F_sum")):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6,
                                   err_msg=name)
    assert float(fwd[1][1][1].abs().max()) == 0.0        # masked atom
    for (want, got), name in zip(bwd, NAMES):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-6,
                                   err_msg=name)


def test_pipeline_matches_pallas_bf16():
    fwd, bwd = _pipeline_case(7, 5, 5, 16, 3, jnp.bfloat16, torch.bfloat16)
    for (want, got), name in zip(fwd + bwd, ("agg", "F_sum") + NAMES):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.15,
                                   atol=0.05, err_msg=name)


def test_pipeline_counts_and_masked_zeros():
    e, cd, em, ws, dagg, dfs = _pipeline_inputs(6, 8, 3, 8, 5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    args = [t(e).requires_grad_(True), t(cd).requires_grad_(True)]
    ops.counts.reset()
    agg, fs = ops.fused_edge_pipeline(args[0], args[1], torch.from_numpy(em),
                                      *[t(w) for w in ws])
    (agg.sum() + fs.sum()).backward()
    assert (ops.counts.plain_fwd_calls, ops.counts.plain_bwd_calls) == (1, 1)
    assert (ops.counts.fwd_launches, ops.counts.bwd_launches) == (0, 0)
    off = ~torch.from_numpy(em)
    assert float(agg[1].detach().abs().max()) == 0.0
    assert float(fs[1].detach().abs().max()) == 0.0
    for g in (args[0].grad, args[1].grad):
        assert float(g[off].abs().max()) == 0.0


# --- images neighbors and the gathered EGCL --------------------------------

B, N, NF, H = 4, 5, 3, 16


def _images_state(seed=0):
    """Periodic molecules in a box smaller than 2 r_cut (several images per
    pair), one padded atom and one all-masked dummy molecule."""
    rng = np.random.default_rng(seed)
    box = np.full((B, 3), 3.0)
    pos = rng.uniform(-1.5, 1.5, size=(B, N, 3))
    h = rng.normal(size=(B, N, NF))
    mask = np.ones((B, N), bool)
    mask[1, -1] = False
    mask[3] = False
    pos[~mask] = 0.0
    h[~mask] = 0.0
    r_cut = np.full((B,), 2.5)
    return h, pos, box, mask, r_cut


def _cap(pos, box, mask, r_cut):
    mx = max(image_edge_max(pos[b][mask[b]], box[b], r_cut[b])
             for b in range(B) if mask[b].any())
    return mx + 3                     # room for invalid slots too


def test_images_neighbors_match_jax():
    h, pos, box, mask, r_cut = _images_state(1)
    cap = _cap(pos, box, mask, r_cut)
    jn, jd, jx = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                        jnp.asarray(r_cut), capacity=cap, mode="images",
                        with_overflow=True)
    t = torch.from_numpy
    tn, td, tx = neighbors_with_diffs(t(pos), t(box), t(mask), t(r_cut),
                                      cap, "images", with_overflow=True)
    jm, jidx, jdiff = (np.asarray(a) for a in (jn.mask, jn.idx, jd))
    np.testing.assert_array_equal(tn.mask.sum(-1).numpy(), jm.sum(-1))
    for b in range(B):
        for i in range(N):
            key = lambda idx, d, m: sorted(
                (int(j), *np.round(v, 12)) for j, v, ok in zip(idx, d, m)
                if ok)
            assert key(tn.idx[b, i].numpy(), td[b, i].numpy(),
                       tn.mask[b, i].numpy()) == key(jidx[b, i], jdiff[b, i],
                                                     jm[b, i])
    assert (td[~tn.mask] == 0).all()
    assert int(tx) == int(jx) == 0
    # a capacity below the count truncates: the excess agrees
    _, _, tx2 = neighbors_with_diffs(t(pos), t(box), t(mask), t(r_cut),
                                     4, "images", with_overflow=True)
    _, _, jx2 = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                       jnp.asarray(r_cut), capacity=4, mode="images",
                       with_overflow=True)
    assert int(tx2) == int(jx2) > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gathered_egcl_matches_jax_f64(use_pallas):
    """The plain gathered path (``use_pallas`` off) and the kernel's plain
    version (``use_pallas`` on) against the JAX XLA path at float64."""
    h, pos, box, mask, r_cut = _images_state(2)
    cap = _cap(pos, box, mask, r_cut)
    jn, jd = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                    jnp.asarray(r_cut), capacity=cap, mode="images")
    jp = j_init_egcl(jax.random.PRNGKey(4), JEGCLConfig(NF, H), jnp.float64)
    want = j_apply_egcl(jp, JEGCLConfig(NF, H), jnp.asarray(h), jd, jn.idx,
                        jn.mask, jnp.asarray(mask))
    t = lambda a: torch.from_numpy(np.asarray(a))
    ops.counts.reset()
    got = apply_egcl(from_jax_params(jp, device="cpu"),
                     EGCLConfig(NF, H, use_pallas=use_pallas), t(h), t(jd),
                     t(jn.idx), t(jn.mask), t(mask))
    assert ops.counts.plain_fwd_calls == int(use_pallas)
    for g, w, name in zip(got, want, "QFG"):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_gathered_kernel_path_rejects_flags():
    h, pos, box, mask, r_cut = _images_state(0)
    t = torch.from_numpy
    nb, cd = neighbors_with_diffs(t(pos), t(box), t(mask), t(r_cut), 16,
                                  "images")
    jp = j_init_egcl(jax.random.PRNGKey(4), JEGCLConfig(NF, H), jnp.float64)
    with pytest.raises(ValueError, match="attention"):
        apply_egcl(from_jax_params(jp, device="cpu"),
                   EGCLConfig(NF, H, attention=True, use_pallas=True), t(h),
                   cd, nb.idx, nb.mask, t(mask))


# --- the wrapper's launch plan (tiling and size rule) ----------------------

@pytest.mark.parametrize("A,K,n_sm", [(390, 24, 132), (1000, 40, 132),
                                      (777, 13, 132), (2944, 24, 132),
                                      (37, 5, 4), (1, 3, 132)])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_row_tiles_cover_whole_atoms(A, K, n_sm, direction):
    ta, blocks = ops.grid(A, n_sm)
    rows = ops.tile_rows(ops.ROWS_MAX[direction], ta, K)
    assert rows % 8 == 0 and rows <= ops.ROWS_MAX[direction]
    tiles = ops.row_tiles(A, K, ta, blocks, rows)
    assert len(tiles) == blocks <= n_sm            # one part slice a block
    assert all(tiles)                              # every block has work
    owner = {}
    rows = []
    for b, block in enumerate(tiles):
        for a0, na, g0, nr, computed in block:
            assert 1 <= na <= ops.MAX_ATOM_TILE
            assert 1 <= nr <= ops.ROWS_MAX[direction]
            assert computed % 8 == 0 and nr <= computed < nr + 8
            # a tile's rows lie inside its atoms, whose rows all stay in
            # this block
            assert a0 * K <= g0 and g0 + nr <= (a0 + na) * K
            for a in range(a0, a0 + na):
                assert owner.setdefault(a, b) == b
            rows += range(g0, g0 + nr)
    assert sorted(owner) == list(range(A))
    assert sorted(rows) == list(range(A * K))      # each row once


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_padding_at_the_training_shape(direction):
    """train.yaml: 30 molecules of 13 atoms, auto capacity 24 slots. The
    tiled kernels compute under 10% padded rows (the chunked kernels' 32-row
    chunks: 25%)."""
    ta, blocks = ops.grid(390, 132)
    rows = ops.tile_rows(ops.ROWS_MAX[direction], ta, 24)
    tiles = ops.row_tiles(390, 24, ta, blocks, rows)
    real = sum(t[3] for block in tiles for t in block)
    computed = sum(t[4] for block in tiles for t in block)
    assert real == 390 * 24
    assert (computed - real) / computed < 0.10


def test_size_rule():
    assert ops.kernel_for(torch.float32, 64) == "tiled"
    assert ops.kernel_for(torch.float32, 128) == "tiled"
    # bf16 at the tiled widths: the Hopper kernels (edge_pipeline_sm90.cu)
    assert ops.kernel_for(torch.bfloat16, 64) == "sm90"
    assert ops.kernel_for(torch.bfloat16, 128) == "sm90"
    # other widths run zero-padded to the next of 64 / 128 / 192 / 256
    for dt in (torch.float32, torch.bfloat16):
        assert ops.kernel_for(dt, 96) == ops.kernel_for(dt, 128)
    assert ops.kernel_for(torch.float32, 20) == "tiled"
    assert ops.kernel_for(torch.bfloat16, 24) == "sm90"
    assert ops.kernel_for(torch.float32, 6) == "tiled"
    for dt, H in ((torch.bfloat16, 300), (torch.float32, 260),
                  (torch.float32, 0), (torch.float64, 128)):
        with pytest.raises(ValueError, match="float32|B7.2"):
            ops.kernel_for(dt, H)
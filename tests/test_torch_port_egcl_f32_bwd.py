"""Port parity: the tiled f32 input-gradient all-pairs EGCL backward (K2).

``csrc/egcl_allpairs_f32.cu`` ``egcl_f32_bwd_kernel`` computes
``_bwd_kernel``'s dh and dpos (``enflow_tpu/ops/egcl_fused_v3.py:209``)
on the row schedule of the tiled f32 kernels (``ops.f32_grid``,
``ops.tile_rows``, ``ops.row_tiles`` with the ``"bwd"`` row limit), and
takes dh's node sums after the first layer's transposes: per row
``dz1_ij W1a^T`` (summed on the i side) and ``dz1_ij W1b^T`` (on the j
side), beside dcd, so that an atom keeps ``2 (nf + 3)`` floats of sums.
``f32_bwd`` below emulates that schedule in plain PyTorch (the same
tiles, rows, padding, per-row vector ``[dz1 W1a^T, dcd, dz1 W1b^T]`` and
sums in the same places); nothing on the main path uses it. It is held
against

- the plain version of the contract (``allpairs_edges_plain_bwd``) at
  float64, to 1e-10 of each output's largest value: the two differ only by
  the order of the sums;
- the v3 Pallas kernel's input-gradient VJP in interpret mode at float32,
  at the tolerances of ``test_torch_port_egcl.py`` (rtol 5e-5 / atol
  5e-6), for N in {4, 13, 22}.

The cases and inputs are those of ``test_torch_port_egcl_f32_tiles.py``
(B = 7 molecules over 3 blocks, ragged masks, a molecule with one real
atom and one with none, periodic boxes; numpy from a seed).
"""

import math

import numpy as np
import pytest
import torch

from test_torch_port_egcl_f32_tiles import (B, FITS, NF, NS, _args, _chain,
                                            _pallas, _rows, _tile_sum, plan)

from enflow_tpu_torch.ops import egcl_allpairs as ops
from torch_threads import one_torch_thread  # noqa: F401


def f32_bwd(h, pos, box, mask_f, W, dagg, dfsum, fit=None):
    """The input-gradient backward's schedule: ``(dh, dpos)`` as
    ``allpairs_edges_plain_bwd`` returns them."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = W
    Bm, N, nf = h.shape
    cdt, acc = h.dtype, ops._acc(h.dtype)
    mt, blocks, rows = plan(Bm, N, "bwd", fit)
    dh = torch.zeros((Bm, N, nf), dtype=cdt)
    dpos = torch.zeros((Bm, N, 3), dtype=acc)
    f = lambda t: t.to(acc)
    for tiles in ops.row_tiles(Bm, N, mt, blocks, rows):
        for b0, nm, g0, nr in tiles:
            if g0 == 0:
                si = torch.zeros((nm * N, nf + 3), dtype=acc)
                sj = torch.zeros((nm * N, nf + 3), dtype=acc)
            m, i, j, live = _rows(N, g0, nr)
            cd, r2, valid, z1, z2, _, _, z3, _, gate = _chain(
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
            dcd = d_cd + 2.0 * cd * d_r2
            # the row's vector: [dz1 W1a^T, dcd, dz1 W1b^T]
            V = torch.cat([f(dz1) @ f(W1a).T, dcd, f(dz1) @ f(W1b).T],
                          dim=-1)[:nr]
            si += _tile_sum(nm * N, (m * N + i)[:nr], V[:, :nf + 3])
            sj += _tile_sum(nm * N, (m * N + j)[:nr], V[:, nf:])
            if g0 + nr == nm * N * (N - 1):
                dh[b0:b0 + nm] = (si[:, :nf] + sj[:, 3:]).view(
                    nm, N, nf).to(cdt)
                dpos[b0:b0 + nm] = (si[:, nf:] - sj[:, :3]).view(nm, N, 3)
    return dh, dpos


def test_size_rule_sends_f32_bwd_to_the_tiled_kernel():
    """float32 input gradients at H = 64 / 128 go to the tiled f32 kernel,
    and H = 96 too, zero-padded to 128; the widths that pad to 192 or 256
    go to the f32 block pairs with streamed weights (``"f32_wide"``, their
    own launch counters)."""
    assert ops.kernel_for(0, 128, "bwd") == "f32"
    assert ops.kernel_for(0, 64, "bwd") == "f32"
    assert ops.kernel_for(0, 96, "bwd") == "f32"
    assert ops.kernel_for(0, 160, "bwd") == "f32_wide"
    assert ops.kernel_for(1, 128, "bwd") == "sm90"


@pytest.mark.parametrize("fit", FITS)
@pytest.mark.parametrize("N", NS)
def test_bwd_schedule_visits_each_pair_once(N, fit):
    """The ``"bwd"`` kind's plan: row tiles of at most 72 rows (a multiple
    of 8), whole molecule tiles over the blocks, every pair i != j of every
    molecule once."""
    mt, blocks, rows = plan(B, N, "bwd", fit)
    assert rows % 8 == 0 and 8 <= rows <= ops.F32_ROWS_MAX["bwd"] == 72
    assert blocks == min(math.ceil(B / mt), 3)
    seen = []
    for block in ops.row_tiles(B, N, mt, blocks, rows):
        for b0, nm, g0, nr in block:
            m, i, j, _ = _rows(N, g0, nr)
            seen += list(zip((b0 + m[:nr]).tolist(), i[:nr].tolist(),
                             j[:nr].tolist()))
    want = [(b, a, c) for b in range(B) for a in range(N) for c in range(N)
            if a != c]
    assert sorted(seen) == want and len(seen) == len(want)


def test_bwd_plan_at_the_committed_shapes():
    """sample_ala2.yaml (B=2048, N=22) and vi_ala2.yaml (B=256): one
    molecule a tile, 462 rows in 8 tiles of at most 64 when 64 rows fit;
    B=1024, N=13: 156 rows in 3 tiles of 56; vi_dw4.yaml's shape (B=512,
    N=4) packs molecules as the other kinds do."""
    assert ops.f32_grid(2048, 22, 132, "bwd") == (1, 132)
    assert ops.f32_grid(256, 22, 132, "bwd") == (1, 132)
    assert ops.tile_rows(64, 462) == 64 and ops.tile_rows(72, 462) == 72
    assert ops.f32_grid(1024, 13, 132, "bwd") == (1, 132)
    assert ops.tile_rows(64, 156) == 56
    assert ops.f32_grid(512, 4, 132, "bwd") == (4, 128)


@pytest.mark.parametrize("fit", FITS)
@pytest.mark.parametrize("N", NS)
def test_f32_bwd_matches_plain_f64(N, fit):
    """The schedule with the per-row transposes against the plain backward
    at float64: dh and dpos to 1e-10 of their largest values; padded atoms
    and the empty molecule receive nothing."""
    args, (_, _, _, mask), _, dagg, dfsum = _args(N, 1100 + N, np.float64,
                                                  7)
    t = lambda a: torch.from_numpy(a)
    got = f32_bwd(*args, t(dagg), t(dfsum), fit=fit)
    want = ops.allpairs_edges_plain_bwd(*args, t(dagg), t(dfsum))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        w = w.numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
        assert float(g[torch.from_numpy(~mask)].abs().max()) == 0.0
        assert float(g[3].abs().max()) == 0.0


@pytest.mark.parametrize("N", (4, 13, 22))
def test_f32_bwd_matches_pallas_f32(N):
    """Against ``_fused_bwd`` in interpret mode at float32: dh and dpos of
    the input-gradient VJP at rtol 5e-5 / atol 5e-6, with 16-row tiles (so
    that molecules straddle them)."""
    args, raw, jp, c_agg, c_fs = _args(N, 1200 + N, np.float32, 13)
    _, (_, jgh, jgp) = _pallas(jp, *raw, c_agg, c_fs)
    t = lambda a: torch.from_numpy(a)
    dh, dpos = f32_bwd(*args, t(c_agg), t(c_fs), fit=16)
    for got, want in ((dh, jgh), (dpos, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-5, atol=5e-6)

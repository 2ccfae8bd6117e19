"""Fused all-pairs EGCL edge pipeline: the port of
``enflow_tpu/ops/egcl_fused_v3.py`` (and of the v2 kernel in
``ops/egcl_fused.py``, which computes the same function).

Contract (``fused_allpairs_edges``): EGCL params, ``h [B,N,nf]`` in the
compute dtype, ``pos [B,N,3]``, ``box [B,3]``, ``atom_mask [B,N]`` ->
``(agg [B,N,H], f_sum [B,N,3], count [B,N,1])``, matching
``edge_messages`` + masked neighbor sums in ``all_pairs`` mode with
attention/norm_diff/tanh off.

- On a CUDA tensor the forward launches a hand-written kernel. The
  backward recomputes the forward from the inputs (the only residuals the
  autograd Function saves) in one of two kernel variants: input gradients
  only (``dh``, ``dpos``) when no weight needs a gradient, as in sampling,
  or with the nine parameter gradients of ``_bwd_kernel:265-273`` as well,
  as in training. :func:`kernel_for` is the size rule and
  :func:`route_for` the molecule-size rule after it, both on the padded
  width (below). At H = 64 or 128 bf16 runs the Hopper kernels of
  ``csrc/egcl_allpairs_sm90.cu`` (wgmma, persistent warpgroups) in every
  direction: one molecule a warpgroup while its atoms fit in shared
  memory, and past that the same file's block-pair kernels (route
  ``"blocks"``, every N: a warpgroup per molecule and block of atoms,
  walking the other blocks), counted on their own launch counters
  (``*_blocks_launches``). At H = 192 or 256 bf16 runs the same block-pair
  kernels with W2 and W3 streamed through shared memory in slabs (route
  ``"wide"``, every N; counters ``*_wide_launches``). Float32 runs the
  tiled f32 kernels of ``csrc/egcl_allpairs_f32.cu`` (persistent blocks,
  register tiles) at H = 64 or 128, also in every direction: one or more
  whole molecules a block while they fit its shared memory, and past that
  the same file's block-pair kernels (route ``"f32_blocks"``, every N, on
  the same row code; counters ``*_f32_blocks_launches``). Float32 at H =
  192 or 256 runs the same f32 block-pair kernels with W2 and W3 streamed
  through shared memory in slabs (route ``"f32_wide"``, every N; counters
  ``*_f32_wide_launches``; plan :func:`f32_wide_plan`). Past 256 every
  launch goes to the kernels of ``csrc/egcl_allpairs_xwide.cu`` (route
  ``"xwide"``, bf16 on wgmma, and ``"f32_xwide"``, float32 on the FMA
  units; every N and nf; counters ``*_xwide_launches`` /
  ``*_f32_xwide_launches``): the first layer from the per-atom projections
  of ``csrc/egcl_wide_nf.cuh``, tiles of 8 x 8 atoms, every H x H product
  in 64-column output chunks over 64-row k-chunks of the weight, the
  activations in global memory, so that nothing in a block's shared memory
  or registers grows with H. Only a width past ``XWIDE_MAX_H`` (11,520,
  where one K2 p slice would pass 1 GiB) is refused (``XWIDE_ITEM``). There
  is no fallback: a kernel that does not build or launch raises.
- Wide node features: every route above keeps the first layer's W1a and
  W1b [nf, H] whole in shared memory, so at a wide ``nf`` the block-pair
  plan finds no block of 8 atoms (bf16 at H = 256: K2 past nf ~14; f32 at
  H = 256 past ~24-32; at H = 128 past ~60-110). Exactly those launches
  (the block-pair plan of the parent route raises, as the libraries' byte
  functions decide) go to route ``"wide_nf"`` (bf16) or ``"f32_wide_nf"``
  (float32), every H and N, counters ``*_wide_nf_launches`` /
  ``*_f32_wide_nf_launches``: the same block-pair kernels built with their
  PROJ flag, which read the per-atom projections h W1a and h W1b from a
  [B, N, 2H] buffer that a kernel of ``csrc/egcl_wide_nf.cuh`` computes
  first, and whose backward hands each atom's dz1 sums to that header's
  kernels for dh, dW1a and dW1b (:func:`wide_nf_plan`; nothing in their
  shared memory grows with nf, so no nf is refused).
- Every other width is zero-padded to the next of 64, 128, 192 and 256,
  past 256 to the next multiple of 64 (:func:`padded_width`), which is
  exact: the padded columns of
  W1a, W1b, w1r and b1, the padded rows and columns of W2 and W3, and the
  padded entries of b2, b3 and w4 are zeros, so z1, z2 and z3 are exact
  zeros there, SiLU(0) = 0, and every sum over them adds exact zeros. The
  wrapper copies the weights (and the backward's dagg) into Hp-wide
  buffers (:func:`pad_weights`, :func:`pad_rows`), launches at Hp and
  takes the first H columns of agg and of the gradients back
  (:func:`unpad_grads`); a padded launch also counts on
  ``padded_launches``. At H = 64, 128, 192, 256 and any multiple of 64 past
  256 nothing is copied. The kernels take their own widths only (the
  copies, not a row stride and masks, carry the other widths onto
  them).
- On a CPU tensor both directions run the plain PyTorch version below,
  which repeats the kernel's arithmetic (including where it rounds to the
  compute dtype) and is what the CPU tests hold against the Pallas kernel.

The parameter gradients are float32 sums; the autograd Function rounds
each to its weight's dtype, as ``_fused_bwd`` does on return
(``egcl_fused_v3.py:455-460``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import LaunchCounts, multiprocessors
from .widths import (PADDED_H, SMEM_LIMIT, XWIDE_ITEM, XWIDE_MAX_H,
                     XWIDE_SLICE_BYTES, pad_rows, padded_width)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# fwd_launches / bwd_launches / bwd_param_launches: K1, the input-gradient
# K2 and K2 with parameter gradients at H = 64 or 128 (bf16: the Hopper
# kernels, one molecule a warpgroup; float32: the tiled f32 K1 and K2 p);
# bwd_f32_launches: the tiled f32 input-gradient K2 there; *_blocks_launches:
# the bf16 Hopper block-pair kernels (molecules past the first's shared
# memory); *_wide_launches: the same kernels at H = 192 or 256 (streamed
# weights); *_f32_blocks_launches: the f32 block-pair kernels (molecules
# past the tiled f32 kernels' shared memory); *_f32_wide_launches: the
# same f32 kernels at H = 192 or 256 (streamed weights); padded_launches:
# launches of any route at a padded width (each counts on its route's
# counter too); *_wide_nf_launches / *_f32_wide_nf_launches: the block-pair
# kernels of either dtype with the first layer's projections precomputed
# (node-feature widths past the other routes' shared memory);
# *_xwide_launches / *_f32_xwide_launches: the kernels of H > 256
counts = LaunchCounts("fwd_launches", "bwd_launches", "bwd_f32_launches",
                      "bwd_param_launches", "fwd_blocks_launches",
                      "bwd_blocks_launches", "bwd_param_blocks_launches",
                      "fwd_wide_launches", "bwd_wide_launches",
                      "bwd_param_wide_launches",
                      "fwd_f32_blocks_launches", "bwd_f32_blocks_launches",
                      "bwd_param_f32_blocks_launches",
                      "fwd_f32_wide_launches", "bwd_f32_wide_launches",
                      "bwd_param_f32_wide_launches",
                      "fwd_wide_nf_launches", "bwd_wide_nf_launches",
                      "bwd_param_wide_nf_launches",
                      "fwd_f32_wide_nf_launches", "bwd_f32_wide_nf_launches",
                      "bwd_param_f32_wide_nf_launches",
                      "fwd_xwide_launches", "bwd_xwide_launches",
                      "bwd_param_xwide_launches",
                      "fwd_f32_xwide_launches", "bwd_f32_xwide_launches",
                      "bwd_param_f32_xwide_launches", "padded_launches",
                      "plain_fwd_calls", "plain_bwd_calls",
                      "plain_bwd_param_calls")
# the launch kinds of egcl_sm90_smem_bytes and egcl_f32_smem_bytes
_KIND = {"fwd": 0, "bwd": 1, "bwd_params": 2}
# the hidden widths of the Hopper kernels (bf16) and the tiled f32 kernels
SM90_H = (64, 128)
# the widths of the block-pair kernels with streamed weights (routes
# "wide", bf16, and "f32_wide"); every width a launch runs at is PADDED_H
# (others are zero-padded up)
WIDE_H = (192, 256)
# the tiled f32 kernels: rows a row tile at most (kQmaxFwd / kQmaxBwdIn /
# kQmaxBwd x 8) and molecules a tile at most
F32_ROWS_MAX = {"fwd": 72, "bwd": 72, "bwd_params": 40}
MAX_MOL_TILE = 16
# the bf16 block-pair kernels: warpgroups a block of threads at most
# (kMaxWGFwd / kMaxWGBwd), and atoms a block at most: of 16 to 56, 32 ran
# fastest in every direction at LJ147 on the H100 (chip_smoke.py
# --blocks-plans, PERF.md)
BLOCK_WG_MAX = {"fwd": 3, "bwd": 2, "bwd_params": 2}
BLOCK_ATOMS_MAX = 32
# the f32 block-pair kernels: atoms a block at most (a multiple of 8; the
# plan takes fewer where no row tile of 8 rows fits beside them): of 16 to
# 48, the fastest on the H100 were 32 for K1 and 24 for K2 p at LJ147
# (B=256) and for K2 at LJ561 (B=16) (chip_smoke.py --blocks-plans,
# PERF.md)
F32_BLOCK_ATOMS = {"fwd": 32, "bwd": 24, "bwd_params": 24}
# the routes of H > 256 (csrc/egcl_allpairs_xwide.cu), by dtype code (the
# widest padded H they take and the queue item past it: widths.py)
XWIDE_ROUTE = {0: "f32_xwide", 1: "xwide"}
# the routes that take every N (no one-molecule kernels to ask)
EVERY_N_ROUTES = ("wide", "f32_wide", *XWIDE_ROUTE.values())
# the queue item past the wide-nf route (no width up to 256 reaches it)
NF_ITEM = "ROADMAP queue B, B7.4: the all-pairs EGCL at wide node features"
# the routes that take the block-pair launches whose plan finds no block
# at a wide nf, by dtype code (0 float32, 1 bf16), and the block-pair
# routes they stand in for
WIDE_NF_ROUTE = {0: "f32_wide_nf", 1: "wide_nf"}
BLOCK_ROUTES = ("blocks", "wide", "f32_blocks", "f32_wide")


def split_params(W1, b1, nf: int):
    """Slice the concat-form first layer ``[2nf+1, H]`` into its h_i / h_j /
    r^2 rows (``egcl_fused_v3.py:341-344``)."""
    return W1[:nf], W1[nf:2 * nf], W1[2 * nf:2 * nf + 1], b1[None, :]


# ---------------------------------------------------------------------------
# the padded width (``widths.padded_width``)
# ---------------------------------------------------------------------------

def pad_weights(weights, Hp: int):
    """The nine weights ``(W1a [nf, H], W1b, w1r [1, H], b1, W2 [H, H],
    b2, W3, b3, w4 [H, 1])`` zero-padded to hidden width ``Hp``: new
    contiguous tensors, every padded entry 0."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    H = W2.shape[1]
    square = lambda t: torch.nn.functional.pad(t, (0, Hp - H, 0, Hp - H))
    return (pad_rows(W1a, Hp), pad_rows(W1b, Hp), pad_rows(w1r, Hp),
            pad_rows(b1, Hp), square(W2), pad_rows(b2, Hp), square(W3),
            pad_rows(b3, Hp), torch.nn.functional.pad(w4, (0, 0, 0, Hp - H)))


def unpad_grads(grads, H: int):
    """The nine parameter gradients of a launch at a padded width, in the
    weights' order and shapes, cut back to hidden width ``H``."""
    dW1a, dW1b, dw1r, db1, dW2, db2, dW3, db3, dw4 = grads
    return (dW1a[:, :H], dW1b[:, :H], dw1r[:, :H], db1[:, :H], dW2[:H, :H],
            db2[:, :H], dW3[:H, :H], db3[:, :H], dw4[:H])


def _too_wide(H: int) -> str:
    """Why a width past ``XWIDE_MAX_H`` is refused: one K2 p slice of the
    xwide route (dW2 and dW3, 2 Hp^2 f32, and the vectors) would pass the
    1 GiB that the route's partials may take."""
    Hp = padded_width(H)
    need = 4 * ((2 * Hp * Hp + 5 * Hp + 7) // 8 * 8)
    return (f"egcl_allpairs: hidden width H={H} (padded {Hp}) is past the "
            f"widest the xwide kernels take (H <= {XWIDE_MAX_H:,}): one "
            f"block's slice of the parameter gradients would need {need:,} "
            f"bytes, more than the {XWIDE_SLICE_BYTES:,} bytes the route's "
            f"partials may take; not ported ({XWIDE_ITEM})")


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel contract
# ---------------------------------------------------------------------------

def _acc(dtype):
    """The accumulation dtype: float32 for the kernels' compute dtypes
    (float32, bfloat16), float64 for float64 (the tile-schedule test's
    exact reference)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _dot(a, b, out_dtype):
    """Product with f32 accumulation (f64 for f64), rounded to
    ``out_dtype``."""
    acc = _acc(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(out_dtype)


def _silu(x):
    xf = x.to(_acc(x.dtype))
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def _dsilu(x):
    xf = x.to(_acc(x.dtype))
    s = torch.sigmoid(xf)
    return (s * (1.0 + xf * (1.0 - s))).to(x.dtype)


def _block(h, pos, box, mask_f, weights):
    """Forward evaluation over all ``[B, N, N]`` edges (``_fwd_block``)."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    cdt, acc = h.dtype, _acc(h.dtype)
    N = h.shape[1]
    cd = pos[:, :, None, :] - pos[:, None, :, :]
    bx = box[:, None, None, :]
    cd = cd - torch.round(cd / bx) * bx                       # f32
    r2 = (cd * cd).sum(-1, keepdim=True)                      # [B,N,N,1] f32
    mf = mask_f.to(acc)
    not_self = 1.0 - torch.eye(N, dtype=acc, device=h.device)
    valid = (mf[:, :, None] * mf[:, None, :] * not_self)[..., None]
    validc = valid.to(cdt)
    zi = _dot(h, W1a, cdt)[:, :, None, :]
    zj = _dot(h, W1b, cdt)[:, None, :, :]
    z1 = zi + zj + b1 + r2.to(cdt) * w1r                      # [B,N,N,H]
    m1 = _silu(z1)
    z2 = _dot(m1, W2, cdt) + b2
    m2 = _silu(z2) * validc
    z3 = _dot(m2, W3, cdt) + b3
    g1 = _silu(z3)
    gate = _dot(g1, w4, acc)                                  # [B,N,N,1]
    return cd, r2, valid, validc, z1, z2, m2, z3, gate


def allpairs_edges_plain(h, pos, box, mask_f, weights):
    """Plain forward: ``(agg [B,N,H], f_sum [B,N,3])`` in the compute dtype."""
    cdt, acc = h.dtype, _acc(h.dtype)
    cd, _, valid, _, _, _, m2, _, gate = _block(h, pos, box, mask_f,
                                                weights)
    trans = torch.clamp(cd * gate, -100.0, 100.0) * valid
    agg = m2.to(acc).sum(2).to(cdt)
    fsum = trans.to(cdt).to(acc).sum(2).to(cdt)
    return agg, fsum


def allpairs_edges_plain_bwd(h, pos, box, mask_f, weights, dagg, dfsum,
                             params=False, terms=False):
    """Plain backward (``_bwd_kernel``): ``(dh, dpos)``, and with ``params``
    the parameter gradients after them, ``dW1a, dW1b, dw1r, db1, dW2, db2,
    dW3, db3, dw4`` in the weights' shapes as float32 sums of the
    compute-dtype operands (``_bwd_kernel:265-273``: dw1r takes the
    unrounded r2, dw4 the unrounded dgate). With ``terms`` each of the
    nine is instead the sum of its terms' magnitudes (``|a|^T |b|``), the
    scale that the round-off of a sum of those terms grows with; with
    ``terms="l2"`` the root of the sum of their squares, the scale of the
    change when each term moves by a step in a random direction."""
    W1a, W1b, w1r, b1, W2, b2, W3, b3, w4 = weights
    cdt, acc = h.dtype, _acc(h.dtype)
    cd, r2, valid, validc, z1, z2, m2, z3, gate = _block(h, pos, box, mask_f,
                                                         weights)
    d_m2_agg = dagg.to(cdt)[:, :, None, :]
    d_trans = dfsum.to(cdt).to(acc)[:, :, None, :]
    trans_raw = cd * gate
    inside = ((trans_raw >= -100.0) & (trans_raw <= 100.0)).to(acc)
    d_trans = d_trans * inside * valid
    d_gate = (cd * d_trans).sum(-1, keepdim=True)             # f32
    d_cd = gate * d_trans
    d_g1 = _dot(d_gate.to(cdt), w4.T, cdt)
    dz3 = d_g1 * _dsilu(z3)
    d_m2 = (_dot(dz3, W3.T, cdt) + d_m2_agg) * validc
    dz2 = d_m2 * _dsilu(z2)
    dz1 = _dot(dz2, W2.T, cdt) * _dsilu(z1)
    d_r2 = (dz1.to(acc) * w1r.to(acc)).sum(-1, keepdim=True)
    d_cd = d_cd + 2.0 * cd * d_r2
    dz1_i = dz1.to(acc).sum(2)                                # over j
    dz1_j = dz1.to(acc).sum(1)                                # over i
    dh = (_dot(dz1_i.to(cdt), W1a.T, acc)
          + _dot(dz1_j.to(cdt), W1b.T, acc)).to(cdt)
    d_cd_c = d_cd.to(cdt).to(acc)
    dpos = d_cd_c.sum(2) - d_cd_c.sum(1)
    if not params:
        return dh, dpos
    B, N, nf = h.shape
    mag = {False: lambda t: t, True: torch.abs, "l2": torch.square}[terms]
    flat = lambda t: mag(t.reshape(-1, t.shape[-1]).to(acc))
    col = lambda t: flat(t).sum(0)[None]
    h_i = h[:, :, None, :].expand(B, N, N, nf)
    h_j = h[:, None, :, :].expand(B, N, N, nf)
    grads = (flat(h_i).T @ flat(dz1), flat(h_j).T @ flat(dz1),
             col(r2 * dz1.to(acc)), col(dz1),
             flat(_silu(z1)).T @ flat(dz2), col(dz2),
             flat(m2).T @ flat(dz3), col(dz3),
             flat(_silu(z3)).T @ flat(d_gate))
    if terms == "l2":
        grads = tuple(g.sqrt() for g in grads)
    return (dh, dpos) + grads


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _bind_part_size(lib):
    """``egcl_part_size(nf, H)``: the floats of the nine gradients at the
    start of a slice of the partials, defined once in
    ``csrc/egcl_part_layout.cuh`` and compiled into both libraries."""
    lib.egcl_part_size.argtypes = [_I, _I]
    lib.egcl_part_size.restype = _I


def _bind_wide_nf(lib, pre: str, n_in: int):
    """The wide_nf entry points of either library (``<pre>_wide_nf_*``):
    B, N, nf, H, the plan's two numbers, blocks (and K2 p's dW1 splits),
    the inputs, then the projections, the outputs and scratch, stream."""
    f = lambda name: getattr(lib, f"{pre}_wide_nf_{name}")
    f("fwd").argtypes = [_I] * 7 + [_P] * (n_in + 4)
    f("bwd").argtypes = [_I] * 7 + [_P] * (n_in + 9)
    f("bwd_params").argtypes = [_I] * 8 + [_P] * (n_in + 11)
    for name in ("fwd", "bwd", "bwd_params", "splits"):
        f(name).restype = _I
    f("splits").argtypes = [_I] * 4
    f("smem_bytes").argtypes = [_I] * 4
    f("smem_bytes").restype = _LL


def _sm90_library():
    from .build import load
    lib = load("egcl_allpairs_sm90")
    if not getattr(lib, "_enflow_bound", False):
        n_in = 13
        # B, N, nf, H, blocks, inputs, outputs, stream
        lib.egcl_sm90_fwd.argtypes = [_I] * 5 + [_P] * (n_in + 3)
        lib.egcl_sm90_fwd.restype = _I
        lib.egcl_sm90_bwd.argtypes = [_I] * 5 + [_P] * (n_in + 5)
        lib.egcl_sm90_bwd.restype = _I
        lib.egcl_sm90_bwd_params.argtypes = [_I] * 5 + [_P] * (n_in + 6)
        lib.egcl_sm90_bwd_params.restype = _I
        lib.egcl_sm90_param_slices.argtypes = [_I] * 5
        lib.egcl_sm90_param_slices.restype = _I
        lib.egcl_sm90_slice_floats.argtypes = [_I, _I]
        lib.egcl_sm90_slice_floats.restype = _I
        _bind_part_size(lib)
        lib.egcl_sm90_smem_bytes.argtypes = [_I] * 4
        lib.egcl_sm90_smem_bytes.restype = _LL
        lib.egcl_sm90_smem_limit.argtypes = []
        lib.egcl_sm90_smem_limit.restype = _LL
        lib.egcl_sm90_blocks_fwd.argtypes = [_I] * 7 + [_P] * (n_in + 3)
        lib.egcl_sm90_blocks_fwd.restype = _I
        lib.egcl_sm90_blocks_bwd.argtypes = [_I] * 7 + [_P] * (n_in + 7)
        lib.egcl_sm90_blocks_bwd.restype = _I
        lib.egcl_sm90_blocks_bwd_params.argtypes = [_I] * 7 + [_P] * (n_in
                                                                     + 8)
        lib.egcl_sm90_blocks_bwd_params.restype = _I
        lib.egcl_sm90_blocks_smem_bytes.argtypes = [_I] * 5
        lib.egcl_sm90_blocks_smem_bytes.restype = _LL
        lib.egcl_sm90_blocks_param_slices.argtypes = [_I] * 5
        lib.egcl_sm90_blocks_param_slices.restype = _I
        lib.egcl_sm90_error_string.argtypes = [_I]
        lib.egcl_sm90_error_string.restype = ctypes.c_char_p
        _bind_wide_nf(lib, "egcl_sm90", n_in)
        lib._enflow_bound = True
    return lib


def _f32_library():
    from .build import load
    lib = load("egcl_allpairs_f32")
    if not getattr(lib, "_enflow_bound", False):
        n_in = 13
        # B, N, nf, H, MT, R, blocks, inputs, outputs, stream
        lib.egcl_f32_fwd.argtypes = [_I] * 7 + [_P] * (n_in + 3)
        lib.egcl_f32_fwd.restype = _I
        lib.egcl_f32_bwd.argtypes = [_I] * 7 + [_P] * (n_in + 5)
        lib.egcl_f32_bwd.restype = _I
        lib.egcl_f32_bwd_params.argtypes = [_I] * 7 + [_P] * (n_in + 6)
        lib.egcl_f32_bwd_params.restype = _I
        lib.egcl_f32_smem_bytes.argtypes = [_I] * 6
        lib.egcl_f32_smem_bytes.restype = _LL
        lib.egcl_f32_smem_limit.argtypes = []
        lib.egcl_f32_smem_limit.restype = _LL
        lib.egcl_f32_blocks_fwd.argtypes = [_I] * 7 + [_P] * (n_in + 3)
        lib.egcl_f32_blocks_fwd.restype = _I
        lib.egcl_f32_blocks_bwd.argtypes = [_I] * 7 + [_P] * (n_in + 7)
        lib.egcl_f32_blocks_bwd.restype = _I
        lib.egcl_f32_blocks_bwd_params.argtypes = [_I] * 7 + [_P] * (n_in + 8)
        lib.egcl_f32_blocks_bwd_params.restype = _I
        lib.egcl_f32_blocks_smem_bytes.argtypes = [_I] * 5
        lib.egcl_f32_blocks_smem_bytes.restype = _LL
        _bind_part_size(lib)
        lib.egcl_f32_error_string.argtypes = [_I]
        lib.egcl_f32_error_string.restype = ctypes.c_char_p
        _bind_wide_nf(lib, "egcl_f32", n_in)
        lib._enflow_bound = True
    return lib


def _xwide_library():
    from .build import load
    lib = load("egcl_allpairs_xwide")
    if not getattr(lib, "_enflow_bound", False):
        n_in = 13
        # code, B, N, nf, H, blocks (and K2 p's splits), the inputs, then
        # scratch and outputs, stream
        lib.egcl_xwide_fwd.argtypes = [_I] * 6 + [_P] * (n_in + 6)
        lib.egcl_xwide_bwd.argtypes = [_I] * 6 + [_P] * (n_in + 10)
        lib.egcl_xwide_bwd_params.argtypes = [_I] * 7 + [_P] * (n_in + 12)
        for name in ("fwd", "bwd", "bwd_params", "grid", "splits",
                     "threads", "tiles", "max_width"):
            getattr(lib, f"egcl_xwide_{name}").restype = _I
        lib.egcl_xwide_grid.argtypes = [_I] * 5
        lib.egcl_xwide_splits.argtypes = [_I] * 4
        lib.egcl_xwide_threads.argtypes = [_I] * 2
        lib.egcl_xwide_tiles.argtypes = [_I] * 2
        lib.egcl_xwide_max_width.argtypes = []
        lib.egcl_xwide_smem_bytes.argtypes = [_I] * 3
        lib.egcl_xwide_smem_bytes.restype = _LL
        lib.egcl_xwide_smem_limit.argtypes = []
        lib.egcl_xwide_smem_limit.restype = _LL
        _bind_part_size(lib)
        lib.egcl_xwide_error_string.argtypes = [_I]
        lib.egcl_xwide_error_string.restype = ctypes.c_char_p
        lib._enflow_bound = True
    return lib


def _check_inputs(h, pos, box, mask_f, weights):
    dev = h.device
    cdt = h.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"the EGCL kernel computes in float32 or bfloat16, "
                         f"got {cdt}")
    for name, t in (("pos", pos), ("box", box)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    for t in (mask_f, *weights):
        if t.dtype != cdt or t.device != dev:
            raise ValueError("mask and weights must be in the compute dtype "
                             f"{cdt} on {dev}")


def kernel_for(code: int, H: int, direction: str) -> str:
    """The size rule, on the padded width (:func:`padded_width`): which
    kernels a launch goes to, each in every direction. ``"sm90"`` (bf16 at
    64 or 128), ``"f32"`` (float32 there), ``"wide"`` (bf16 at 192 or 256:
    the bf16 block-pair kernels with streamed weights, every N),
    ``"f32_wide"`` (float32 there: the f32 block-pair kernels with
    streamed weights, every N), and past 256 ``"xwide"`` (bf16) or
    ``"f32_xwide"`` (float32): the column-chunked kernels, every N and nf.
    Past ``XWIDE_MAX_H`` it raises, naming ROADMAP B7.5 and the bytes."""
    Hp = padded_width(H)
    if Hp > PADDED_H[-1]:
        if Hp > XWIDE_MAX_H:
            raise ValueError(_too_wide(H))
        return XWIDE_ROUTE[code]
    if Hp in SM90_H:
        return "sm90" if code == 1 else "f32"
    return "wide" if code == 1 else "f32_wide"


def _smem(code: int, N: int, nf: int, H: int, direction: str):
    """(bytes a launch of this kind at the width ``H`` of ``PADDED_H``
    needs, or -1 for sizes its kernel does not take; the card's limit). The
    tiled f32 kernels are asked at their smallest tile, one molecule and 8
    rows; the routes of ``EVERY_N_ROUTES`` have no one-molecule
    kernels."""
    route = kernel_for(code, H, direction)
    if route in EVERY_N_ROUTES:
        raise ValueError(f"egcl_allpairs: H={H} runs the {route} kernels "
                         "at every N (no one-molecule limit)")
    if route == "sm90":
        lib = _sm90_library()
        return (lib.egcl_sm90_smem_bytes(N, nf, H, _KIND[direction]),
                lib.egcl_sm90_smem_limit())
    lib = _f32_library()
    return (lib.egcl_f32_smem_bytes(N, nf, H, 1, 8, _KIND[direction]),
            lib.egcl_f32_smem_limit())


_largest: dict = {}


def largest_molecule(code: int, nf: int, H: int, direction: str):
    """The largest N whose block fits in the card's shared memory for one
    launch kind (``"fwd"``, ``"bwd"``, ``"bwd_params"``) of the kernels
    that take one molecule a block (or warpgroup), at the padded width of
    ``H``; 0 for sizes the kernel does not take. Asked of the library once
    per size."""
    H = padded_width(H) or H
    key = (code, nf, H, direction)
    if key not in _largest:
        n = 0
        while True:
            need, limit = _smem(code, n + 1, nf, H, direction)
            if not 0 <= need <= limit:
                break
            n += 1
        _largest[key] = n
    return _largest[key]


def route_for(N: int, nf: int, H: int, code: int, direction: str,
              largest: int) -> str:
    """The molecule-size rule after :func:`kernel_for` (both on the padded
    width): ``"wide"``, ``"f32_wide"``, ``"xwide"`` and ``"f32_xwide"`` at
    every N; else its kernels while ``N <= largest`` (the most atoms their
    block takes), above that the block-pair kernels of the dtype
    (``"blocks"``, bf16 Hopper; ``"f32_blocks"``, float32; every N). No N
    and no width up to ``XWIDE_MAX_H`` is refused."""
    route = kernel_for(code, H, direction)
    if route in EVERY_N_ROUTES or N <= largest:
        return route
    return "blocks" if route == "sm90" else "f32_blocks"


def block_atoms(N: int, fit: int) -> int:
    """Atoms an atom block of the block-pair kernels: the molecule cut into
    as few blocks of at most ``fit`` atoms as it needs, of equal size
    rounded up to a multiple of 8 (N=147 at fit 48: 4 blocks of 40, the
    last of 27)."""
    per = math.ceil(N / math.ceil(N / fit))
    return min(fit, 8 * math.ceil(per / 8))


def blocks_plan(N: int, direction: str, fits) -> tuple[int, int]:
    """``(atoms a block, warpgroups a block of threads)`` of a block-pair
    launch: the most warpgroups whose blocks of ``BLOCK_ATOMS_MAX`` atoms
    fit (``fits(A, nwg)``), else one warpgroup and the most atoms (a
    multiple of 8) that fit; then :func:`block_atoms`."""
    for nwg in range(BLOCK_WG_MAX[direction], 0, -1):
        fit = next((A for A in range(BLOCK_ATOMS_MAX, 7, -8)
                    if fits(A, nwg)), 0)
        if fit == BLOCK_ATOMS_MAX or (nwg == 1 and fit):
            return block_atoms(N, fit), nwg
    raise ValueError(f"egcl_allpairs {direction}: no atom block fits")


def f32_blocks_plan(N: int, direction: str, fits) -> tuple[int, int]:
    """``(atoms a block, rows a row tile)`` of an f32 block-pair launch:
    the most atoms (a multiple of 8, at most ``F32_BLOCK_ATOMS``) at which
    a row tile of 8 rows fits (``fits(A, R)``), the most rows (at most
    ``F32_ROWS_MAX``) that fit beside them, then :func:`block_atoms` and
    the rows cut by :func:`tile_rows` over a block pair's ``A * A``
    rows."""
    for fit in range(F32_BLOCK_ATOMS[direction], 7, -8):
        rows = next((r for r in range(F32_ROWS_MAX[direction], 7, -8)
                     if fits(fit, r)), 0)
        if rows:
            A = block_atoms(N, fit)
            return A, tile_rows(rows, A * A)
    raise ValueError(f"egcl_allpairs {direction}: no f32 atom block fits")


def f32_wide_plan(N: int, direction: str, fits) -> tuple[int, int]:
    """``(atoms a block, rows a row tile)`` of an f32 block-pair launch
    with streamed weights (route ``"f32_wide"``): the most rows (a multiple
    of 8, at most ``F32_ROWS_MAX``) at which a block of 8 atoms fits
    (``fits(A, R)``), the most atoms (a multiple of 8, at most
    ``F32_BLOCK_ATOMS``) beside them, then :func:`block_atoms` and the rows
    cut by :func:`tile_rows` over a block pair's ``A * A`` rows. Rows come
    first: every row tile streams W2 and W3 through the ring once (and K2
    p reads and writes its dW2 / dW3 slice once), so the L2 bytes a launch
    moves go as its row tiles' count."""
    for rows in range(F32_ROWS_MAX[direction], 7, -8):
        fit = next((a for a in range(F32_BLOCK_ATOMS[direction], 7, -8)
                    if fits(a, rows)), 0)
        if fit:
            A = block_atoms(N, fit)
            return A, tile_rows(rows, A * A)
    raise ValueError(f"egcl_allpairs {direction}: no f32 atom block with "
                     "streamed weights fits")


def _check_fits(code: int, dims, direction: str) -> str:
    """The route of a launch (:func:`route_for`); raises for a width past
    ``XWIDE_MAX_H``."""
    B, N, nf, H = dims
    route = kernel_for(code, H, direction)
    if route in EVERY_N_ROUTES:
        return route
    return route_for(N, nf, H, code, direction,
                     largest_molecule(code, nf, H, direction))


def _parent_plan(code: int, N: int, nf: int, H: int, direction: str):
    """The block-pair plan of the dtype at this nf (at the padded width
    ``H``), or None where no block fits (the block-pair plans raise)."""
    lib = _sm90_library() if code else _f32_library()
    try:
        return (_blocks_launch_plan if code else _f32_blocks_launch_plan)(
            lib, N, nf, H, direction)
    except ValueError:
        return None


def route_of(code: int, dims, direction: str) -> str:
    """The route a launch runs on: :func:`_check_fits`'s, except that a
    block-pair route whose plan finds no block at this nf
    (:func:`_parent_plan`, from the library's byte function) gives way to
    the wide-nf route of the dtype (``WIDE_NF_ROUTE``). Every (dtype, N,
    nf, H <= 256, direction) that a block-pair plan takes keeps its
    route."""
    route = _check_fits(code, dims, direction)
    if route not in BLOCK_ROUTES:
        return route
    B, N, nf, H = dims
    if _parent_plan(code, N, nf, padded_width(H), direction) is None:
        return WIDE_NF_ROUTE[code]
    return route


def _nf_refused(code: int, nf: int, H: int, direction: str, need) -> str:
    """Why a wide-nf launch is refused: no block of 8 atoms of its kernels
    fits at this width (nothing in them grows with nf; H <= 256 always
    fits, so only a changed kernel could bring this)."""
    return (f"egcl_allpairs {direction}: node-feature width nf={nf} at H={H} "
            f"({'bf16' if code else 'float32'}): the wide-nf route's block "
            f"of 8 atoms needs {need:,} bytes of shared memory, more than the "
            f"{SMEM_LIMIT:,} a block may use; not ported ({NF_ITEM})")


def wide_nf_plan(lib, code: int, N: int, nf: int, H: int, direction: str):
    """The plan of a wide-nf launch at the padded width ``H``: bf16 ``(atoms
    a block, warpgroups)`` by :func:`blocks_plan`, float32 ``(atoms a
    block, rows a row tile)`` by :func:`f32_blocks_plan` (at 192 and 256
    :func:`f32_wide_plan`), each against the library's
    ``*_wide_nf_smem_bytes`` (nf-free), once per size; raises naming nf,
    the bytes and ``NF_ITEM`` where no block fits."""
    key = (id(lib), "wide_nf", code, N, H, direction)
    if key not in _plans:
        kind = _KIND[direction]
        if code:
            limit = lib.egcl_sm90_smem_limit()
            fits = lambda A, nwg: 0 <= lib.egcl_sm90_wide_nf_smem_bytes(
                A, H, kind, nwg) <= limit
            plan, least = blocks_plan, lambda: \
                lib.egcl_sm90_wide_nf_smem_bytes(8, H, kind, 1)
        else:
            limit = lib.egcl_f32_smem_limit()
            fits = lambda A, R: 0 <= lib.egcl_f32_wide_nf_smem_bytes(
                A, H, R, kind) <= limit
            plan = f32_wide_plan if H in WIDE_H else f32_blocks_plan
            least = lambda: lib.egcl_f32_wide_nf_smem_bytes(8, H, 8, kind)
        try:
            _plans[key] = plan(N, direction, fits)
        except ValueError:
            raise ValueError(_nf_refused(code, nf, H, direction,
                                         least())) from None
    return _plans[key]


def f32_grid(B: int, N: int, n_sm: int, direction: str):
    """``(molecules a tile, blocks)`` of the tiled f32 kernels: about one
    tile a multiprocessor, several molecules a tile only where a molecule
    has fewer than twice a row tile's rows (at most ``MAX_MOL_TILE``),
    blocks striding over the tiles."""
    E = N * (N - 1)
    cap = max(1, 2 * F32_ROWS_MAX[direction] // E) if E else MAX_MOL_TILE
    mt = max(1, min(math.ceil(B / n_sm), cap, MAX_MOL_TILE))
    return mt, min(math.ceil(B / mt), n_sm)


def tile_rows(fit: int, n: int) -> int:
    """Rows a row tile: a molecule tile's ``n`` rows cut into as few tiles
    of at most ``fit`` rows as they need, of equal size rounded up to a
    multiple of 8 (N=22: 462 rows in 11 tiles of 40 and one of 22)."""
    if n == 0:
        return 8
    per = math.ceil(n / math.ceil(n / fit))
    return min(fit, 8 * math.ceil(per / 8))


def row_tiles(B: int, N: int, mt: int, blocks: int, rows: int):
    """The row tiles of each block in the order the tiled f32 kernels walk
    them: molecule tiles ``b, b + blocks, ...`` of ``mt`` molecules, each
    one's ``nm N (N-1)`` rows cut into tiles of ``rows`` rows and one of the
    rest (a tile without rows, N = 1, is one empty row tile). One list per
    block of ``(first molecule, molecules, first row, rows)``."""
    E = N * (N - 1)
    out = []
    for b in range(blocks):
        tiles = []
        for t in range(b, math.ceil(B / mt), blocks):
            b0 = t * mt
            nm = min(mt, B - b0)
            tiles += [(b0, nm, g, min(rows, nm * E - g))
                      for g in range(0, max(nm * E, 1), rows)]
        out.append(tiles)
    return out


_plans: dict = {}


def _f32_plan(lib, dims, direction, n_sm):
    """``(molecules a tile, rows a row tile, blocks)`` of a tiled f32
    launch: ``f32_grid``'s tile, halved until the block fits with at
    least 8 rows, and the most rows (at most ``F32_ROWS_MAX``) that fit,
    cut by ``tile_rows``; checked against the card's shared memory once
    per library, shape and direction."""
    B, N, nf, H = dims
    key = (id(lib), dims, direction, n_sm)
    if key not in _plans:
        kind, limit = _KIND[direction], lib.egcl_f32_smem_limit()
        mt, _ = f32_grid(B, N, n_sm, direction)
        while True:
            fits = [r for r in range(F32_ROWS_MAX[direction], 7, -8)
                    if 0 <= lib.egcl_f32_smem_bytes(N, nf, H, mt, r, kind)
                    <= limit]
            if fits or mt == 1:
                break
            mt = max(1, mt // 2)
        if not fits:            # _check_fits has refused this size already
            raise ValueError(f"egcl_allpairs {direction}: no f32 tile fits "
                             f"B, N, nf, H = {dims}")
        rows = tile_rows(fits[0], mt * N * (N - 1))
        _plans[key] = (mt, rows, min(math.ceil(B / mt), n_sm))
    return _plans[key]


def _split_part(tot, nf: int, H: int):
    """The summed partials (``PartLayout`` of ``csrc/egcl_part_layout.cuh``:
    dW2, dW3, dW1a, dW1b, dw1r, db1, db2, db3, dw4, then padding) as the
    nine gradients in the weights' order and shapes."""
    HH, nH = H * H, nf * H
    dW2, dW3, dW1a, dW1b, dw1r, db1, db2, db3, dw4 = torch.split(
        tot[:2 * HH + 2 * nH + 5 * H], (HH, HH, nH, nH, H, H, H, H, H))
    return (dW1a.view(nf, H), dW1b.view(nf, H), dw1r.view(1, H),
            db1.view(1, H), dW2.view(H, H), db2.view(1, H), dW3.view(H, H),
            db3.view(1, H), dw4.view(H, 1))


def _raise_on(lib, err: int, what: str, dims, route):
    if err != 0:
        # the library of the route has only its own error string
        text = getattr(lib, {"sm90": "egcl_sm90_error_string",
                             "blocks": "egcl_sm90_error_string",
                             "wide": "egcl_sm90_error_string",
                             "wide_nf": "egcl_sm90_error_string",
                             "f32": "egcl_f32_error_string",
                             "f32_blocks": "egcl_f32_error_string",
                             "f32_wide": "egcl_f32_error_string",
                             "f32_wide_nf": "egcl_f32_error_string",
                             "xwide": "egcl_xwide_error_string",
                             "f32_xwide": "egcl_xwide_error_string"}[route])
        raise RuntimeError(f"egcl_allpairs {what} kernel launch failed: "
                           f"{text(err).decode()} (error {err}; B, N, nf, H "
                           f"= {dims}; route {route})")


def _count(direction: str, H: int, route: str):
    """One launch of the caller's hidden width ``H`` on its route's
    counter: the tiled f32 input-gradient K2's own, each kind of
    block-pair kernels' own; a launch at a padded width also on
    ``padded_launches``."""
    name = {"fwd": "fwd", "bwd": "bwd", "bwd_params": "bwd_param"}[direction]
    if route == "f32" and direction == "bwd":
        name = "bwd_f32"
    if route in (*BLOCK_ROUTES, *WIDE_NF_ROUTE.values(),
                 *XWIDE_ROUTE.values()):
        name += "_" + route
    name += "_launches"
    setattr(counts, name, getattr(counts, name) + 1)
    if padded_width(H) != H:
        counts.padded_launches += 1


def _blocks_launch_plan(lib, N: int, nf: int, H: int, direction: str):
    """:func:`blocks_plan` against the card's shared memory, once per
    size."""
    key = (id(lib), N, nf, H, direction)
    if key not in _plans:
        kind, limit = _KIND[direction], lib.egcl_sm90_smem_limit()
        _plans[key] = blocks_plan(N, direction, lambda A, nwg: 0 <= (
            lib.egcl_sm90_blocks_smem_bytes(A, nf, H, kind, nwg)) <= limit)
    return _plans[key]


def _f32_blocks_launch_plan(lib, N: int, nf: int, H: int, direction: str):
    """:func:`f32_blocks_plan` (at 192 and 256 :func:`f32_wide_plan`)
    against the card's shared memory, once per size."""
    key = (id(lib), "f32_blocks", N, nf, H, direction)
    if key not in _plans:
        kind, limit = _KIND[direction], lib.egcl_f32_smem_limit()
        plan = f32_wide_plan if H in WIDE_H else f32_blocks_plan
        _plans[key] = plan(N, direction, lambda A, R: 0 <= (
            lib.egcl_f32_blocks_smem_bytes(A, nf, H, R, kind)) <= limit)
    return _plans[key]


def _launch(direction: str, h, pos, box, mask_f, weights, dagg=None,
            dfsum=None, route=None):
    """One launch on the route that the size rules name (or on ``route``:
    ``"blocks"`` or ``"wide_nf"``, where the caller asks for the block-pair
    kernels of the dtype, or for them with the first layer's projections
    precomputed, at H <= 256; ``"xwide"`` for the column-chunked kernels of
    the dtype at any width), at the padded width: the weights (and dagg)
    copied into zero-padded buffers first where the width is not the
    padded one, the outputs cut back to it after. The wide-nf route is
    decided by the libraries' byte functions (:func:`route_of`), which a
    CUDA launch has; a CPU tensor here (a test with ``_run`` replaced) gets
    :func:`_check_fits`'s route."""
    _check_inputs(h, pos, box, mask_f, weights)
    H = weights[4].shape[1]
    code = _DTYPE_CODE[h.dtype]
    dims = (*h.shape, H)
    rule = (route_of if h.is_cuda else _check_fits)(code, dims, direction)
    if route in ("blocks", "wide_nf") and rule in XWIDE_ROUTE.values():
        raise ValueError(f"egcl_allpairs: route {route!r} takes H <= "
                         f"{PADDED_H[-1]}, not H={H}")
    if route == "xwide":
        rule = XWIDE_ROUTE[code]
    elif route == "wide_nf":
        rule = WIDE_NF_ROUTE[code]
    elif route is not None:
        if route != "blocks":
            raise ValueError(f"egcl_allpairs: route {route!r} does not take "
                             f"{h.dtype} at H={H}")
        if rule not in ("wide", "f32_wide"):
            rule = "blocks" if code else "f32_blocks"
    Hp = padded_width(H)
    if Hp != H:
        weights = pad_weights(weights, Hp)
        if dagg is not None:
            dagg = pad_rows(dagg.to(h.dtype), Hp)
    out = _run(direction, rule, h, pos, box, mask_f, weights, dagg, dfsum)
    if h.shape[0]:
        _count(direction, H, rule)
    if Hp == H:
        return out
    if direction == "fwd":
        return out[0][..., :H].contiguous(), out[1]
    return out[:2] + (unpad_grads(out[2:], H) if out[2:] else ())


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the kernels read inputs 8 or 16 bytes at a time). A copy is freed
    with its last reference: hold it until its launch is queued."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(direction: str, route: str, h, pos, box, mask_f, weights, dagg,
         dfsum):
    """One launch of the kernels of ``route`` at the weights' width (the
    padded width)."""
    if route in XWIDE_ROUTE.values():
        return _run_xwide(direction, h, pos, box, mask_f, weights, dagg,
                          dfsum)
    if route in WIDE_NF_ROUTE.values():
        return _run_wide_nf(direction, h, pos, box, mask_f, weights, dagg,
                            dfsum)
    B, N, nf = h.shape
    H = weights[4].shape[1]
    cdt = h.dtype
    dims = (B, N, nf, H)
    lib = {"sm90": _sm90_library, "blocks": _sm90_library,
           "wide": _sm90_library, "f32": _f32_library,
           "f32_blocks": _f32_library, "f32_wide": _f32_library}[route]()
    # the f32 block-pair kernels take both routes, at their own widths
    pairs = route in ("f32_blocks", "f32_wide")
    # copies of misaligned inputs (``_aligned``) held until the launch
    ins = [_aligned(t) for t in (h, pos, box, mask_f, *weights)]
    stream = _P(torch.cuda.current_stream(h.device).cuda_stream)
    ptrs = [t.data_ptr() for t in ins]
    # the persistent kernels' grid: at most one block per multiprocessor
    blocks = multiprocessors(h.device)
    if route == "f32" and B:
        mt, rows, blocks = _f32_plan(lib, dims, direction, blocks)
    if route in ("blocks", "wide"):
        A, nwg = _blocks_launch_plan(lib, N, nf, H, direction)
        plan = (A, nwg, blocks)
    if pairs:
        A, rows = _f32_blocks_launch_plan(lib, N, nf, H, direction)
        plan = (A, rows, blocks)
    if direction == "fwd":
        agg = torch.empty((B, N, H), dtype=cdt, device=h.device)
        fsum = torch.empty((B, N, 3), dtype=cdt, device=h.device)
        if B:
            outs = (agg.data_ptr(), fsum.data_ptr(), stream)
            if route == "sm90":
                err = lib.egcl_sm90_fwd(*dims, blocks, *ptrs, *outs)
            elif route in ("blocks", "wide"):
                err = lib.egcl_sm90_blocks_fwd(*dims, *plan, *ptrs, *outs)
            elif pairs:
                err = lib.egcl_f32_blocks_fwd(*dims, *plan, *ptrs, *outs)
            else:
                err = lib.egcl_f32_fwd(*dims, mt, rows, blocks, *ptrs, *outs)
            _raise_on(lib, err, "forward", dims, route)
        return agg, fsum
    dagg = _aligned(dagg.to(cdt).contiguous())
    dfsum = dfsum.to(cdt).contiguous()
    dh = torch.empty((B, N, nf), dtype=cdt, device=h.device)
    dpos = torch.empty((B, N, 3), dtype=torch.float32, device=h.device)
    outs = [dagg.data_ptr(), dfsum.data_ptr(), dh.data_ptr(), dpos.data_ptr()]
    if route in ("blocks", "wide"):
        # the block-pair backward's i-side sums and j-side partials (f32
        # rows of H + 4), every element written by the kernel
        si = torch.empty((B, N, H + 4), dtype=torch.float32, device=h.device)
        pj = torch.empty((B, math.ceil(N / A), N, H + 4),
                         dtype=torch.float32, device=h.device)
        outs += [si.data_ptr(), pj.data_ptr()]
    if pairs:
        # the f32 block-pair backward's i-side sums and j-side partials
        # (rows of nf + 3), every element written by the kernel
        si = torch.empty((B, N, nf + 3), dtype=torch.float32,
                         device=h.device)
        pj = torch.empty((B, math.ceil(N / A), N, nf + 3),
                         dtype=torch.float32, device=h.device)
        outs += [si.data_ptr(), pj.data_ptr()]
    if direction == "bwd":
        if B:
            if route == "sm90":
                err = lib.egcl_sm90_bwd(*dims, blocks, *ptrs, *outs, stream)
            elif route in ("blocks", "wide"):
                err = lib.egcl_sm90_blocks_bwd(*dims, *plan, *ptrs, *outs,
                                               stream)
            elif pairs:
                err = lib.egcl_f32_blocks_bwd(*dims, *plan, *ptrs, *outs,
                                              stream)
            else:
                err = lib.egcl_f32_bwd(*dims, mt, rows, blocks, *ptrs, *outs,
                                       stream)
            _raise_on(lib, err, "backward", dims, route)
        return dh, dpos
    # rows of partials that the kernel fills itself: one per warpgroup (the
    # Hopper kernels; each row ends with its scratch tile) or per block
    P = lib.egcl_part_size(nf, H)
    if route in ("sm90", "blocks", "wide"):
        slices = 0
        if B:
            slices = (lib.egcl_sm90_param_slices(*dims, blocks)
                      if route == "sm90" else
                      lib.egcl_sm90_blocks_param_slices(B, N, A, nwg, blocks))
        part = torch.empty((slices, lib.egcl_sm90_slice_floats(nf, H)),
                           dtype=torch.float32, device=h.device)
    elif pairs:
        part = torch.empty((min(B * math.ceil(N / A), blocks), P),
                           dtype=torch.float32, device=h.device)
    else:
        part = torch.empty((min(B, blocks), P), dtype=torch.float32,
                           device=h.device)
    if B:
        if route == "sm90":
            err = lib.egcl_sm90_bwd_params(*dims, blocks, *ptrs, *outs,
                                           part.data_ptr(), stream)
        elif route in ("blocks", "wide"):
            err = lib.egcl_sm90_blocks_bwd_params(*dims, *plan, *ptrs, *outs,
                                                  part.data_ptr(), stream)
        elif pairs:
            err = lib.egcl_f32_blocks_bwd_params(*dims, *plan, *ptrs, *outs,
                                                 part.data_ptr(), stream)
        else:
            err = lib.egcl_f32_bwd_params(*dims, mt, rows, blocks, *ptrs,
                                          *outs, part.data_ptr(), stream)
        _raise_on(lib, err, "backward (parameter gradients)", dims, route)
    # the slices summed in a fixed order: a second launch gives the same bits
    return (dh, dpos) + _split_part(part[:, :P].sum(dim=0), nf, H)


def _run_wide_nf(direction: str, h, pos, box, mask_f, weights, dagg,
                 dfsum):
    """One launch of the wide-nf route of the dtype at the weights' width
    (one of ``PADDED_H``): the block pairs on the per-atom projections
    (``_run_projected``)."""
    B, N, nf = h.shape
    H = weights[4].shape[1]
    code = _DTYPE_CODE[h.dtype]
    lib = _sm90_library() if code else _f32_library()
    pre = "egcl_sm90" if code else "egcl_f32"
    plan = wide_nf_plan(lib, code, N, nf, H, direction)
    A, nI = plan[0], math.ceil(N / plan[0])
    blocks = multiprocessors(h.device)
    if code:
        rows = lib.egcl_sm90_blocks_param_slices(B, N, A, plan[1], blocks) \
            if B else 0
        part = (rows, lib.egcl_sm90_slice_floats(0, H))
    else:
        part = (min(B * nI, blocks), lib.egcl_part_size(0, H))
    return _run_projected(
        direction, lib, WIDE_NF_ROUTE[code],
        lambda name: getattr(lib, f"{pre}_wide_nf_{name}"),
        (B, N, nf, H, *plan, blocks), nI, [], part,
        h, pos, box, mask_f, weights, dagg, dfsum)


def _run_xwide(direction: str, h, pos, box, mask_f, weights, dagg, dfsum):
    """One launch of the column-chunked kernels of the dtype at the
    weights' width (a multiple of 64): the tile kernel on the per-atom
    projections (``_run_projected``), with its [64, H] activation tiles
    (``egcl_xwide_tiles`` a block: the bf16 K1 / K2's two consumers five
    each, else five) and the forward's row sums in global scratch."""
    B, N, nf = h.shape
    H = weights[4].shape[1]
    code = _DTYPE_CODE[h.dtype]
    lib = _xwide_library()
    blocks = multiprocessors(h.device)
    kind = _KIND[direction]
    grid = lib.egcl_xwide_grid(B, N, H, kind, blocks) if B else 1
    extra = [torch.empty((grid, lib.egcl_xwide_tiles(code, kind), 64, H),
                         dtype=h.dtype, device=h.device)]
    if direction == "fwd":
        extra.append(torch.empty((grid, 8, H + 4), dtype=torch.float32,
                                 device=h.device))
    return _run_projected(
        direction, lib, XWIDE_ROUTE[code],
        lambda name: getattr(lib, f"egcl_xwide_{name}"),
        (code, B, N, nf, H, blocks), math.ceil(N / 8), extra,
        (grid, lib.egcl_part_size(0, H)),
        h, pos, box, mask_f, weights, dagg, dfsum)


def _run_projected(direction: str, lib, route: str, entry, lead, nI: int,
                   extra, part_rows, h, pos, box, mask_f, weights, dagg,
                   dfsum):
    """One launch of a route that takes z1 from the per-atom projections
    [h W1a | h W1b] (``"wide_nf"``, ``"xwide"`` and their f32 routes): the
    library's entry point ``entry(direction)`` runs the projections, the
    edge kernel and, for the backward, the j-side sums, dh and dW1's row
    splits, into scratch allocated here. ``lead``: the entry points'
    leading arguments (the last one the grid's blocks), ``nI`` the j-side
    partials' rows a molecule, ``extra`` the route's own scratch (after
    the projections), ``part_rows`` the shape of K2 p's slices. K2 p's
    dW1a and dW1b are the splits' sum, the other seven gradients the
    slices' (at nf 0)."""
    B, N, nf = h.shape
    H = weights[4].shape[1]
    cdt, dev = h.dtype, h.device
    dims = (B, N, nf, H)
    # the copies of misaligned inputs stay referenced here until the
    # launches are queued: a freed copy's memory could be handed to the
    # scratch below before the kernels read it
    ins = [_aligned(t) for t in (h, pos, box, mask_f, *weights)]
    ptrs = [t.data_ptr() for t in ins]
    stream = _P(torch.cuda.current_stream(dev).cuda_stream)
    proj = torch.empty((B, N, 2 * H), dtype=cdt, device=dev)
    mid = [proj.data_ptr()] + [t.data_ptr() for t in extra]
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    if direction == "fwd":
        agg = torch.empty((B, N, H), dtype=cdt, device=dev)
        fsum = torch.empty((B, N, 3), dtype=cdt, device=dev)
        if B:
            err = entry("fwd")(*lead, *ptrs, *mid, agg.data_ptr(),
                               fsum.data_ptr(), stream)
            _raise_on(lib, err, "forward", dims, route)
        return agg, fsum
    dagg = _aligned(dagg.to(cdt).contiguous())
    dfsum = dfsum.to(cdt).contiguous()
    dh = torch.empty((B, N, nf), dtype=cdt, device=dev)
    dpos, si, sj = f32(B, N, 3), f32(B, N, H + 4), f32(B, N, H)
    pj = f32(B, nI, N, H + 4)
    mid = [dagg.data_ptr(), dfsum.data_ptr(), *mid, dh.data_ptr(),
           dpos.data_ptr(), si.data_ptr(), pj.data_ptr(), sj.data_ptr()]
    if direction == "bwd":
        if B:
            err = entry("bwd")(*lead, *ptrs, *mid, stream)
            _raise_on(lib, err, "backward", dims, route)
        return dh, dpos
    P = lib.egcl_part_size(0, H)
    splits = entry("splits")(B * N, nf, H, lead[-1]) if B else 1
    dw1 = f32(splits, 2, nf, H)
    part = f32(*part_rows)
    if B:
        err = entry("bwd_params")(*lead, splits, *ptrs, *mid, dw1.data_ptr(),
                                  part.data_ptr(), stream)
        _raise_on(lib, err, "backward (parameter gradients)", dims, route)
    else:
        part.zero_()
        dw1.zero_()
    # the slices and the splits each summed in a fixed order: a second
    # launch gives the same bits
    grads = _split_part(part[:, :P].sum(dim=0), 0, H)
    dW1 = dw1.sum(dim=0)
    return (dh, dpos, dW1[0], dW1[1]) + grads[2:]


def allpairs_edges_xwide(direction: str, h, pos, box, mask_f, weights,
                         dagg=None, dfsum=None):
    """One launch of the column-chunked kernels of the dtype (route
    ``"xwide"`` / ``"f32_xwide"``; ``direction`` ``"fwd"``, ``"bwd"`` or
    ``"bwd_params"``) at any width, also at H <= 256 where the route rule
    sends the size to another route: what the two routes cost and how far
    apart their outputs are where both take a width. CUDA tensors only;
    the outputs of :func:`allpairs_edges_fwd` / :func:`allpairs_edges_bwd`."""
    if not h.is_cuda:
        raise ValueError("allpairs_edges_xwide launches the card's kernels "
                         "and takes CUDA tensors only")
    return _launch(direction, h, pos, box, mask_f, weights, dagg, dfsum,
                   route="xwide")


def allpairs_edges_wide_nf(direction: str, h, pos, box, mask_f, weights,
                           dagg=None, dfsum=None):
    """One launch of the wide-nf route of the dtype (the block-pair kernels
    with the first layer's projections precomputed; ``direction``
    ``"fwd"``, ``"bwd"`` or ``"bwd_params"``) at any nf, also where the
    route rule sends the size to another route: what the two routes cost
    and how far apart their outputs are where both take a size. CUDA
    tensors only; the outputs of :func:`allpairs_edges_fwd` /
    :func:`allpairs_edges_bwd`."""
    if not h.is_cuda:
        raise ValueError("allpairs_edges_wide_nf launches the card's kernels "
                         "and takes CUDA tensors only")
    return _launch(direction, h, pos, box, mask_f, weights, dagg, dfsum,
                   route="wide_nf")


def allpairs_edges_blocks(direction: str, h, pos, box, mask_f, weights,
                          dagg=None, dfsum=None):
    """One launch of the block-pair kernels of the dtype (bf16 Hopper or
    f32, with streamed weights at 192 and 256; ``direction`` ``"fwd"``,
    ``"bwd"`` or ``"bwd_params"``) at any N,
    also where the route rule sends the molecule to the one-molecule
    kernels: what the two schedules cost where both take a molecule. CUDA
    tensors only; the outputs of :func:`allpairs_edges_fwd` /
    :func:`allpairs_edges_bwd`."""
    if not h.is_cuda:
        raise ValueError("allpairs_edges_blocks launches the card's kernels "
                         "and takes CUDA tensors only")
    return _launch(direction, h, pos, box, mask_f, weights, dagg, dfsum,
                   route="blocks")


def allpairs_edges_fwd(h, pos, box, mask_f, weights):
    """Forward of the contract: the kernel on the card, the plain version
    on the CPU."""
    if h.is_cuda:
        return _launch("fwd", h, pos, box, mask_f, weights)
    counts.plain_fwd_calls += 1
    return allpairs_edges_plain(h, pos, box, mask_f, weights)


def allpairs_edges_bwd(h, pos, box, mask_f, weights, dagg, dfsum,
                       params=False):
    """Backward: ``(dh [B,N,nf], dpos [B,N,3] f32)``, followed with
    ``params`` by the nine parameter gradients as float32 sums (see
    :func:`allpairs_edges_plain_bwd`)."""
    if h.is_cuda:
        return _launch("bwd_params" if params else "bwd", h, pos, box,
                       mask_f, weights, dagg, dfsum)
    if params:
        counts.plain_bwd_param_calls += 1
    else:
        counts.plain_bwd_calls += 1
    return allpairs_edges_plain_bwd(h, pos, box, mask_f, weights, dagg,
                                    dfsum, params)


class _AllPairsEdges(torch.autograd.Function):
    """Saves only its inputs; the backward recomputes the forward inside the
    backward kernel (as the TPU kernel does)."""

    @staticmethod
    def forward(ctx, h, pos, box, mask_f, *weights):
        ctx.save_for_backward(h, pos, box, mask_f, *weights)
        return allpairs_edges_fwd(h, pos, box, mask_f, weights)

    @staticmethod
    def backward(ctx, dagg, dfsum):
        h, pos, box, mask_f, *weights = ctx.saved_tensors
        if dagg is None:
            dagg = torch.zeros(h.shape[:2] + (weights[4].shape[1],),
                               dtype=h.dtype, device=h.device)
        if dfsum is None:
            dfsum = torch.zeros(pos.shape, dtype=h.dtype, device=h.device)
        need = ctx.needs_input_grad
        params = any(need[4:])
        dh, dpos, *pgrads = allpairs_edges_bwd(h, pos, box, mask_f, weights,
                                               dagg, dfsum, params)
        if params:
            # each float32 sum rounded to its weight's dtype, as
            # _fused_bwd:455-460 does
            pgrads = [g.to(w.dtype) if n else None
                      for g, w, n in zip(pgrads, weights, need[4:])]
        else:
            pgrads = [None] * len(weights)
        return (dh if need[0] else None, dpos if need[1] else None,
                None, None, *pgrads)


def fused_allpairs_edges(params, h, pos, box, atom_mask):
    """Aggregated messages and force sums of one all-pairs EGCL
    (``fused_allpairs_edges_v3``): ``(agg, f_sum, count)``. ``h`` and the
    params are in the compute dtype (float32 or bfloat16)."""
    B, N, nf = h.shape
    W1, b1 = params["edge_nn"][0]["w"], params["edge_nn"][0]["b"]
    W2, b2 = params["edge_nn"][1]["w"], params["edge_nn"][1]["b"]
    W3, b3 = params["coord_nn"][0]["w"], params["coord_nn"][0]["b"]
    w4 = params["coord_nn"][1]["w"]
    W1a, W1b, w1r, b1r = split_params(W1, b1, nf)
    weights = tuple(w.contiguous() for w in
                    (W1a, W1b, w1r, b1r, W2, b2[None, :], W3, b3[None, :],
                     w4))
    mask_f = atom_mask.to(h.dtype)
    agg, fsum = _AllPairsEdges.apply(
        h.contiguous(), pos.to(torch.float32).contiguous(),
        box.to(torch.float32).contiguous(), mask_f.contiguous(), *weights)
    n_real = atom_mask.sum(dim=1, keepdim=True)
    count = torch.where(atom_mask, n_real - 1, 0)[..., None]
    return agg, fsum, count

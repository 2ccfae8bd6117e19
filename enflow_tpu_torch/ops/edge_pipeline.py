"""Gathered-edge EGCL pipeline: the port of ``enflow_tpu/ops/edge_kernel.py``
(K5 forward, K6 backward with parameter gradients).

Contract (``fused_edge_pipeline``): pre-gathered edge rows
``edge_in [A,K,C]`` and displacements ``cd [A,K,3]`` in the compute dtype,
``emask [A,K]`` and the edge/coord MLP weights ``W1 [C,H]``, ``b1``,
``W2 [H,H]``, ``b2``, ``W3 [H,H]``, ``b3``, ``w4 [H,1]`` ->
``(agg [A,H], F_sum [A,3])``::

    m1 = silu(e W1 + b1)   m = silu(m1 W2 + b2) * em   agg = sum_K m
    gate = silu(m W3 + b3) w4   F_sum = sum_K clip(cd * gate, +-100) * em

- On a CUDA tensor the forward launches a forward kernel and the backward
  its backward kernel, which recomputes the forward from the inputs (the
  only residuals the autograd Function saves) and returns ``de``, ``dcd``
  and all seven parameter gradients. float32 and bfloat16 only; other
  dtypes raise. ``kernel_for`` is the size rule, on the padded width
  (``padded_width``: the next of 64, 128, 192 and 256, past 256 the next
  multiple of 64; the weights and dagg are copied into zero-padded buffers
  and the outputs cut back, which is exact: every padded pre-activation is
  0 and silu(0) = 0). bf16 goes to the Hopper kernels of
  ``csrc/edge_pipeline_sm90.cu`` (wgmma, C <= 64 edge features in up to
  four k16 steps of e W1; the tile plan is :func:`sm90_plan` /
  :func:`sm90_tiles`): ``"sm90"`` at 64 and 128 with as many warpgroups a
  block as fit (:func:`sm90_warpgroups`), ``"wide"`` at 192 and 256 with
  one warpgroup and W2 / W3 streamed through a ring of slabs. float32 goes
  to the tiled kernels of ``csrc/edge_pipeline.cu``: ``"tiled"`` at 64 and
  128, ``"f32_wide"`` at 192 and 256 (W2 / W3 streamed). Past 256, and
  where the block of the route of 64 .. 256 does not hold the launch's C
  edge features (its shared memory grows with C; the library says), the
  launch goes to the column-chunked kernels of
  ``csrc/edge_pipeline_xwide.cu`` at the same padded width: ``"xwide"``
  (bf16, wgmma) and ``"f32_xwide"`` (float32, FMA), where H and C enter
  only as loop counts. Only a width past ``XWIDE_MAX_H`` (11,520, where
  one block's slice of the parameter gradients would pass 1 GiB) is
  refused (``XWIDE_ITEM``). There is no fallback to the plain version.
- On a CPU tensor both directions run the plain PyTorch version below,
  which rounds to the compute dtype where ``_fwd_kernel``/``_bwd_kernel``
  round (float64 is accepted there and accumulates in float64).

The parameter gradients are float32 sums (float64 for float64 inputs);
the autograd Function rounds each to its weight's dtype, as
``_edge_bwd_impl`` does on return (``edge_kernel.py:269-273``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import LaunchCounts
from .widths import (PADDED_H, SMEM_LIMIT, XWIDE_ITEM, XWIDE_MAX_H,
                     XWIDE_SLICE_BYTES, pad_rows, padded_width)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ATOM_TILE = 16     # atoms per block tile at most (the wrapper halves
                       # it where a block does not fit: ``_plan``)

# fwd_launches / bwd_launches count every launch; the per-route counters
# say which kernels took it; padded_*: the launches at a padded width
# (each also on its route's counter)
ROUTES = ("sm90", "tiled", "wide", "f32_wide", "xwide", "f32_xwide")
# the column-chunked routes (csrc/edge_pipeline_xwide.cu) by dtype
XWIDE_ROUTE = {torch.float32: "f32_xwide", torch.bfloat16: "xwide"}
counts = LaunchCounts("fwd_launches", "bwd_launches",
                      *(f"{r}_{d}_launches" for r in ROUTES
                        for d in ("fwd", "bwd")),
                      "padded_fwd_launches", "padded_bwd_launches",
                      "plain_fwd_calls", "plain_bwd_calls")


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel contract
# ---------------------------------------------------------------------------

def _acc(dt):
    return torch.float64 if dt == torch.float64 else torch.float32


def _silu(x):
    return x * torch.sigmoid(x)


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _recompute(e, em, W1, b1, W2, b2, W3, b3, w4):
    """The forward's activations (``_fwd_kernel``), accumulated in f32."""
    dt, acc = e.dtype, _acc(e.dtype)
    f = lambda t: t.to(acc)
    emf = f(em.to(dt))[..., None]
    pre1 = f(e) @ f(W1) + f(b1)
    m1 = _silu(pre1).to(dt)
    pre2 = f(m1) @ f(W2) + f(b2)
    m = (_silu(pre2) * emf).to(dt)
    pre3 = f(m) @ f(W3) + f(b3)
    g1 = _silu(pre3).to(dt)
    gate = f(g1) @ f(w4)                                  # [A,K,1]
    return emf, pre1, m1, pre2, m, pre3, g1, gate


def edge_pipeline_plain(e, cd, em, W1, b1, W2, b2, W3, b3, w4):
    """Plain forward: ``(agg [A,H], F_sum [A,3])`` in the compute dtype."""
    dt, acc = e.dtype, _acc(e.dtype)
    emf, _, _, _, m, _, _, gate = _recompute(e, em, W1, b1, W2, b2, W3, b3,
                                             w4)
    tr = (torch.clamp(cd.to(acc) * gate, -100.0, 100.0) * emf).to(dt)
    return m.to(acc).sum(1).to(dt), tr.to(acc).sum(1).to(dt)


def edge_pipeline_plain_bwd(e, cd, em, W1, b1, W2, b2, W3, b3, w4, dagg,
                            dfs):
    """Plain backward (``_bwd_kernel``): ``(de, dcd, dW1, db1, dW2, db2,
    dW3, db3, dw4)``; the parameter gradients as float32 sums (float64 for
    float64 inputs) in the weights' shapes."""
    dt, acc = e.dtype, _acc(e.dtype)
    f = lambda t: t.to(acc)
    emf, pre1, m1, pre2, m, pre3, g1, gate = _recompute(
        e, em, W1, b1, W2, b2, W3, b3, w4)
    cdf = f(cd)
    dtr = f(dfs.to(dt))[:, None, :]
    pre_tr = cdf * gate
    clip = ((pre_tr > -100.0) & (pre_tr < 100.0)).to(acc)
    dtr = dtr * clip * emf
    dgate = (cdf * dtr).sum(-1, keepdim=True)             # [A,K,1]
    dcd = (gate * dtr).to(dt)
    dgate_r = f(dgate.to(dt))
    dg1 = dgate_r @ f(w4).T
    flat = lambda t: t.reshape(-1, t.shape[-1])
    dw4 = flat(f(g1)).T @ flat(dgate_r)
    dpre3 = dg1 * _dsilu(pre3)
    dpre3_r = f(dpre3.to(dt))
    dm_gate = dpre3_r @ f(W3).T
    dW3 = flat(f(m)).T @ flat(dpre3_r)
    db3 = flat(dpre3).sum(0)
    dm = (f(dagg.to(dt))[:, None, :] + dm_gate) * emf
    dpre2 = dm * _dsilu(pre2)
    dpre2_r = f(dpre2.to(dt))
    dm1 = dpre2_r @ f(W2).T
    dW2 = flat(f(m1)).T @ flat(dpre2_r)
    db2 = flat(dpre2).sum(0)
    dpre1 = dm1 * _dsilu(pre1)
    dpre1_r = f(dpre1.to(dt))
    de = (dpre1_r @ f(W1).T).to(dt)
    dW1 = flat(f(e)).T @ flat(dpre1_r)
    db1 = flat(dpre1).sum(0)
    return de, dcd, dW1, db1, dW2, db2, dW3, db3, dw4


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# Widths whose W2 and W3 a block holds whole (routes "sm90" and "tiled"),
# and those whose kernels stream them through a ring of slabs ("wide",
# "f32_wide"); every other width up to 256 runs at the next of them
TILED_H = (64, 128)
WIDE_H = (192, 256)
# rows a tile of the Hopper kernels (wgmma's M) and of the xwide kernels;
# the xwide kernels' e tile and W1 are padded to a multiple of XWIDE_COL
SM90_ROWS = 64
XWIDE_COL = 64
# rows a tile of the tiled kernels at most (kQmaxFwd / kQmaxBwd x 8)
ROWS_MAX = {"fwd": 72, "bwd": 40}


def _library():
    from .build import load
    lib = load("edge_pipeline")
    if not getattr(lib, "_enflow_bound", False):
        bind_library(lib)
    return lib


def _sm90_library():
    from .build import load
    lib = load("edge_pipeline_sm90")
    if not getattr(lib, "_enflow_bound", False):
        # A, K, C, H, apt, tpa, units, blocks, nwg, inputs, outputs, stream
        lib.edge_sm90_fwd.argtypes = [_I] * 9 + [_P] * 13
        lib.edge_sm90_fwd.restype = _I
        lib.edge_sm90_bwd.argtypes = [_I] * 9 + [_P] * 16
        lib.edge_sm90_bwd.restype = _I
        lib.edge_sm90_warpgroups.argtypes = [_I] * 3
        lib.edge_sm90_warpgroups.restype = _I
        lib.edge_sm90_c_max.argtypes = []
        lib.edge_sm90_c_max.restype = _I
        lib.edge_sm90_smem_bytes.argtypes = [_I] * 4
        lib.edge_sm90_smem_bytes.restype = _LL
        lib.edge_sm90_error_string.argtypes = [_I]
        lib.edge_sm90_error_string.restype = ctypes.c_char_p
        lib.edge_sm90_recip_check.argtypes = [_P, _P]
        lib.edge_sm90_recip_check.restype = _I
        lib._enflow_bound = True
    return lib


def sm90_recip_mismatches(device="cuda") -> int:
    """How many of the floats in [1, 2^126) the Hopper kernels' sigmoid
    reciprocal (rcp.approx and one Newton step) rounds otherwise than the
    correctly rounded reciprocal that torch.sigmoid's division gives: 0
    on a sound build (the kernels round as the plain version then)."""
    lib = _sm90_library()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    stream = _P(torch.cuda.current_stream(bad.device).cuda_stream)
    err = lib.edge_sm90_recip_check(bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"edge_sm90_recip_check failed: "
                           f"{lib.edge_sm90_error_string(err).decode()}")
    return int(bad.item())


def bind_library(lib):
    """Set the ctypes signatures of an ``edge_pipeline.cu`` library."""
    # dtype, A, K, C, H, TA, R, blocks, 10 inputs, outputs, stream
    lib.edge_tiled_fwd.argtypes = [_I] * 8 + [_P] * 13
    lib.edge_tiled_fwd.restype = _I
    lib.edge_tiled_bwd.argtypes = [_I] * 8 + [_P] * 16
    lib.edge_tiled_bwd.restype = _I
    lib.edge_tiled_smem_bytes.argtypes = [_I] * 6
    lib.edge_tiled_smem_bytes.restype = _LL
    lib.edge_pipeline_smem_limit.argtypes = []
    lib.edge_pipeline_smem_limit.restype = _LL
    lib.edge_pipeline_error_string.argtypes = [_I]
    lib.edge_pipeline_error_string.restype = ctypes.c_char_p
    lib._enflow_bound = True


def _xwide_library():
    """The column-chunked kernels' library (``csrc/edge_pipeline_xwide.cu``),
    its ctypes signatures set."""
    from .build import load
    lib = load("edge_pipeline_xwide")
    if not getattr(lib, "_enflow_bound", False):
        # code, A, K, C, H, apt, tpa, units, blocks, 10 inputs, scratch,
        # outputs, stream
        lib.edge_xwide_fwd.argtypes = [_I] * 9 + [_P] * 15
        lib.edge_xwide_fwd.restype = _I
        lib.edge_xwide_bwd.argtypes = [_I] * 9 + [_P] * 18
        lib.edge_xwide_bwd.restype = _I
        lib.edge_xwide_grid.argtypes = [_I] * 5
        lib.edge_xwide_grid.restype = _I
        lib.edge_xwide_part_floats.argtypes = [_I] * 2
        lib.edge_xwide_part_floats.restype = _LL
        lib.edge_xwide_smem_bytes.argtypes = [_I] * 4
        lib.edge_xwide_smem_bytes.restype = _LL
        lib.edge_xwide_smem_limit.argtypes = []
        lib.edge_xwide_smem_limit.restype = _LL
        lib.edge_xwide_threads.argtypes = [_I]
        lib.edge_xwide_threads.restype = _I
        lib.edge_xwide_max_width.argtypes = []
        lib.edge_xwide_max_width.restype = _I
        lib.edge_xwide_error_string.argtypes = [_I]
        lib.edge_xwide_error_string.restype = ctypes.c_char_p
        lib._enflow_bound = True
    return lib


def _too_wide(H: int) -> str:
    """Why a width past ``XWIDE_MAX_H`` is refused: one block's slice of
    the parameter gradients (C H + 2 Hp^2 + 4 Hp f32) would pass the 1 GiB
    that the partials may take at every C."""
    Hp = padded_width(H)
    need = 4 * (2 * Hp * Hp + 5 * Hp)
    return (f"edge_pipeline: hidden width H={H} (padded {Hp}) is past the "
            f"widest the xwide kernels take (H <= {XWIDE_MAX_H:,}): one "
            f"block's slice of the parameter gradients would need at least "
            f"{need:,} bytes (at C = 1), more than the "
            f"{XWIDE_SLICE_BYTES:,} bytes the partials may take; not ported "
            f"({XWIDE_ITEM})")


_held: dict = {}


def _holds(route: str, code: int, C: int, Hp: int, direction: str) -> bool:
    """Whether a block of ``route`` (at its width ``Hp`` <= 256) holds C
    edge features, as its library says: the Hopper kernels' k16 steps of e
    and a block of at least one warpgroup, the tiled kernels' block at 1
    atom and 8 rows. Asked once per library, route, dtype, C, Hp and
    direction."""
    bwd = int(direction == "bwd")
    sm90 = route in ("sm90", "wide")
    lib = _sm90_library() if sm90 else _library()
    key = (id(lib), route, code, C, Hp, bwd)
    if key not in _held:
        if sm90:
            _held[key] = (C <= lib.edge_sm90_c_max()
                          and lib.edge_sm90_warpgroups(C, Hp, bwd) >= 1)
        else:
            _held[key] = 0 <= lib.edge_tiled_smem_bytes(
                code, C, Hp, 1, 8, bwd) <= lib.edge_pipeline_smem_limit()
    return _held[key]


def kernel_for(dtype, H: int, C: int | None = None,
               direction: str = "fwd") -> str:
    """The size rule, on the padded width (:func:`padded_width`): "sm90"
    (bfloat16) or "tiled" (float32) at 64 and 128, "wide" (bfloat16) or
    "f32_wide" (float32) at 192 and 256, "xwide" (bfloat16) or "f32_xwide"
    (float32) past 256. With ``C``, the route a launch of C edge features
    in ``direction`` takes: where the block of the route of 64 .. 256 does
    not hold C (:func:`_holds`), the dtype's xwide route at the same
    padded width, so no C is refused. Raises for another dtype, for H < 1
    and past ``XWIDE_MAX_H`` (naming ROADMAP B7.5 and the bytes)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the edge-pipeline kernel computes in float32 or "
                         f"bfloat16, got {dtype}")
    if H < 1:
        raise ValueError(f"edge_pipeline takes a hidden width H >= 1 in "
                         f"float32 and bfloat16, got H={H}")
    Hp = padded_width(H)
    if Hp > XWIDE_MAX_H:
        raise ValueError(_too_wide(H))
    if Hp > PADDED_H[-1]:
        return XWIDE_ROUTE[dtype]
    bf16 = dtype == torch.bfloat16
    if Hp in TILED_H:
        route = "sm90" if bf16 else "tiled"
    else:
        route = "wide" if bf16 else "f32_wide"
    if C is None or _holds(route, _DTYPE_CODE[dtype], C, Hp, direction):
        return route
    return XWIDE_ROUTE[dtype]


def sm90_warpgroups(lib, C: int, H: int, direction: str) -> int:
    """Warpgroups a block of the Hopper kernels at ``C`` edge features (the
    most whose block fits, as the library says); raises, naming C and the
    limit, for a C past the kernels' k16 steps of e, and at H = 192 or 256
    (one warpgroup beside the ring of slabs) for a C whose block does not
    fit, naming the bytes. ``kernel_for`` sends those launches to the
    xwide kernels, so a launch never reaches either refusal."""
    bwd = int(direction == "bwd")
    c_max = lib.edge_sm90_c_max()
    if C > c_max:
        raise ValueError(f"edge_pipeline {direction} (bfloat16, H={H}): the "
                         f"Hopper kernels take C = 2 nf + 1 <= {c_max} edge "
                         f"features, got C={C}")
    nwg = lib.edge_sm90_warpgroups(C, H, bwd)
    if nwg < 1 and H in WIDE_H:
        need = lib.edge_sm90_smem_bytes(C, H, bwd, 1)
        raise ValueError(f"edge_pipeline {direction} (bfloat16, H={H}): "
                         f"C={C} needs {need} bytes of shared memory at one "
                         f"warpgroup a block (its ring of weight slabs and "
                         f"tiles), more than the {SMEM_LIMIT} a block may "
                         f"use (the xwide kernels take it)")
    if nwg < 1:
        raise RuntimeError(f"edge_pipeline {direction} (bfloat16, H={H}): "
                           f"the Hopper library fits no block at C={C} <= "
                           f"{c_max} (internal error)")
    return nwg


def sm90_plan(A: int, K: int, nwg: int, n_sm: int):
    """``(apt, tpa, units, blocks)`` of a Hopper-kernel launch: rows in
    tiles of SM90_ROWS; where K <= SM90_ROWS a tile holds ``apt`` whole
    atoms (8 at K = 8: 64 rows; 5 at K = 12: 60 rows and 4 zero rows) and
    a unit is a tile, else an atom spans ``tpa`` tiles (the last one
    partly filled) and a unit is an atom. Units are dealt to the
    ``blocks x nwg`` warpgroups in turn (``sm90_tiles``), at most one block
    a multiprocessor and no block without a unit."""
    if K <= SM90_ROWS:
        apt, tpa = SM90_ROWS // K, 1
        units = math.ceil(A / apt)
    else:
        apt, tpa, units = 0, math.ceil(K / SM90_ROWS), A
    return apt, tpa, units, min(n_sm, math.ceil(units / nwg))


def sm90_tiles(A: int, K: int, apt: int, tpa: int, units: int, slots: int):
    """The tiles of each warpgroup in the order the Hopper kernels walk
    them: warpgroup ``g`` of ``slots`` takes units ``g, g + slots, ...``
    and each unit's tiles in order, so an atom's K-sum (carried from tile
    to tile where it spans several) has one owner. One list per warpgroup
    of ``(first atom, atoms, first row, rows)``."""
    out = []
    for g in range(slots):
        tiles = []
        for u in range(g, units, slots):
            if apt:
                a0 = u * apt
                na = min(apt, A - a0)
                tiles.append((a0, na, a0 * K, na * K))
            else:
                for t in range(tpa):
                    g0 = t * SM90_ROWS
                    tiles.append((u, 1, u * K + g0, min(SM90_ROWS, K - g0)))
        out.append(tiles)
    return out


def grid(A: int, n_sm: int) -> tuple[int, int]:
    """``(atoms per tile, blocks)``: about one tile per multiprocessor,
    tiles of at most ``MAX_ATOM_TILE`` whole atoms, blocks striding over
    tiles."""
    ta = max(1, min(MAX_ATOM_TILE, math.ceil(A / n_sm)))
    return ta, min(math.ceil(A / ta), n_sm)


def row_tiles(A: int, K: int, ta: int, blocks: int, rows: int):
    """The row tiles of each block in the order the tiled kernels walk
    them: atom tiles ``b, b + blocks, ...`` of ``ta`` atoms, each cut into
    tiles of ``rows`` rows and one of the rest. One list per block of
    ``(first atom, atoms, first row, rows, rows computed)``; the rows
    computed are the rows rounded up to a multiple of 8 (the padding is
    masked)."""
    out = []
    for b in range(blocks):
        tiles = []
        for t in range(b, math.ceil(A / ta), blocks):
            a0 = t * ta
            a1 = min(a0 + ta, A)
            for g in range(a0 * K, a1 * K, rows):
                nr = min(rows, a1 * K - g)
                tiles.append((a0, a1 - a0, g, nr, 8 * math.ceil(nr / 8)))
        out.append(tiles)
    return out


def tile_rows(fit: int, ta: int, K: int) -> int:
    """Rows a tile of the tiled kernels: an atom tile's ``ta K`` rows cut
    into as few tiles of at most ``fit`` rows as they need, of equal size
    rounded up to a multiple of 8 (72 rows: one tile forward, 40 + 32
    backward)."""
    n = ta * K
    per = math.ceil(n / math.ceil(n / fit))
    return min(fit, 8 * math.ceil(per / 8))


_plans: dict = {}


def tiled_plan(ta: int, K: int, direction: str, fits):
    """``(rows a tile, atoms a tile)`` of a tiled-kernel launch at H = 64 or
    128, ``fits(atoms, rows)`` saying whether a block fits: the most rows a
    tile (at most ``ROWS_MAX``) whose block fits at ``ta`` atoms, and
    where none fits at 8 rows, half the atoms (their per-atom sums) until
    one does; None where nothing fits at 1 atom and 8 rows."""
    rows = range(ROWS_MAX[direction], 7, -8)
    t = ta
    while True:
        fit = [r for r in rows if fits(t, r)]
        if fit or t == 1:
            break
        t = max(1, t // 2)
    return (tile_rows(fit[0], t, K), t) if fit else None


def wide_plan(ta: int, K: int, direction: str, fits):
    """``(rows a tile, atoms a tile)`` of a launch at H = 192 or 256 (W2
    and W3 streamed): the rows first, since every row tile streams the
    weights once: the most rows (at most ``ROWS_MAX``) whose block fits at
    1 atom a tile, then the most atoms up to ``ta`` that still fit at those
    rows; None where nothing fits at 1 atom and 8 rows."""
    fit = [r for r in range(ROWS_MAX[direction], 7, -8) if fits(1, r)]
    if not fit:
        return None
    t = next(t for t in range(ta, 0, -1) if fits(t, fit[0]))
    return tile_rows(fit[0], t, K), t


def _plan(lib, code, C, H, K, ta, direction):
    """``(route, rows a tile, atoms a tile)`` of one tiled-kernel launch
    kind (``tiled_plan`` at H = 64 and 128, ``wide_plan`` at 192 and
    256), checked against the card's shared memory once per library,
    dtype, C, H, K, tile and direction; raises, naming C and the bytes,
    where no block fits at 1 atom and 8 rows (``kernel_for`` sends such a
    launch to the xwide kernels)."""
    key = (id(lib), code, C, H, K, ta, direction)
    if key in _plans:
        return _plans[key]
    bwd = int(direction == "bwd")
    limit = lib.edge_pipeline_smem_limit()
    tiled = H in TILED_H
    plan = (tiled_plan if tiled else wide_plan)(
        ta, K, direction, lambda t, r: 0 <= lib.edge_tiled_smem_bytes(
            code, C, H, t, r, bwd) <= limit)
    if plan is None:
        raise ValueError(
            f"edge_pipeline {direction}: C={C}, H={H} needs "
            f"{lib.edge_tiled_smem_bytes(code, C, H, 1, 8, bwd)} bytes "
            f"of shared memory even at 1 atom and 8 rows a tile, more "
            f"than the {limit} a block may use (the xwide kernels take "
            f"it)")
    _plans[key] = ("tiled" if tiled else "f32_wide",) + plan
    return _plans[key]


def pad_weights(weights, Hp: int):
    """The seven weights ``(W1 [C, H], b1, W2 [H, H], b2, W3, b3, w4
    [H, 1])`` zero-padded to hidden width ``Hp``: new contiguous tensors,
    every padded entry 0."""
    W1, b1, W2, b2, W3, b3, w4 = weights
    H = W2.shape[1]
    square = lambda t: torch.nn.functional.pad(t, (0, Hp - H, 0, Hp - H))
    return (pad_rows(W1, Hp), pad_rows(b1, Hp), square(W2), pad_rows(b2, Hp),
            square(W3), pad_rows(b3, Hp),
            torch.nn.functional.pad(w4, (0, 0, 0, Hp - H)))


def unpad_grads(grads, H: int):
    """The seven parameter gradients of a launch at a padded width, in the
    weights' order and shapes, cut back to hidden width ``H``."""
    dW1, db1, dW2, db2, dW3, db3, dw4 = grads
    return (dW1[:, :H], db1[:H], dW2[:H, :H], db2[:H], dW3[:H, :H], db3[:H],
            dw4[:H])


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels copy the
    weights and dagg 16 bytes at a time)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous().clone()


def _check(error_string, direction, err, A, K, C, H):
    """Raise with the CUDA error ``err`` of a launch (0: none)."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"edge_pipeline {direction} kernel launch failed: "
                           f"{msg} (error {err}; A={A}, K={K}, C={C}, "
                           f"H={H})")


def _split_part(part, C, H):
    """The parameter gradients ``(dW1, db1, dW2, db2, dW3, db3, dw4)`` as
    float32 sums of the slices of ``part``, summed in a fixed order (a
    second launch gives the same bits)."""
    sizes = (C * H, H * H, H * H, H, H, H, H)
    dW1, dW2, dW3, dw4, db1, db2, db3 = torch.split(part.sum(dim=0), sizes)
    return (dW1.view(C, H), db1, dW2.view(H, H), db2, dW3.view(H, H), db3,
            dw4.view(H, 1))


def _launch(direction, e, cd, em, weights, dagg=None, dfs=None):
    """One launch on the route that the size rule names for its C edge
    features, at the padded width: the weights (and dagg) copied into
    zero-padded buffers first where ``H`` is not the padded width, the
    outputs cut back after."""
    cdt, dev = e.dtype, e.device
    A, K, C = e.shape
    H = weights[0].shape[1]
    route = kernel_for(cdt, H, C, direction)
    idx = e.get_device()
    for t in (cd, em, *weights):
        if t.dtype is not cdt or t.get_device() != idx:
            raise ValueError("cd, emask and the weights must be in the "
                             f"compute dtype {cdt} on {dev}")
    bwd = direction == "bwd"
    if not (A and K):
        # nothing to launch: the sums over no slot are zeros
        z = lambda *shape: torch.zeros(shape, dtype=cdt, device=dev)
        if not bwd:
            return z(A, H), z(A, 3)
        part = torch.zeros((1, C * H + 2 * H * H + 4 * H),
                           dtype=torch.float32, device=dev)
        return (z(A, K, C), z(A, K, 3)) + _split_part(part, C, H)
    Hp = padded_width(H)
    if Hp != H:
        weights = pad_weights(weights, Hp)
        if bwd:
            dagg = pad_rows(dagg.to(cdt), Hp)
    out = _run(direction, route, e, cd, em, weights, dagg, dfs)
    counter = f"{route}_{direction}_launches"
    setattr(counts, counter, getattr(counts, counter) + 1)
    if bwd:
        counts.bwd_launches += 1
    else:
        counts.fwd_launches += 1
    if Hp == H:
        return out
    setattr(counts, f"padded_{direction}_launches",
            getattr(counts, f"padded_{direction}_launches") + 1)
    if not bwd:
        return out[0][:, :H].contiguous(), out[1]
    return out[:2] + unpad_grads(out[2:], H)


def _run(direction, route, e, cd, em, weights, dagg, dfs):
    """One launch of the kernels of ``route`` at the weights' width (one of
    ``TILED_H + WIDE_H``, or a multiple of 64 on the xwide routes):
    ``(agg, F_sum)`` forward, ``(de, dcd, dW1, db1, dW2, db2, dW3, db3,
    dw4)`` backward."""
    from .build import multiprocessors
    if route in XWIDE_ROUTE.values():
        return _run_xwide(direction, e, cd, em, weights, dagg, dfs)
    cdt, dev = e.dtype, e.device
    A, K, C = e.shape
    H = weights[0].shape[1]
    bwd = direction == "bwd"
    P = C * H + 2 * H * H + 4 * H
    n_sm = multiprocessors(dev)
    if route in ("sm90", "wide"):
        lib = _sm90_library()
        nwg = sm90_warpgroups(lib, C, H, direction)
        apt, tpa, units, blocks = sm90_plan(A, K, nwg, n_sm)
        dims = (A, K, C, H, apt, tpa, units, blocks, nwg)
        slices = blocks * nwg            # one slice of `part` a warpgroup
        kernels = (lib.edge_sm90_fwd, lib.edge_sm90_bwd)
        error_string = lib.edge_sm90_error_string
    else:
        lib = _library()
        code = _DTYPE_CODE[cdt]
        ta, _ = grid(A, n_sm)
        _, rows, ta = _plan(lib, code, C, H, K, ta, direction)
        blocks = min(math.ceil(A / ta), n_sm)
        slices = blocks                  # one slice a block
        dims = (code, A, K, C, H, ta, rows, blocks)
        kernels = (lib.edge_tiled_fwd, lib.edge_tiled_bwd)
        error_string = lib.edge_pipeline_error_string
    # held until the launch is queued (a copy's memory is not reused before)
    ins = [_aligned(t) for t in (e, cd, em, *weights)]
    ptrs = [t.data_ptr() for t in ins]
    stream = _P(torch.cuda.current_stream(dev).cuda_stream)
    if not bwd:
        agg = torch.empty((A, H), dtype=cdt, device=dev)
        fs = torch.empty((A, 3), dtype=cdt, device=dev)
        _check(error_string, direction, kernels[0](
            *dims, *ptrs, agg.data_ptr(), fs.data_ptr(), stream), A, K, C, H)
        return agg, fs
    dagg = _aligned(dagg.to(cdt))
    dfs = dfs.to(cdt).contiguous()
    de = torch.empty((A, K, C), dtype=cdt, device=dev)
    dcd = torch.empty((A, K, 3), dtype=cdt, device=dev)
    # every kernel writes each element of its slices once
    part = torch.empty((slices, P), dtype=torch.float32, device=dev)
    _check(error_string, direction, kernels[1](
        *dims, *ptrs, dagg.data_ptr(), dfs.data_ptr(), de.data_ptr(),
        dcd.data_ptr(), part.data_ptr(), stream), A, K, C, H)
    return (de, dcd) + _split_part(part, C, H)


def _run_xwide(direction, e, cd, em, weights, dagg, dfs):
    """One launch of the column-chunked kernels of the dtype at the
    weights' width (a multiple of 64): tiles of 64 rows on the Hopper
    kernels' plan at one block a work item's owner (``sm90_plan``), W1
    zero-padded to a multiple of ``XWIDE_COL`` rows, the blocks' [64, H]
    tiles (and the backward's f32 tiles and slices) in global scratch."""
    from .build import multiprocessors
    cdt, dev = e.dtype, e.device
    A, K, C = e.shape
    H = weights[0].shape[1]
    bwd = direction == "bwd"
    lib = _xwide_library()
    apt, tpa, units, blocks = sm90_plan(A, K, 1, multiprocessors(dev))
    grid = lib.edge_xwide_grid(units, C, H, int(bwd), blocks)
    Cp = XWIDE_COL * math.ceil(C / XWIDE_COL)
    W1, *rest = weights
    W1p = torch.nn.functional.pad(W1, (0, 0, 0, Cp - C))
    # held until the launch is queued (a copy's memory is not reused before)
    ins = [_aligned(t) for t in (e, cd, em, W1p, *rest)]
    ptrs = [t.data_ptr() for t in ins]
    stream = _P(torch.cuda.current_stream(dev).cuda_stream)
    dims = (_DTYPE_CODE[cdt], A, K, C, H, apt, tpa, units, blocks)
    scr = torch.empty((grid, 4 * SM90_ROWS * H + SM90_ROWS * Cp), dtype=cdt,
                      device=dev)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    if not bwd:
        acc = f32(grid, H + 3)
        agg = torch.empty((A, H), dtype=cdt, device=dev)
        fs = torch.empty((A, 3), dtype=cdt, device=dev)
        _check(lib.edge_xwide_error_string, direction, lib.edge_xwide_fwd(
            *dims, *ptrs, scr.data_ptr(), acc.data_ptr(), agg.data_ptr(),
            fs.data_ptr(), stream), A, K, C, H)
        return agg, fs
    dagg = _aligned(dagg.to(cdt))
    dfs = dfs.to(cdt).contiguous()
    fscr = f32(grid, 3 * SM90_ROWS * H)
    de = torch.empty((A, K, C), dtype=cdt, device=dev)
    dcd = torch.empty((A, K, 3), dtype=cdt, device=dev)
    # each block writes each element of its slice
    part = f32(grid, lib.edge_xwide_part_floats(C, H))
    _check(lib.edge_xwide_error_string, direction, lib.edge_xwide_bwd(
        *dims, *ptrs, dagg.data_ptr(), dfs.data_ptr(), scr.data_ptr(),
        fscr.data_ptr(), de.data_ptr(), dcd.data_ptr(), part.data_ptr(),
        stream), A, K, C, H)
    return (de, dcd) + _split_part(part, C, H)


def edge_pipeline_fwd(e, cd, em, weights):
    """Forward of the contract: the kernel on the card, the plain version
    on the CPU."""
    if e.is_cuda:
        return _launch("fwd", e, cd, em, weights)
    counts.plain_fwd_calls += 1
    return edge_pipeline_plain(e, cd, em, *weights)


def edge_pipeline_bwd(e, cd, em, weights, dagg, dfs):
    """Backward: ``(de, dcd, dW1, db1, dW2, db2, dW3, db3, dw4)``, the
    parameter gradients as float32 sums."""
    if e.is_cuda:
        return _launch("bwd", e, cd, em, weights, dagg, dfs)
    counts.plain_bwd_calls += 1
    return edge_pipeline_plain_bwd(e, cd, em, *weights, dagg, dfs)


class _EdgePipeline(torch.autograd.Function):
    """Saves only its inputs; the backward recomputes the forward inside
    the backward kernel, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, e, cd, em, *weights):
        ctx.save_for_backward(e, cd, em, *weights)
        return edge_pipeline_fwd(e, cd, em, weights)

    @staticmethod
    def backward(ctx, dagg, dfs):
        e, cd, em, *weights = ctx.saved_tensors
        A, H = e.shape[0], weights[0].shape[1]
        if dagg is None:
            dagg = torch.zeros((A, H), dtype=e.dtype, device=e.device)
        if dfs is None:
            dfs = torch.zeros((A, 3), dtype=e.dtype, device=e.device)
        de, dcd, *pgrads = edge_pipeline_bwd(e, cd, em, weights, dagg, dfs)
        need = ctx.needs_input_grad
        # each sum rounded to its weight's dtype
        return ((de if need[0] else None, dcd if need[1] else None, None)
                + tuple(g.to(w.dtype) if need[3 + k] else None
                        for k, (g, w) in enumerate(zip(pgrads, weights))))


def fused_edge_pipeline(edge_in, cd, emask, W1, b1, W2, b2, W3, b3, w4):
    """``(agg [A,H], F_sum [A,3])`` of the gathered edge rows
    (``edge_kernel.fused_edge_pipeline``); ``emask`` is cast to the compute
    dtype, as ``edge_kernel.py:188`` does."""
    dt = edge_in.dtype
    return _EdgePipeline.apply(edge_in, cd, emask.to(dt), W1, b1, W2, b2, W3,
                               b3, w4)

"""Gathered-edge EGCL pipeline: the port of ``enflow_tpu/ops/edge_kernel.py``
(K5 forward, K6 backward with parameter gradients).

Contract (``fused_edge_pipeline``): pre-gathered edge rows
``edge_in [A,K,C]`` and displacements ``cd [A,K,3]`` in the compute dtype,
``emask [A,K]`` and the edge/coord MLP weights ``W1 [C,H]``, ``b1``,
``W2 [H,H]``, ``b2``, ``W3 [H,H]``, ``b3``, ``w4 [H,1]`` ->
``(agg [A,H], F_sum [A,3])``::

    m1 = silu(e W1 + b1)   m = silu(m1 W2 + b2) * em   agg = sum_K m
    gate = silu(m W3 + b3) w4   F_sum = sum_K clip(cd * gate, +-100) * em

- On a CUDA tensor the forward launches ``csrc/edge_pipeline.cu`` and the
  backward launches its backward kernel, which recomputes the forward from
  the inputs (the only residuals the autograd Function saves) and returns
  ``de``, ``dcd`` and all seven parameter gradients. float32 and bfloat16
  only; other dtypes raise. ``kernel_for`` is the size rule: the tiled
  kernels at H = 64 and 128, the chunked kernels at the other widths
  the dtype takes; it raises for the rest. There is no fallback.
- On a CPU tensor both directions run the plain PyTorch version below,
  which rounds to the compute dtype where ``_fwd_kernel``/``_bwd_kernel``
  round (float64 is accepted there and accumulates in float64).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import LaunchCounts

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ATOM_TILE = 16     # atoms per block tile (bounds the per-atom sums)

counts = LaunchCounts("fwd_launches", "bwd_launches", "plain_fwd_calls",
                      "plain_bwd_calls")


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
    dW3, db3, dw4)``; the parameter gradients in each parameter's dtype."""
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
    grads = (dW1, db1, dW2, db2, dW3, db3, dw4)
    params = (W1, b1, W2, b2, W3, b3, w4)
    return (de, dcd) + tuple(g.to(p.dtype) for g, p in zip(grads, params))


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# Widths of the tiled kernels of edge_pipeline.cu (float32 and bfloat16);
# every other width a dtype takes goes to its chunked kernels (the size
# rule of ``kernel_for``).
TILED_H = (64, 128)
# rows a tile of the tiled kernels at most (kQmaxFwd / kQmaxBwd x 8)
ROWS_MAX = {"fwd": 72, "bwd": 40}
_H_MULT = {torch.float32: 4, torch.bfloat16: 16}


def _library():
    from .build import load
    lib = load("edge_pipeline")
    if not getattr(lib, "_enflow_bound", False):
        bind_library(lib)
    return lib


def bind_library(lib):
    """Set the ctypes signatures of an ``edge_pipeline.cu`` library (an
    earlier source may lack the tiled entry points)."""
    # dtype, A, K, C, H, TA, [R,] blocks, 10 inputs, outputs, stream
    lib.edge_pipeline_fwd.argtypes = [_I] * 7 + [_P] * 13
    lib.edge_pipeline_fwd.restype = _I
    lib.edge_pipeline_bwd.argtypes = [_I] * 7 + [_P] * 16
    lib.edge_pipeline_bwd.restype = _I
    lib.edge_pipeline_smem_bytes.argtypes = [_I] * 5
    lib.edge_pipeline_smem_bytes.restype = _LL
    lib.edge_pipeline_smem_limit.argtypes = []
    lib.edge_pipeline_smem_limit.restype = _LL
    lib.edge_pipeline_error_string.argtypes = [_I]
    lib.edge_pipeline_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "edge_tiled_fwd"):
        lib.edge_tiled_fwd.argtypes = [_I] * 8 + [_P] * 13
        lib.edge_tiled_fwd.restype = _I
        lib.edge_tiled_bwd.argtypes = [_I] * 8 + [_P] * 16
        lib.edge_tiled_bwd.restype = _I
        lib.edge_tiled_smem_bytes.argtypes = [_I] * 6
        lib.edge_tiled_smem_bytes.restype = _LL
    lib._enflow_bound = True


def uses_tiled(H: int) -> bool:
    """Whether a launch at hidden width ``H`` goes to the tiled kernels."""
    return H in TILED_H


def kernel_for(dtype, H: int) -> str:
    """The size rule: ``"tiled"`` (H = 64, 128) or ``"chunked"`` (every
    other H that is a multiple of 4 in float32 and of 16 in bfloat16);
    raises for what neither takes."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the edge-pipeline kernel computes in float32 or "
                         f"bfloat16, got {dtype}")
    if uses_tiled(H):
        return "tiled"
    mult = _H_MULT[dtype]
    if H >= mult and H % mult == 0:
        return "chunked"
    raise ValueError(f"edge_pipeline takes H % 16 == 0 in bfloat16 and "
                     f"H % 4 == 0 in float32 (H = 64 and 128 in its tiled "
                     f"kernels), got H={H} in {dtype}")


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


def _plan(lib, code, C, H, K, ta, direction):
    """``(kernel, rows a tile)`` of one launch kind, checked against the
    card's shared memory once per library, dtype, C, H, K, tile and
    direction."""
    tiled = uses_tiled(H)
    key = (id(lib), tiled, code, C, H, K, ta, direction)
    if key in _plans:
        return _plans[key]
    bwd = int(direction == "bwd")
    limit = lib.edge_pipeline_smem_limit()
    if tiled:
        # the most rows a tile whose block fits
        for rows in range(ROWS_MAX[direction], 7, -8):
            need = lib.edge_tiled_smem_bytes(code, C, H, ta, rows, bwd)
            if 0 <= need <= limit:
                break
        else:
            raise ValueError(
                f"edge_pipeline {direction}: C={C}, H={H}, {ta} atoms a tile "
                f"need more than the {limit} bytes of shared memory a block "
                f"may use, even at 8 rows a tile")
        plan = ("tiled", tile_rows(rows, ta, K))
    else:
        need = lib.edge_pipeline_smem_bytes(code, C, H, ta, bwd)
        if need > limit:
            raise ValueError(
                f"edge_pipeline {direction}: C={C}, H={H} needs {need} bytes "
                f"of shared memory, more than the {limit} a block may use")
        plan = ("chunked", 0)
    _plans[key] = plan
    return plan


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels copy the
    weights and dagg 16 bytes at a time)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous().clone()


def _launch(direction, e, cd, em, weights, dagg=None, dfs=None):
    from .build import multiprocessors
    cdt, dev = e.dtype, e.device
    A, K, C = e.shape
    H = weights[0].shape[1]
    kernel_for(cdt, H)
    idx = e.get_device()
    for t in (cd, em, *weights):
        if t.dtype is not cdt or t.get_device() != idx:
            raise ValueError("cd, emask and the weights must be in the "
                             f"compute dtype {cdt} on {dev}")
    code = _DTYPE_CODE[cdt]
    lib = _library()
    ta, blocks = grid(A, multiprocessors(dev))
    route, rows = _plan(lib, code, C, H, K, ta, direction)
    ins = [_aligned(t) for t in (e, cd, em, *weights)]
    stream = _P(torch.cuda.current_stream(dev).cuda_stream)
    if route == "tiled":
        dims = (code, A, K, C, H, ta, rows, blocks)
        fwd, bwd = lib.edge_tiled_fwd, lib.edge_tiled_bwd
    else:
        dims = (code, A, K, C, H, ta, blocks)
        fwd, bwd = lib.edge_pipeline_fwd, lib.edge_pipeline_bwd

    def check(err):
        if err != 0:
            msg = lib.edge_pipeline_error_string(err).decode()
            raise RuntimeError(f"edge_pipeline {direction} kernel launch "
                               f"failed: {msg} (error {err}; A={A}, K={K}, "
                               f"C={C}, H={H})")

    # the kernel writes every output element; K = 0 leaves the zeros
    new = torch.empty if A and K else torch.zeros
    if direction == "fwd":
        agg = new((A, H), dtype=cdt, device=dev)
        fs = new((A, 3), dtype=cdt, device=dev)
        if A and K:
            check(fwd(*dims, *[t.data_ptr() for t in ins], agg.data_ptr(),
                      fs.data_ptr(), stream))
            counts.fwd_launches += 1
        return agg, fs
    dagg = _aligned(dagg.to(cdt))
    dfs = dfs.to(cdt).contiguous()
    de = new(ins[0].shape, dtype=cdt, device=dev)
    dcd = new(ins[1].shape, dtype=cdt, device=dev)
    # one slice of the parameter gradients a block: the tiled kernel
    # writes each once, the chunked one adds into zeros
    sizes = (C * H, H * H, H * H, H, H, H, H)
    part = (new if route == "tiled" else torch.zeros)(
        (blocks, sum(sizes)), dtype=torch.float32, device=dev)
    if A and K:
        check(bwd(*dims, *[t.data_ptr() for t in ins], dagg.data_ptr(),
                  dfs.data_ptr(), de.data_ptr(), dcd.data_ptr(),
                  part.data_ptr(), stream))
        counts.bwd_launches += 1
    # the slices summed in a fixed order: a second launch gives the same bits
    tot = part.sum(dim=0)
    dW1, dW2, dW3, dw4, db1, db2, db3 = torch.split(tot, sizes)
    W1, b1, W2, b2, W3, b3, w4 = weights
    grads = (dW1.view(C, H), db1, dW2.view(H, H), db2, dW3.view(H, H), db3,
             dw4.view(H, 1))
    return (de, dcd) + tuple(g.to(p.dtype) for g, p in
                             zip(grads, (W1, b1, W2, b2, W3, b3, w4)))


def edge_pipeline_fwd(e, cd, em, weights):
    """Forward of the contract: the kernel on the card, the plain version
    on the CPU."""
    if e.is_cuda:
        return _launch("fwd", e, cd, em, weights)
    counts.plain_fwd_calls += 1
    return edge_pipeline_plain(e, cd, em, *weights)


def edge_pipeline_bwd(e, cd, em, weights, dagg, dfs):
    """Backward: ``(de, dcd, dW1, db1, dW2, db2, dW3, db3, dw4)``."""
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
        return ((de if need[0] else None, dcd if need[1] else None, None)
                + tuple(g if need[3 + k] else None
                        for k, g in enumerate(pgrads)))


def fused_edge_pipeline(edge_in, cd, emask, W1, b1, W2, b2, W3, b3, w4):
    """``(agg [A,H], F_sum [A,3])`` of the gathered edge rows
    (``edge_kernel.fused_edge_pipeline``); ``emask`` is cast to the compute
    dtype, as ``edge_kernel.py:188`` does."""
    dt = edge_in.dtype
    return _EdgePipeline.apply(edge_in, cd, emask.to(dt), W1, b1, W2, b2, W3,
                               b3, w4)

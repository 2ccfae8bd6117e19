"""Blockwise LJ pair energy with its analytic gradient: the port of
``enflow_tpu/ops/pairwise_kernel.py`` (K7).

Contract (``pair_energy_and_grad``): ``pos [B,N,3]``, ``mask_f [B,N]``
(0/1), ``box [B,3]`` -> ``(E [B], dE/dpos [B,N,3])`` over ordered pairs,
halved, in one pass:

- form ``"r2"`` (the NLL term): ``4((d2+s)^-6 - (d2+s)^-3)`` on raw
  displacements, no cutoff;
- form ``"r"`` (the MD potential): ``4((s+r)^-12 - (s+r)^-6)`` on min-image
  displacements with ``d2 < cutoff^2``.

Both exclude ``d2 == 0`` pairs (self and coincident atoms) and padded
atoms, as the TPU kernel does (``pairwise_kernel.py:90``). Form ``r``
takes a flag, ``coincident``: with it and a softening > 0, a pair of
distinct real atoms at ``d2 == 0`` inside the cutoff counts at its finite
energy ``4(s^-12 - s^-6)`` with a zero gradient, as the JAX package's
dense MD potential (``enflow_tpu/sim/potentials.py``) counts it. On a CUDA
tensor it launches ``csrc/pair_energy.cu`` (float32 only; other dtypes
raise) on the plan of :func:`pair_plan`; on a CPU tensor it runs the plain
version below, in the tensor's own dtype. ``pair_energy`` wraps it in an
autograd Function that saves the gradient and whose backward is
``ct * g``, with no launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .build import LaunchCounts, multiprocessors

FORMS = {"r2": 0, "r": 1}

counts = LaunchCounts("r2_launches", "r_launches", "plain_calls")

# the kernel's block (rows x column lanes) and its column stage
THREADS = 128
STAGE_COLS = 1024
# molecules up to SMALL_N atoms: whole molecules a block; above, row tiles
# of THREADS / LARGE_LANES atoms and column splits of at least
# MIN_SPLIT_COLS columns, as many as bring the grid to BLOCKS_PER_SM blocks
# an SM; one molecule a block until that would take more than WAVE_PER_SM
# blocks an SM
SMALL_N, LARGE_LANES, MIN_SPLIT_COLS = 32, 4, 128
BLOCKS_PER_SM, WAVE_PER_SM = 8, 16


class PairPlan(NamedTuple):
    """A launch of ``csrc/pair_energy.cu``: ``lanes`` column lanes a row
    (a power of two), ``mols`` molecules a block of ``tile`` rows (atoms)
    each, ``row_tiles`` row tiles a molecule, ``splits`` column splits of
    ``cols`` columns, ``groups`` groups of ``mols`` molecules; the grid is
    ``groups x row_tiles x splits`` blocks, block ``(groups, row tile,
    split)`` in row-major order. Partials: E per block ``[B, row_tiles *
    splits]`` when that is more than 1, the gradient per split ``[B,
    splits, N, 3]`` when ``splits > 1``; a second kernel sums them in
    order."""
    lanes: int
    mols: int
    tile: int
    row_tiles: int
    splits: int
    cols: int
    groups: int

    @property
    def blocks(self) -> int:
        return self.groups * self.row_tiles * self.splits

    @property
    def units(self) -> int:
        """Blocks a molecule's energy is spread over."""
        return self.row_tiles * self.splits


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def pair_plan(B: int, N: int, n_sm: int) -> PairPlan:
    """The kernel's plan for ``B`` molecules of ``N`` atoms on ``n_sm``
    multiprocessors. Up to ``SMALL_N`` atoms a block holds whole molecules:
    the most column lanes a row (at most 32, at most N rounded up to a
    power of two) that leave a row for every atom, then as many molecules
    as the rows take; halving the lanes (doubling the molecules a block)
    while one molecule a block would exceed ``WAVE_PER_SM`` blocks an SM.
    Above, row tiles of ``THREADS / LARGE_LANES`` atoms, and the columns cut
    into as many splits as bring the grid to ``BLOCKS_PER_SM`` blocks an
    SM, each of at least ``MIN_SPLIT_COLS`` columns."""
    if N <= SMALL_N:
        lanes = min(_pow2_floor(THREADS // N), 1 << (N - 1).bit_length(),
                    32)
        mols = lambda ln: (THREADS // ln) // N
        while lanes > 1 and math.ceil(B / mols(lanes)) > WAVE_PER_SM * n_sm:
            lanes //= 2
        return PairPlan(lanes, mols(lanes), N, 1, 1, N,
                        math.ceil(B / mols(lanes)))
    tile = THREADS // LARGE_LANES
    row_tiles = math.ceil(N / tile)
    splits = max(1, min(math.ceil(BLOCKS_PER_SM * n_sm / (B * row_tiles)),
                        N // MIN_SPLIT_COLS))
    cols = math.ceil(N / splits)
    return PairPlan(LARGE_LANES, 1, tile, row_tiles, math.ceil(N / cols),
                    cols, B)


def _pair_terms(d2, softening, form):
    """Pair energy ``e(d2)`` and ``de/dd2`` (``pairwise_kernel.py:49-67``)."""
    if form == "r2":
        a = 1.0 / (d2 + softening)
        a3 = a * a * a
        a6 = a3 * a3
        return 4.0 * (a6 - a3), 4.0 * (-6.0 * a6 * a + 3.0 * a3 * a)
    r = torch.sqrt(d2)
    inv = 1.0 / (softening + r)
    inv3 = inv * inv * inv
    inv6 = inv3 * inv3
    inv12 = inv6 * inv6
    de_dr = 4.0 * (-12.0 * inv12 * inv + 6.0 * inv6 * inv)
    return 4.0 * (inv12 - inv6), de_dr / (2.0 * r)


def pair_energy_plain(pos, mask_f, box, form: str, softening: float,
                      cutoff: float | None = None, coincident: bool = False):
    """Plain version over the dense ``[B, N, N]`` ordered pairs."""
    d = pos[:, :, None, :] - pos[:, None, :, :]
    if form == "r":
        bx = box[:, None, None, :]
        d = d - torch.round(d / bx) * bx
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    real = mask_f[:, :, None] * mask_f[:, None, :] > 0
    valid = real & (d2 > 0)
    if form == "r":
        if coincident and softening > 0:
            N = pos.shape[1]
            other = ~torch.eye(N, dtype=torch.bool, device=pos.device)
            valid = valid | (real & other & (d2 == 0))
        valid = valid & (d2 < cutoff * cutoff)
    one = torch.ones((), dtype=d2.dtype, device=d2.device)
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    e, de = _pair_terms(torch.where(valid, d2, one), softening, form)
    e = torch.where(valid, e, zero)
    de = torch.where(valid & (d2 > 0), de, zero)      # no force at d2 = 0
    return 0.5 * e.sum(dim=(1, 2)), (de[..., None] * 2.0 * d).sum(dim=2)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _library():
    from .build import load
    lib = load("pair_energy")
    if not getattr(lib, "_enflow_bound", False):
        # form, B, N, lg lanes, mols, tile, row_tiles, splits, cols, pos,
        # mask, box, softening, cutoff2, coincident, energy, grad, part_e,
        # part_g, stream
        lib.pair_energy.argtypes = ([_I] * 9 + [_P] * 3 + [_F, _F, _I]
                                    + [_P] * 5)
        lib.pair_energy.restype = _I
        lib.pair_energy_error_string.argtypes = [_I]
        lib.pair_energy_error_string.restype = ctypes.c_char_p
        lib._enflow_bound = True
    return lib


_plans: dict = {}


def _launch(pos, mask_f, box, form, softening, cutoff, coincident):
    dev = pos.device
    for name, t in (("pos", pos), ("mask", mask_f), ("box", box)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"the pair-energy kernel takes float32 tensors "
                             f"on one device; {name} is {t.dtype} on "
                             f"{t.device}")
    B, N, _ = pos.shape
    energy = torch.empty(B, dtype=torch.float32, device=dev)
    grad = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    if not (B and N):
        return energy.zero_(), grad.zero_()
    key = (B, N, dev.index)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = pair_plan(B, N, multiprocessors(dev))
    part_e = part_g = None
    if plan.units > 1:
        part_e = torch.empty(B * plan.units, dtype=torch.float32, device=dev)
    if plan.splits > 1:
        part_g = torch.empty(B * plan.splits * N * 3, dtype=torch.float32,
                             device=dev)
    pos, mask_f, box = (t.contiguous() for t in (pos, mask_f, box))
    err = _library().pair_energy(
        FORMS[form], B, N, plan.lanes.bit_length() - 1, plan.mols,
        plan.tile, plan.row_tiles, plan.splits, plan.cols, pos.data_ptr(),
        mask_f.data_ptr(), box.data_ptr(), softening,
        float(cutoff) ** 2 if form == "r" else 0.0, int(bool(coincident)),
        energy.data_ptr(), grad.data_ptr(),
        None if part_e is None else part_e.data_ptr(),
        None if part_g is None else part_g.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = _library().pair_energy_error_string(err).decode()
        raise RuntimeError(f"pair_energy kernel launch failed: {msg} "
                           f"(error {err}; form {form}, B={B}, N={N}, "
                           f"{plan})")
    if form == "r":
        counts.r_launches += 1
    else:
        counts.r2_launches += 1
    return energy, grad


def pair_energy_and_grad(pos, mask_f, box, form: str, softening: float,
                         cutoff: float | None = None,
                         coincident: bool = False):
    """``(E [B], dE/dpos [B,N,3])``: the kernel on the card, the plain
    version on the CPU. ``coincident`` (form ``r``) counts coincident
    pairs when ``softening > 0`` (see the module docstring)."""
    if form not in FORMS:
        raise ValueError(f"form must be 'r2' or 'r', got {form!r}")
    if form == "r" and cutoff is None:
        raise ValueError("form 'r' needs a cutoff")
    if pos.is_cuda:
        return _launch(pos, mask_f, box, form, softening, cutoff, coincident)
    counts.plain_calls += 1
    return pair_energy_plain(pos, mask_f, box, form, softening, cutoff,
                             coincident)


class _PairEnergy(torch.autograd.Function):
    """Saves the gradient of the one pass; the backward is ``ct * g``
    (``pairwise_kernel.py:156-157``), with ``None`` for mask and box."""

    @staticmethod
    def forward(ctx, pos, mask_f, box, form, softening, cutoff, coincident):
        e, g = pair_energy_and_grad(pos, mask_f, box, form, softening,
                                    cutoff, coincident)
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return ct[:, None, None] * g, None, None, None, None, None, None


def pair_energy(pos, mask, box, form: str, softening: float,
                cutoff: float | None = None, coincident: bool = False):
    """Differentiable ``E [B]`` of ``pos [B,N,3]``; ``mask`` is bool or 0/1
    and ``box`` may be ``None`` (form ``r2`` reads no box)."""
    if box is None:
        box = torch.ones((pos.shape[0], 3), dtype=pos.dtype,
                         device=pos.device)
    return _PairEnergy.apply(pos, mask.to(pos.dtype), box.to(pos.dtype),
                             form, float(softening), cutoff, coincident)

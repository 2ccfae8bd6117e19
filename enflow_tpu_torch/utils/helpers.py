"""Core tensor helpers, the port of ``enflow_tpu/utils/helpers.py``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the
periodic wraps agree with the JAX package at the half-box boundary.
"""

import math

import numpy as np
import torch

from .constants import ELEMENTS

LOG_2PI = math.log(2.0 * math.pi)


def log_gaussian(z: torch.Tensor, mask=None) -> torch.Tensor:
    """Reference-convention standard-normal log density of the whole
    tensor: ``-0.5 * (sum z^2 + log(2 pi))``, ``log(2 pi)`` charged once
    per call (``enflow_tpu/utils/helpers.py:18-37``); ``mask`` selects the
    real entries."""
    sq = z * z
    if mask is not None:
        sq = torch.where(mask, sq, torch.zeros((), dtype=z.dtype,
                                               device=z.device))
    return -0.5 * (sq.sum() + LOG_2PI)


def apply_pbc(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap positions (or displacements) into ``[-box/2, box/2)``;
    ``box`` broadcasts against the last axis of ``pos``."""
    return pos - torch.round(pos / box) * box


def min_image(diff: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement ``diff - round(diff/box)*box`` (full-box
    form, see ``enflow_tpu/utils/helpers.py:min_image``)."""
    return diff - torch.round(diff / box) * box


def log_gaussian_per_mol(z: torch.Tensor, atom_mask: torch.Tensor):
    """Reference-convention standard-normal log density per molecule,
    ``z [B,N,D]`` -> ``[B]``: ``-0.5 * (sum z^2 + log(2 pi))`` over real
    atoms, ``log(2 pi)`` charged once per molecule, not per dimension
    (``enflow_tpu/utils/helpers.py:40-47``)."""
    sq = torch.where(atom_mask[..., None], z * z,
                     torch.zeros((), dtype=z.dtype, device=z.device))
    return -0.5 * (sq.sum(dim=(-1, -2)) + LOG_2PI)


def get_box_len(pos: torch.Tensor) -> torch.Tensor:
    """Integer box length from the position extent ``pos [N, 3]``."""
    return torch.round(pos.max(dim=0).values - pos.min(dim=0).values)


def get_box_len_np(pos) -> np.ndarray:
    """Integer box length from the position extent (host-side numpy)."""
    pos = np.asarray(pos)
    return np.round(pos.max(axis=0) - pos.min(axis=0))


def one_hot(index: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """One-hot encoding; an index outside ``[0, num_classes)`` gives a row
    of zeros, as ``jax.nn.one_hot`` does."""
    index = torch.as_tensor(index)
    classes = torch.arange(num_classes, device=index.device)
    return (index[..., None] == classes).to(dtype)


def unsorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Scatter-sum the rows of ``data`` by ``segment_ids``; ids outside
    ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` drops
    them."""
    ids = torch.as_tensor(segment_ids, device=data.device).to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, ids[keep], data[keep])


def unsorted_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Scatter-mean, each segment's count clamped to at least 1."""
    total = unsorted_segment_sum(data, segment_ids, num_segments)
    count = unsorted_segment_sum(torch.ones_like(data), segment_ids,
                                 num_segments)
    return total / torch.clamp(count, min=1)


def get_element(elem, mass):
    """An element symbol, guessed from the mass when ``elem`` is empty
    (``enflow_tpu/utils/helpers.py:101-114``; host-side)."""
    if elem == '':
        mass_int = int(round(float(mass)))
        if mass_int == 1:
            return 'H'
        if 1 < mass_int < 36:
            return ELEMENTS[mass_int // 2]
        raise ValueError(f"cannot guess element from mass {mass}")
    return elem


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None):
    """Mean of ``x`` over the entries where ``mask`` is True (the count
    clamped to at least 1)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    num = torch.where(mask, x, zero)
    den = mask.to(x.dtype)
    if axis is None:
        return num.sum() / torch.clamp(den.sum(), min=1)
    return num.sum(dim=axis) / torch.clamp(den.sum(dim=axis), min=1)

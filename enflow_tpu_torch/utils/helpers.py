"""Core tensor helpers, the port of ``enflow_tpu/utils/helpers.py``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the
periodic wraps agree with the JAX package at the half-box boundary.
"""

import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


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


def get_box_len_np(pos) -> np.ndarray:
    """Integer box length from the position extent (host-side numpy)."""
    pos = np.asarray(pos)
    return np.round(pos.max(axis=0) - pos.min(axis=0))

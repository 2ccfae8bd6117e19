"""Core tensor helpers, the port of ``enflow_tpu/utils/helpers.py``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the
periodic wraps agree with the JAX package at the half-box boundary.
"""

import torch


def apply_pbc(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap positions (or displacements) into ``[-box/2, box/2)``;
    ``box`` broadcasts against the last axis of ``pos``."""
    return pos - torch.round(pos / box) * box


def min_image(diff: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement ``diff - round(diff/box)*box`` (full-box
    form, see ``enflow_tpu/utils/helpers.py:min_image``)."""
    return diff - torch.round(diff / box) * box

"""Batched molecular state, the port of ``enflow_tpu/data/system.py``.

A frozen dataclass of tensors with padded ``[B, N, ...]`` fields and a
boolean atom mask. Flow steps return new instances (``replace``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.helpers import apply_pbc


@dataclasses.dataclass(frozen=True)
class System:
    """Batched molecular state.

    Attributes:
      h:    ``[B, N, node_nf]`` node features.
      g:    ``[B, N, node_nf]`` auxiliary conjugate features.
      pos:  ``[B, N, 3]`` positions (LJ reduced units).
      vel:  ``[B, N, 3]`` velocities (LJ reduced units).
      mask: ``[B, N]`` bool, True for real atoms.
      box:  ``[B, 3]`` periodic box lengths per molecule.
      r_cut: ``[B]`` neighbor cutoff per molecule.
    """

    h: torch.Tensor
    g: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    mask: torch.Tensor
    box: torch.Tensor
    r_cut: torch.Tensor

    def replace(self, **kwargs) -> "System":
        return dataclasses.replace(self, **kwargs)

    def pbc(self) -> "System":
        """Wrap positions into the primary image; padded atoms untouched."""
        wrapped = apply_pbc(self.pos, self.box[:, None, :])
        return self.replace(
            pos=torch.where(self.mask[..., None], wrapped, self.pos))

    def astype(self, dtype: torch.dtype) -> "System":
        return self.replace(h=self.h.to(dtype), g=self.g.to(dtype),
                            pos=self.pos.to(dtype), vel=self.vel.to(dtype),
                            box=self.box.to(dtype), r_cut=self.r_cut.to(dtype))

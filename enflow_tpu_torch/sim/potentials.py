"""Pairwise potentials, the port of ``lj_energy`` from
``enflow_tpu/sim/potentials.py`` (the MD potentials come with generate,
ROADMAP queue A item 7).
"""

import torch


def lj_energy(pos: torch.Tensor, mask=None, epsilon: float = 1.0,
              sigma: float = 1.0) -> torch.Tensor:
    """Plain LJ cluster energy in reduced units, batched over leading axes:
    ``pos [..., N, 3] -> [...]``."""
    n = pos.shape[-2]
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    valid = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=pos.device), diagonal=1)
    if mask is not None:
        valid = valid & mask[..., :, None] & mask[..., None, :]
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    inv2 = torch.where(valid, (sigma * sigma) / torch.where(valid, d2, one),
                       zero)
    inv6 = inv2 * inv2 * inv2
    e = 4.0 * epsilon * (inv6 * inv6 - inv6)
    return torch.where(valid, e, zero).sum(dim=(-1, -2))
